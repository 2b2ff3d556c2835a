"""Prior-weight helpers (reference src/utilities.jl:681-697), a numpy copy
of the JAX package's ``utils/weights.py``."""

from __future__ import annotations

import numpy as np

from ..genotype.snparray import PackedGenotypes, maf as _maf


def maf_weights(x: PackedGenotypes, max_weight: float = np.inf) -> np.ndarray:
    """w[i] = 1 / (2 sqrt(p_i (1 - p_i))) clamped to [1, max_weight]
    (reference src/utilities.jl:692-697), p the minor allele frequencies."""
    p = _maf(x).astype(np.float64)
    with np.errstate(divide="ignore"):
        w = 1.0 / (2.0 * np.sqrt(p * (1.0 - p)))
    return np.clip(w, 1.0, max_weight)
