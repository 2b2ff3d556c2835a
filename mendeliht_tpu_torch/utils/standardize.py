"""Column standardization for covariate matrices
(reference src/utilities.jl:488-530); the JAX package's
``utils/standardize.py``."""

from __future__ import annotations

import numpy as np


def standardize(z: np.ndarray) -> np.ndarray:
    """Standardize each column of `z` to mean 0, variance 1 (sample std, n-1
    divisor), in place semantics of the reference but returning the array.
    Do not pass the intercept column."""
    z = np.asarray(z, np.float64)
    mu = z.mean(axis=0, keepdims=True)
    sd = z.std(axis=0, ddof=1, keepdims=True)
    sd = np.where(sd == 0, 1.0, sd)
    z -= mu
    z /= sd
    return z
