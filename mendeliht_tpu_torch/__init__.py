"""mendeliht_tpu_torch — the PyTorch/CUDA port of mendeliht_tpu.

Sparse GLM regression for GWAS by iterative hard thresholding on 2-bit
packed genotypes (feature-parity target: OpenMendel/MendelIHT.jl), on one
CUDA device or the CPU.  The JAX package ``mendeliht_tpu`` is the reference
this port is tested against; this package never imports it or jax.

Ported so far: the resident univariate Gaussian fit and its
cross-validation

  - ``fit_iht(y, x: PackedGenotypes, z, k=...)``   (reference: src/fit.jl:60)
  - ``cv_iht(y, x, z, path=..., q=...)``  (src/cross_validation.jl:60)
  - ``iht_run_many_models(y, x, z, path=...)``   (:232)

whose full-width score X'R runs through hand-written CUDA kernels when the
genotypes live on a CUDA device (``csrc/xt_dots.cu`` over the quad words,
``csrc/xt_dots_t.cu`` over the transposed dual layout), and through their
plain PyTorch versions (``ops/decode.py``) on the CPU.  ``utils/profiling``
measures the card's read ceiling through a third kernel
(``csrc/read_probe.cu``) and the score kernels' share of it.
"""

from .genotype.snparray import PackedGenotypes
from .models.cv import cv_iht, iht_run_many_models
from .models.fit import fit_iht
from .models.results import IHTResult
from .ops.glm import IdentityLink, Normal

__version__ = "0.1.0"

__all__ = ["fit_iht", "cv_iht", "iht_run_many_models", "PackedGenotypes",
           "Normal", "IdentityLink", "IHTResult"]
