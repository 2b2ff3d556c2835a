"""mendeliht_tpu_torch — the PyTorch/CUDA port of mendeliht_tpu.

Sparse GLM regression for GWAS by iterative hard thresholding on 2-bit
packed genotypes (feature-parity target: OpenMendel/MendelIHT.jl), on one
CUDA device or the CPU.  The JAX package ``mendeliht_tpu`` is the reference
this port is tested against; this package never imports it or jax.

Ported so far: the resident univariate Gaussian fit

  - ``fit_iht(y, x: PackedGenotypes, z, k=...)``   (reference: src/fit.jl:60)

whose full-width score X'R runs through a hand-written CUDA kernel
(``csrc/xt_dots.cu``) when the genotypes live on a CUDA device, and through
its plain PyTorch version (``ops/decode.py``) on the CPU.
"""

from .genotype.snparray import PackedGenotypes
from .models.fit import fit_iht
from .models.results import IHTResult
from .ops.glm import IdentityLink, Normal

__version__ = "0.1.0"

__all__ = ["fit_iht", "PackedGenotypes", "Normal", "IdentityLink", "IHTResult"]
