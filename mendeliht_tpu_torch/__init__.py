"""mendeliht_tpu_torch — the PyTorch/CUDA port of mendeliht_tpu.

Sparse GLM regression for GWAS by iterative hard thresholding on 2-bit
packed genotypes (feature-parity target: OpenMendel/MendelIHT.jl), on one
CUDA device or the CPU.  The JAX package ``mendeliht_tpu`` is the reference
this port is tested against; this package never imports it or jax.

Ported so far: the resident univariate fit of every GLM family and link
(Normal, Bernoulli, Poisson, NegativeBinomial with ``est_r`` "mm" or
"newton", Gamma, InverseGaussian) and its cross-validation, with the JAX
package's options ``init_beta``, ``debias``, ``group`` / ``J`` / a vector
``k``, ``weight``, ``zkeep``, ``io`` and ``use_maf``; the resident
multivariate Gaussian (MvNormal) fit and cross-validation, for a
trait-major y (r, n) with z (q, n), with ``zkeep`` and ``init_beta``; on
packed genotypes, a dense (n, p) matrix (``ops.linalg.DenseOp``: a
numpy matrix goes to the card, a tensor stays on its device) or
``HostStreamedGenotypes``, out of core: packed words in host memory,
streamed through the card on each score pass (``ops/streaming.py``), the
fits and cvs resumable from checkpoints (``checkpoint_dir``,
``utils/checkpoint.py``; the cvs on any genotypes); and the file-level
API, which reads PLINK, VCF and BGEN files

  - ``fit_iht(y, x, z, k=..., d=..., l=...)``   (reference: src/fit.jl:60)
  - ``cv_iht(y, x, z, d=..., path=..., q=...)``  (src/cross_validation.jl:60)
  - ``iht_run_many_models(y, x, z, path=...)``   (:232)
  - ``iht(filename, k, d, ...)``, ``cross_validate(filename, d, ...)``
    (src/wrapper.jl:52, :301), ``parse_genotypes``, ``parse_phenotypes``,
    ``parse_covariates``
  - ``read_plink`` (the ``.bed`` repacked on the card,
    ``PackedGenotypes.from_bed_bytes``), ``write_plink_bed``,
    ``merge_plink``, ``SnpData``, ``naive_impute``, ``grm``, ``standardize``
  - ``simulate_random_snparray``, ``simulate_correlated_snparray``,
    ``make_snparray``, ``make_bim_fam_files``, ``adhoc_add_correlation``,
    ``simulate_random_response``  (src/simulate_utilities.jl:207),
    ``simulate_random_multivariate_response`` (:266),
    ``random_covariance_matrix`` (:319)
  - ``maf``, ``maf_weights``, ``pve``, ``project_k``,
    ``project_group_sparse``, ``allocate_fold_and_k``
  - ``compat``: ``loglikelihood``, ``deviance``, ``score``, ``mle_for_r``,
    ``initialize_beta``, ``cv_iht_distribute_fold``

Everything that builds genotypes or a design matrix takes ``device``,
default the card, and raises where there is none (pass ``device="cpu"``).
On packed genotypes the full-width score X'R runs through hand-written
CUDA kernels when the genotypes live on a CUDA device (``csrc/xt_dots_t.cu``, one kernel body
over the quad words or the transposed dual layout, the JAX kernels'
digit-plane function; the lab's and the round-3 probe's scores are the
same body), and on the CPU through the f32 function
``ops/decode.py::xt_dots``, as the JAX package's operator runs off the
TPU; the kernels' plain versions are in ``ops/decode.py``.  ``utils/profiling``
measures the card's read ceiling through a third kernel
(``csrc/read_probe.cu``) and the score kernels' share of it.  The kernel
lab ``tools/kernel_lab5.py`` sweeps the score kernels across RHS widths
and probes the tensor cores with packed int8 / int4 operands
(``csrc/int_probe.cu``); the round-3 probe ``tools/kernel_probe.py`` adds
the row-major words and the read and decode ceilings
(``csrc/kernel_probe.cu``).
"""

from .genotype.snparray import PackedGenotypes, grm, maf, naive_impute
from .genotype.plink import SnpData, merge_plink, read_plink, write_plink_bed
from .compat import (cv_iht_distribute_fold, deviance, initialize_beta,
                     loglikelihood, mle_for_r, score)
from .models.cv import allocate_fold_and_k, cv_iht, iht_run_many_models
from .models.fit import fit_iht
from .models.pve import pve_from_model as pve
from .models.results import IHTResult, MIHTResult
from .ops.projections import project_group_sparse, project_k
from .ops.streaming import HostStreamedGenotypes
from .utils.simulate import (adhoc_add_correlation, make_bim_fam_files,
                             make_snparray, random_covariance_matrix,
                             simulate_correlated_snparray,
                             simulate_random_multivariate_response,
                             simulate_random_response,
                             simulate_random_snparray)
from .utils.standardize import standardize
from .utils.weights import maf_weights
from .utils.wrapper import (cross_validate, iht, parse_covariates,
                            parse_genotypes, parse_phenotypes)
from .ops.glm import (
    Normal, Bernoulli, Poisson, NegativeBinomial, Gamma, InverseGaussian,
    MvNormal, Binomial,
    IdentityLink, LogitLink, LogLink, InverseLink, SqrtLink, ProbitLink,
    CloglogLink, InverseSquareLink, canonicallink,
)

__version__ = "0.1.0"

# the JAX package's __all__
__all__ = [
    "fit_iht", "cv_iht", "iht_run_many_models", "allocate_fold_and_k",
    "iht", "cross_validate",
    "IHTResult", "MIHTResult",
    "PackedGenotypes", "SnpData", "read_plink", "write_plink_bed",
    "merge_plink", "maf", "grm",
    "Normal", "Bernoulli", "Poisson", "NegativeBinomial", "Gamma",
    "InverseGaussian", "MvNormal", "Binomial",
    "IdentityLink", "LogitLink", "LogLink", "InverseLink", "SqrtLink",
    "ProbitLink", "CloglogLink", "InverseSquareLink", "canonicallink",
    "simulate_random_snparray", "simulate_correlated_snparray",
    "simulate_random_response", "simulate_random_multivariate_response",
    "random_covariance_matrix", "make_bim_fam_files", "adhoc_add_correlation",
    "make_snparray",
    "maf_weights", "pve", "project_k", "project_group_sparse", "standardize",
    "parse_genotypes", "parse_phenotypes", "parse_covariates",
    "naive_impute", "loglikelihood", "deviance", "score", "mle_for_r",
    "initialize_beta", "cv_iht_distribute_fold", "HostStreamedGenotypes",
]
