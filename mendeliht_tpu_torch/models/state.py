"""Solver state as plain dataclasses of tensors (the reference's
preallocated IHTVariable, src/data_structures.jl:4-43), with a leading task
axis B (1 for a single fit)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class IHTState:
    """Batched univariate IHT state. Shapes: B tasks, p SNPs, q covariates,
    n_pad padded samples, S support slots."""
    b: torch.Tensor          # (B, p)   current genetic model
    c: torch.Tensor          # (B, q)   current covariate model
    b0: torch.Tensor         # (B, p)   previous iterate
    c0: torch.Tensor         # (B, q)
    best_b: torch.Tensor     # (B, p)   best-loglikelihood iterate
    best_c: torch.Tensor     # (B, q)
    df: torch.Tensor         # (B, p)   score (genetic)
    df2: torch.Tensor        # (B, q)   score (covariates)
    sel_idx: torch.Tensor    # (B, S)   int64 indices into [b; c] of the support
    sel_valid: torch.Tensor  # (B, S)   bool: slot in support
    idc: torch.Tensor        # (B, q)   bool: covariate support
    xb: torch.Tensor         # (B, n_pad) genetic linear predictor
    zc: torch.Tensor         # (B, n_pad) covariate linear predictor
    mu: torch.Tensor         # (B, n_pad) mean
    nb_r: torch.Tensor       # (B,)     negative-binomial nuisance r
    logl: torch.Tensor       # (B,)     loglikelihood of current iterate
    best_logl: torch.Tensor  # (B,)
    k: torch.Tensor          # (B,)     int64 per-task sparsity level
    cv_wts: torch.Tensor     # (B, n_pad) 0/1 sample mask
    active: torch.Tensor     # (B,)     bool: still iterating
    failed: torch.Tensor     # (B,)     bool: non-finite loglikelihood seen
    iters: torch.Tensor      # (B,)     int64 iteration of convergence
    eta: torch.Tensor        # (B,)     last step size (diagnostic)
    backtracks: torch.Tensor  # (B,)    int64 last-step backtrack count
    iteration: int           # global loop counter, kept on the host

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "IHTState":
        """Build from host arrays keyed by field name, e.g. the fields of
        the JAX package's IHTState as numpy (extra keys are ignored).
        Integer fields become int64 and boolean fields stay boolean."""
        return state_from_numpy(cls, arrays, device)


def state_from_numpy(cls, arrays: dict, device):
    """The state dataclass ``cls`` from host arrays keyed by its field
    names (extra keys are ignored): ``iteration`` a host int, integer
    fields int64 tensors, the rest tensors of their own dtype."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        if f.name == "iteration":
            out[f.name] = int(a)
        elif np.issubdtype(a.dtype, np.integer):
            out[f.name] = torch.tensor(a.astype(np.int64), device=device)
        else:
            out[f.name] = torch.tensor(a, device=device)
    return cls(**out)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Solver configuration (the JAX package's, but for its sharded group
    projection's candidate budget and its dtype, which the tensors carry
    here: the operator's and the data's, float32 or float64)."""
    dist: str = "normal"
    link: str = "identity"
    S: int = 16                 # support slot count (>= max k + zkeepn)
    zkeepn: int = 1
    max_iter: int = 200
    min_iter: int = 5
    max_step: int = 3
    tol: float = 1e-4
    est_r: str = "none"         # "none" | "mm" | "newton"
    debias: bool = False
    use_group: bool = False
    J: int = 1                  # groups kept by the group projection
    n_groups: int = 0
    group_k_is_vector: bool = False
    has_weight: bool = False
    log_iters: bool = False     # print a progress line per iteration
    # a file the progress lines also go to (fit_iht's io)
    log_io: object = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class FitData:
    """Per-problem constant data."""
    y: torch.Tensor            # (n_pad,) zero-padded phenotypes
    z: torch.Tensor            # (n_pad, q) zero-padded covariates
    zkeep: torch.Tensor        # (q,) bool
    sample_mask: torch.Tensor  # (n_pad,) 1.0 for true samples
    n_true: int                # true sample count
    # read only where FitConfig says so (has_weight, use_group)
    weight: torch.Tensor | None = None    # (p + q,) selection weights
    group: torch.Tensor | None = None     # (p,) int64 1-based group ids
    group_ks: torch.Tensor | None = None  # (n_groups,) int64 per-group k
