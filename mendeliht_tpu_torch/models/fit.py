"""Public ``fit_iht`` (reference src/fit.jl:60-127), the resident univariate
fit of every GLM family on the genotypes' device."""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from ..ops import glm
from ..ops.linalg import make_operator
from .initialize import init_state
from .pve import pve as _pve
from .results import IHTResult
from .state import FitConfig, FitData
from .univariate import finalize_iht, run_segment, _sparse_extract

# arguments of the JAX package's fit_iht that the port does not take yet:
# name -> (values that mean "not used", ROADMAP item that ports it)
_NOT_PORTED = {
    "J": ((1,), "Queue 1 item 9 (group projections)"),
    "group": ((None,), "Queue 1 item 9 (group projections)"),
    "weight": ((None,), "Queue 1 item 9 (weights)"),
    "zkeep": ((None,), "Queue 1 item 9 (zkeep)"),
    "use_maf": ((False,), "Queue 1 item 9 (weights)"),
    "debias": ((False,), "Queue 1 item 9 (debias)"),
    "init_beta": ((False,), "Queue 1 item 9 (init_beta)"),
    "io": ((None,), "Queue 1 item 9 (teed progress lines)"),
}


def check_dtype(fn: str, dtype):
    """Accept the float32 ``dtype`` the JAX package defaults to (as
    ``torch.float32``, ``np.float32``, ``jnp.float32`` or "float32"); any
    other raises NotImplementedError, since float64 fits are not ported."""
    if dtype is torch.float32:
        return
    try:
        if np.dtype(dtype) == np.float32:
            return
    except TypeError:
        pass
    raise NotImplementedError(f"{fn}(dtype={dtype!r}) is not ported yet: "
                              "ROADMAP Queue 1 item 2 (float64 fits)")


def check_not_ported(fn: str, kwargs: dict, table: dict):
    """Raise TypeError for an argument ``fn`` does not know, and
    NotImplementedError for one of ``table`` (name -> (values that mean
    "not used", ROADMAP item)) given a value that would use it."""
    for name, value in kwargs.items():
        if name not in table:
            raise TypeError(f"{fn}() got an unexpected keyword argument "
                            f"{name!r}")
        unused, item = table[name]
        if not any(value is u or (type(value) is type(u) and value == u)
                   for u in unused):
            raise NotImplementedError(
                f"{fn}({name}=...) is not ported yet: ROADMAP {item}")


def checky(y, dist: str):
    """Response-range validation (the reference imports GLM.checky)."""
    y = np.asarray(y)
    if dist == "bernoulli" and not np.all((y == 0) | (y == 1)):
        raise ValueError("Bernoulli responses must be 0 or 1")
    if dist in ("poisson", "negativebinomial") and np.any(y < 0):
        raise ValueError(f"{dist} responses must be nonnegative")
    if dist in ("gamma", "inversegaussian") and np.any(y <= 0):
        raise ValueError(f"{dist} responses must be positive")


def cfg_est_r_requested(est_r) -> bool:
    return est_r not in (None, "none", ":None", "None")


def _prepare_univariate(y, x, z):
    """Operator + zero-padded host arrays of the per-sample data."""
    op = make_operator(x)
    n, n_pad = op.n, op.n_pad
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if len(y) != n:
        raise ValueError(f"length(y)={len(y)} but x has {n} samples")
    if z is None:
        z = np.ones((n, 1))
    z = np.asarray(z, dtype=np.float64)
    if z.ndim == 1:
        z = z[:, None]
    if z.shape[0] != n:
        raise ValueError(f"z has {z.shape[0]} rows but x has {n} samples")
    y_pad = np.zeros(n_pad)
    y_pad[:n] = y
    z_pad = np.zeros((n_pad, z.shape[1]))
    z_pad[:n] = z
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    return op, y_pad, z_pad, mask


def build_fit(y, x, z=None, *, k=10, d=None, l=None, est_r="none",
              tol=1e-4, max_iter=200, min_iter=5, max_step=3):
    """Shared setup: returns (op, data, cfg, k).  ``l`` None takes the
    family's canonical link; ``est_r`` ("none", "mm", "newton", any case,
    with or without a leading colon) re-estimates the negative-binomial
    r."""
    dist = glm.dist_name(d if d is not None else glm.Normal())
    link = glm.link_name(l) if l is not None else glm._CANONICAL[dist]
    checky(y, dist)
    op, y_pad, z_pad, mask = _prepare_univariate(y, x, z)
    p, q = op.p, z_pad.shape[1]
    k = int(k)
    zkeepn = q                           # every covariate is kept
    S = max(min(k + q, p + q), 1)
    kw = dict(dtype=op.dtype, device=op.device)
    data = FitData(
        y=torch.as_tensor(y_pad, **kw), z=torch.as_tensor(z_pad, **kw),
        zkeep=torch.ones(q, dtype=torch.bool, device=op.device),
        sample_mask=torch.as_tensor(mask, **kw), n_true=op.n)
    cfg = FitConfig(dist=dist, link=link, S=int(S), zkeepn=zkeepn,
                    max_iter=int(max_iter), min_iter=int(min_iter),
                    max_step=int(max_step), tol=float(tol),
                    est_r=("none" if est_r in (None, "none", ":None") else
                           str(est_r).lower().strip(":")))
    return op, data, cfg, k


def fit_iht(y, x, z=None, k=10, d=None, l=None, est_r="none", verbose=True,
            tol=1e-4, max_iter=200, min_iter=5, max_step=3,
            memory_efficient=True, dtype=torch.float32, checkpoint_dir=None,
            checkpoint_every=20, **not_ported):
    """Fit one IHT model at sparsity k (reference src/fit.jl:60-118).

    ``x`` is a PackedGenotypes (standardization and mean imputation applied
    on the fly); the fit runs on its device.  y (n,) and z (n, q) or None
    (intercept only) are host arrays.  ``d`` is any family of the JAX
    package (default Normal) and ``l`` any link (default the family's
    canonical one); ``est_r`` ("mm" or "newton") re-estimates the negative
    binomial's r at every step, and raises ValueError for another family.
    The JAX package's other arguments raise NotImplementedError naming the
    ROADMAP item that ports them.

    As in the JAX package, ``memory_efficient`` is accepted and ignored,
    and so are ``checkpoint_dir`` / ``checkpoint_every``, which only its
    streamed fits use (every fit here is resident); ``dtype`` must be
    float32 (:func:`check_dtype`)."""
    check_not_ported("fit_iht", not_ported, _NOT_PORTED)
    check_dtype("fit_iht", dtype)
    d = d if d is not None else glm.Normal()
    if glm.dist_name(d) != "negativebinomial" and cfg_est_r_requested(est_r):
        raise ValueError("Only negative binomial regression supports "
                         "nuisance parameter estimation")
    op, data, cfg, k = build_fit(y, x, z, k=k, d=d, l=l, est_r=est_r,
                                 tol=tol, max_iter=max_iter,
                                 min_iter=min_iter, max_step=max_step)
    if verbose:
        from ..utils.printing import print_iht_signature, print_parameters
        print_iht_signature()
        print_parameters(None, k, cfg.dist, cfg.link, tol, max_iter,
                         min_iter, op.device)
        cfg = dataclasses.replace(cfg, log_iters=True)

    t0 = _time.time()
    cv_wts = data.sample_mask[None, :]
    st = init_state(op, data, cfg, [k], cv_wts)
    st = run_segment(op, data, cfg, st, cfg.max_iter - 1)
    st = finalize_iht(op, data, cfg, st)
    sigma_g = _pve(data.y, st.mu, data.sample_mask, data.n_true)
    # one host fetch, sparse: ~S floats instead of the dense (p,) beta
    (sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg) = (
        t[0].cpu().numpy() for t in _sparse_extract(st, sigma_g))
    b = np.zeros(op.p, sel_bc.dtype)
    is_g = sel_valid & (sel_idx < op.p)
    b[sel_idx[is_g]] = sel_bc[is_g]
    tot_time = _time.time() - t0

    if bool(failed):
        raise FloatingPointError("Loglikelihood function is NaN/Inf, aborting...")
    result = IHTResult(time=tot_time, logl=float(logl), iter=int(iters),
                       beta=b, c=c, J=1, k=k, group=np.array([], int), d=d,
                       sigma_g=float(sg))
    if verbose:
        print(result)
    return result
