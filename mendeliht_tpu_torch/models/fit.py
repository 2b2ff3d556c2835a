"""Public ``fit_iht`` (reference src/fit.jl:60-127), the resident univariate
fit of every GLM family, with the JAX package's options, on the genotypes'
device."""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from ..ops import glm
from ..ops.linalg import make_operator
from ..ops.streaming import StreamedPackedOp
from .initialize import init_state
from .pve import pve as _pve
from .results import IHTResult
from .state import FitConfig, FitData
from .univariate import finalize_iht, run_segmented, _sparse_extract
from ..utils.device import float_dtype


def is_multivariate(y) -> bool:
    """Reference src/multivariate.jl:481-483."""
    y = np.asarray(y)
    return y.ndim == 2 and y.shape[0] > 1 and y.shape[1] > 1


def check_group(k, group):
    """Reference src/utilities.jl:902-915."""
    if isinstance(k, (list, tuple, np.ndarray)):
        group = np.asarray(group)
        if group.size <= 1:
            raise ValueError("Doubly sparse projection specified (k is a "
                             "vector) but there is no group information.")
        for i, ki in enumerate(np.asarray(k), start=1):
            members = int((group == i).sum())
            if members < ki:
                raise ValueError(f"Maximum predictors for group {i} was {ki} "
                                 f"but the group has only {members} predictors.")
    else:
        if k < 0:
            raise ValueError("Value of k (max predictors per group) must be nonnegative!")


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


def _prepare_univariate(y, x, z, dtype):
    """Operator in ``dtype`` + zero-padded host arrays of the per-sample
    data."""
    op = make_operator(x, dtype)
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


def build_fit(y, x, z=None, *, k=10, J=1, d=None, l=None, group=None,
              weight=None, zkeep=None, est_r="none", debias=False, tol=1e-4,
              max_iter=200, min_iter=5, max_step=3, dtype=torch.float32):
    """Shared setup: returns (op, data, cfg, k_scalar), the operator and the
    data in ``dtype`` (a torch dtype), k_scalar the total
    sparsity (sum of a vector k; J * k with groups).  ``l`` None takes the
    family's canonical link; ``est_r`` ("none", "mm", "newton", any case,
    with or without a leading colon) re-estimates the negative-binomial
    r.  ``group`` (p,) 1-based ids turn on the doubly-sparse projection
    (with ``J`` and a scalar or per-group ``k``); ``weight`` (p or p + q)
    scales the selection magnitudes; ``zkeep`` (q,) bool pins covariates
    (default all)."""
    dist = glm.dist_name(d if d is not None else glm.Normal())
    link = glm.link_name(l) if l is not None else glm._CANONICAL[dist]
    checky(y, dist)
    op, y_pad, z_pad, mask = _prepare_univariate(y, x, z, dtype)
    p, q = op.p, z_pad.shape[1]

    if zkeep is None:
        zkeep_arr = np.ones(q, bool)
    else:
        zkeep_arr = np.asarray(zkeep, bool)
        if zkeep_arr.shape != (q,):
            raise ValueError(f"zkeep must have length {q}")
    zkeepn = int(zkeep_arr.sum())

    use_group = group is not None and np.asarray(group).size > 0
    group_k_is_vector = isinstance(k, (list, tuple, np.ndarray))
    if use_group or group_k_is_vector:
        check_group(k, group if group is not None else np.asarray([]))
    kw = dict(dtype=op.dtype, device=op.device)
    extra = {}
    n_groups = group_cand = 0
    if use_group:
        group_arr = np.asarray(group, np.int64)
        if group_arr.shape != (p,):
            raise ValueError(f"group must have length {p}")
        n_groups = int(group_arr.max())
        if group_k_is_vector:
            gks = np.asarray(k, np.int64)
            k_scalar = int(np.sum(gks))
            group_cand = min(p, int(np.sum(gks)))
        else:
            gks = np.full(n_groups, int(k), np.int64)
            k_scalar = int(J) * int(k)
            group_cand = min(p, n_groups * int(k))
        extra.update(group=torch.as_tensor(group_arr, device=op.device),
                     group_ks=torch.as_tensor(gks, device=op.device))
    else:
        k_scalar = int(k)

    has_weight = weight is not None and np.asarray(weight).size > 0
    if has_weight:
        w = np.asarray(weight, np.float64).reshape(-1)
        if w.shape[0] == p:
            w = np.concatenate([w, np.ones(q)])
        if w.shape[0] != p + q:
            raise ValueError(f"weight must have length {p} or {p + q}")
        extra["weight"] = torch.as_tensor(w, **kw)

    S = max(min(k_scalar + q, p + q), 1)
    data = FitData(
        y=torch.as_tensor(y_pad, **kw), z=torch.as_tensor(z_pad, **kw),
        zkeep=torch.as_tensor(zkeep_arr, device=op.device),
        sample_mask=torch.as_tensor(mask, **kw), n_true=op.n, **extra)
    cfg = FitConfig(dist=dist, link=link, S=int(S), zkeepn=zkeepn,
                    max_iter=int(max_iter), min_iter=int(min_iter),
                    max_step=int(max_step), tol=float(tol),
                    est_r=("none" if est_r in (None, "none", ":None") else
                           str(est_r).lower().strip(":")),
                    debias=bool(debias), use_group=bool(use_group),
                    J=int(J), n_groups=n_groups,
                    group_k_is_vector=group_k_is_vector,
                    group_cand=group_cand,
                    has_weight=bool(has_weight))
    return op, data, cfg, k_scalar


def streamed_segments(op, checkpoint_dir, checkpoint_every, verbose):
    """The checkpoint options of a fit's solve: a streamed fit's
    (``checkpoint_dir`` / ``checkpoint_every``, as the JAX package's
    streamed fit takes them), none for a resident one, which ignores
    them as there."""
    if not isinstance(op, StreamedPackedOp):
        return {}
    return dict(checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, verbose=verbose)


def fit_fused_sparse(op, data: FitData, cfg: FitConfig, ks, cv_wts,
                     init_beta: bool = False, **segments):
    """init + solve + finalize + pve of a batch of fits, and their sparse
    result pieces (``univariate._sparse_extract``); ``segments`` are
    ``univariate.run_segmented``'s checkpoint options."""
    st = init_state(op, data, cfg, ks, cv_wts, init_beta=init_beta)
    st = run_segmented(op, data, cfg, st, **segments)
    st = finalize_iht(op, data, cfg, st)
    sigma_g = _pve(data.y, st.mu, data.sample_mask, data.n_true)
    return _sparse_extract(op, st, sigma_g)


def fit_iht(y, x, z=None, k=10, J=1, d=None, l=None, group=None,
            weight=None, zkeep=None, est_r="none", use_maf=False,
            debias=False, verbose=True, tol=1e-4, max_iter=200, min_iter=5,
            max_step=3, io=None, init_beta=False, memory_efficient=True,
            dtype=torch.float32, checkpoint_dir=None, checkpoint_every=20):
    """Fit one IHT model at sparsity k (reference src/fit.jl:60-118).

    ``x`` is a PackedGenotypes (standardization and mean imputation applied
    on the fly) or a dense (n, p) matrix used as it is (a tensor, on its
    device, or a numpy array, on the card); the fit runs on its device.  y (n,) and z (n, q) or None
    (intercept only) are host arrays.  ``d`` is any family of the JAX
    package (default Normal) and ``l`` any link (default the family's
    canonical one); ``est_r`` ("mm" or "newton") re-estimates the negative
    binomial's r at every step, and raises ValueError for another family.

    The JAX package's options: ``group`` (p,) 1-based group ids with ``J``
    groups kept and ``k`` a per-group cap (or a vector of caps), the
    doubly-sparse projection; ``weight`` (p or p + q) scaling the selection
    magnitudes (e.g. ``maf_weights(x)``); ``zkeep`` (q,) bool, the
    covariates always kept; ``debias``, a refit on the support from the 5th
    iteration on; ``init_beta`` (Gaussian only), the univariate-regression
    warm start; ``io``, a file that the parameter block and the
    per-iteration lines go to, the lines also to stdout (with ``verbose``).
    ``use_maf`` only prints, as in the JAX package: weight scaling comes
    through ``weight``.

    ``x`` may also be a ``HostStreamedGenotypes`` (out of core: its
    words stay in host memory and every score pass streams them,
    ``ops/streaming.py``); such a fit saves its state to
    ``checkpoint_dir`` every ``checkpoint_every`` iterations and resumes
    from the newest one there, as the JAX package's streamed fit does.  A
    resident fit ignores both, as there.  As in the JAX package,
    ``memory_efficient`` is accepted and ignored.  ``dtype`` is float32
    or float64 (``utils.device.float_dtype``): the operator's statistics,
    the data and the solve are in it, and a float64 fit's score on the card
    is the exact float64 digit score of kernels 1 and 2.

    A y of shape (r, n), r > 1, is a multivariate fit
    (``models/mv.py::fit_mv_iht``, as the JAX package routes it): z is
    then (q, n), and ``J``, ``l``, ``group``, ``weight``, ``est_r`` and
    ``use_maf`` are ignored."""
    if is_multivariate(y):
        from .mv import fit_mv_iht
        return fit_mv_iht(y, x, z, k=k, d=d, verbose=verbose, tol=tol,
                          max_iter=max_iter, min_iter=min_iter,
                          max_step=max_step, zkeep=zkeep, io=io,
                          init_beta=init_beta, debias=debias, dtype=dtype,
                          checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every)
    dtype = float_dtype(dtype, "fit_iht")
    d = d if d is not None else glm.Normal()
    if glm.dist_name(d) != "negativebinomial" and cfg_est_r_requested(est_r):
        raise ValueError("Only negative binomial regression supports "
                         "nuisance parameter estimation")
    op, data, cfg, k_scalar = build_fit(
        y, x, z, k=k, J=J, d=d, l=l, group=group, weight=weight, zkeep=zkeep,
        est_r=est_r, debias=debias, tol=tol, max_iter=max_iter,
        min_iter=min_iter, max_step=max_step, dtype=dtype)
    if init_beta and cfg.dist != "normal":
        raise ValueError("Initializing beta values only works for Gaussian "
                         "phenotypes! Sorry!")
    if verbose:
        from ..utils.printing import print_iht_signature, print_parameters
        print_iht_signature(io)
        print_parameters(io, k, cfg.dist, cfg.link, use_maf, group, debias,
                         tol, max_iter, min_iter, op.device)
        # the per-iteration lines go to stdout, and to io when given
        cfg = dataclasses.replace(cfg, log_iters=True, log_io=io)

    t0 = _time.time()
    # the per-task k is the reference's v.k: the per-group cap with a
    # scalar k and groups, the total sparsity otherwise (utilities.jl:255)
    if cfg.group_k_is_vector:
        k_task = 0
    elif cfg.use_group:
        k_task = int(k)
    else:
        k_task = k_scalar
    parts = fit_fused_sparse(op, data, cfg, [k_task],
                             data.sample_mask[None, :], init_beta=init_beta,
                             **streamed_segments(op, checkpoint_dir,
                                                 checkpoint_every, verbose))
    # one host fetch, sparse: ~S floats instead of the dense (p,) beta
    (sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg) = (
        t[0].cpu().numpy() for t in parts)
    b = np.zeros(op.p, sel_bc.dtype)
    is_g = sel_valid & (sel_idx < op.p)
    b[sel_idx[is_g]] = sel_bc[is_g]
    tot_time = _time.time() - t0

    if bool(failed):
        raise FloatingPointError("Loglikelihood function is NaN/Inf, aborting...")
    result = IHTResult(
        time=tot_time, logl=float(logl), iter=int(iters), beta=b, c=c, J=J,
        k=(list(np.asarray(k)) if cfg.group_k_is_vector else int(k)),
        group=(np.asarray(group) if group is not None else np.array([], int)),
        d=d, sigma_g=float(sg))
    if verbose:
        print(result)
    return result

