"""User-facing functional counterparts of the reference's exported
internals (reference src/MendelIHT.jl:27-36 export list; the JAX package's
``compat.py``): ``loglikelihood``, ``deviance``, ``score`` and
``mle_for_r`` as functions of (distribution, y, mu) on host arrays or
tensors, ``initialize_beta``, and the legacy ``cv_iht_distribute_fold``.

``loglikelihood``, ``deviance``, ``score`` and ``mle_for_r`` run in
float32, as the JAX package's without 64-bit mode, but where ``mu`` is a
float64 tensor; ``initialize_beta`` and ``cv_iht_distribute_fold`` take a
``dtype``, float32 or float64, as ``fit_iht`` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ops import glm
from .ops.negbin import mle_for_r as _mle_for_r
from .utils.device import float_dtype


def _dtype(mu):
    return (torch.float64 if isinstance(mu, torch.Tensor)
            and mu.dtype == torch.float64 else torch.float32)


def _as(a, dtype):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(dtype)


def _nb_r(d, dtype):
    """The negative binomial's r as a tensor, else None."""
    r = getattr(d, "r", None)
    return None if r is None else torch.tensor(float(r), dtype=dtype)


def _prep(d, y, mu, wts):
    dtype = _dtype(mu)
    y, mu = _as(y, dtype).reshape(-1), _as(mu, dtype).reshape(-1)
    w = torch.ones_like(y) if wts is None else _as(wts, dtype)
    return glm.dist_name(d), y, mu, w, _nb_r(d, dtype)


def loglikelihood(d, y, mu, wts=None) -> float:
    """Total loglikelihood of ``y`` under mean ``mu`` for distribution
    ``d`` (reference src/utilities.jl:9-20; dispersion = deviance/n as
    there)."""
    dist, y, mu, w, nb_r = _prep(d, y, mu, wts)
    return float(glm.loglikelihood(dist, y, mu, w, y.shape[0], nb_r=nb_r))


def deviance(d, y, mu, wts=None) -> float:
    """Sum of squared deviance residuals (reference
    src/utilities.jl:52-61)."""
    dist, y, mu, w, nb_r = _prep(d, y, mu, wts)
    return float(glm.deviance(dist, y, mu, w, nb_r=nb_r))


def score(d, l, y, mu, eta, wts=None) -> torch.Tensor:
    """Weighted working residual ``W(y - mu)``, whose X-projection is the
    IHT gradient (reference score!, src/utilities.jl:126-135)."""
    dtype = _dtype(mu)
    y = _as(y, dtype)
    w = torch.ones_like(y) if wts is None else _as(wts, dtype)
    return glm.score_residual(glm.dist_name(d), glm.link_name(l), y,
                              _as(mu, dtype), _as(eta, dtype), w,
                              nb_r=_nb_r(d, dtype))


def mle_for_r(y, mu, r=1.0, est_r="Newton") -> float:
    """Maximum-likelihood update of the negative-binomial nuisance ``r``
    (reference src/utilities.jl:141-247; ``:MM`` update_r_MM :158-173,
    ``:Newton`` update_r_newton :180-247)."""
    y = _as(y, torch.float32).reshape(-1)
    mu = _as(mu, torch.float32).reshape(1, -1)
    mask = torch.ones_like(y)
    r0 = torch.full((1,), float(r), dtype=torch.float32)
    method = str(est_r).lower().strip(":")
    return float(_mle_for_r(method, y, mu, r0, mask, mask[None, :],
                            y.shape[0])[0])


def initialize_beta(y, x, z=None, dtype=torch.float32):
    """Marginal univariate-regression warm start: per SNP j, y regressed on
    [1, x_j]; returns (b (p,), c (q,)) as numpy (reference
    initialize_beta!, src/utilities.jl:776-812)."""
    from .models.fit import build_fit
    from .models.initialize import _initialize_beta

    dtype = float_dtype(dtype, "initialize_beta")
    op, data, _, _ = build_fit(y, x, z, k=1, dtype=dtype)
    b, c = _initialize_beta(op, data, data.sample_mask[None, :])
    return b[0].cpu().numpy(), c[0].cpu().numpy()


def cv_iht_distribute_fold(d, l, x, z, y, J, path, q, *, destin="./",
                           folds=None, debias=False, parallel=True,
                           showinfo=False, max_iter=100, dtype=torch.float32,
                           rng=None):
    """Legacy distributed-cv entry point (reference exports it at
    src/MendelIHT.jl:28, used by figures/ukbiobank/distribute_folds.jl with
    per-fold scratch files).  All (fold, k) tasks run as one batch of
    tasks; each fold's mse vector is also written to
    ``destin/cviht_fold{i}.txt`` (columns k and mse).  Returns the
    fold-size-weighted mean loss per k, as ``cv_iht``; ``parallel`` and
    ``showinfo`` are taken and ignored."""
    from .models.cv import _task_masks, meanloss
    from .models.fit import build_fit
    from .models.initialize import init_state
    from .models.univariate import predict_deviance, run_iht

    dtype = float_dtype(dtype, "cv_iht_distribute_fold")
    path = list(path)
    op, data, cfg, _ = build_fit(y, x, z, k=max(path), J=J, d=d, l=l,
                                 debias=debias, max_iter=max_iter,
                                 dtype=dtype)
    folds, ks, train, test = _task_masks(op, q, path, folds, rng)
    st = init_state(op, data, cfg, ks, train)
    st = run_iht(op, data, cfg, st)
    mses = predict_deviance(op, data, cfg, st, test)
    mses = mses.cpu().numpy().astype(np.float64)

    os.makedirs(destin, exist_ok=True)
    per_fold = mses.reshape(q, len(path))
    for i in range(q):
        np.savetxt(os.path.join(destin, f"cviht_fold{i + 1}.txt"),
                   np.column_stack([path, per_fold[i]]),
                   header="k\tmse", comments="", delimiter="\t")
    return meanloss(mses, q, folds)
