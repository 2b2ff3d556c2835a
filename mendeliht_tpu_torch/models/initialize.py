"""Solver-state initialization (reference ``init_iht_indices!``,
src/utilities.jl:366-438, and ``initialize_beta!``, :776-812): Newton
intercept, score, then the initial support: the top-(k + zkeepn) of the
score, the group projection's quirk, or the univariate-regression warm
start (``init_beta``).  Batched over tasks, which may differ in sparsity k
and in their sample mask."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import glm
from .state import IHTState, FitConfig, FitData
from .univariate import (_local_tasks, _proj_group, _proj_joint, _score,
                         _snp_reduce)


def _newton_intercept(link: str, ybar, n_iter: int = 20):
    """Solve linkinv(c) = ybar by damped Newton (reference
    src/utilities.jl:394-405). ybar (B,) -> (B,)."""
    c = torch.zeros_like(ybar)
    for _ in range(n_iter):
        g1 = glm.linkinv(link, c)
        g2 = glm.mueta(link, c)
        step = torch.clamp((g1 - ybar) / g2, -1.0, 1.0)
        c = torch.where((g1 - ybar).abs() < 1e-10, c, c - step)
    return c


def _initialize_beta(op, data: FitData, cv_wts):
    """Univariate-regression warm start (reference src/utilities.jl:776-812):
    per SNP j, regress y on [1, x_j] over the training samples; the slopes
    clipped to +-2 are b, the intercepts (and the covariates' own
    regressions) averaged into c[:, 0].  Returns (b (B, p), c (B, q)).  The
    moments come from one score pass at width 2B (``PackedOp.col_moments``):
    on the card its int8 digits hold the 0/1 ``cv_wts`` exactly and the WY
    columns to 21 bits against their max (56 bits in a float64 fit)."""
    W = cv_wts
    WY = cv_wts * data.y[None, :]
    Sx, Sxx, Sxy = op.col_moments(W, WY)
    N = W.sum(dim=1, keepdim=True)
    Sy = WY.sum(dim=1, keepdim=True)
    det = N * Sxx - Sx * Sx
    ok = det > 1e-12
    one = torch.ones_like(det)
    slope = torch.where(ok, (N * Sxy - Sx * Sy) / torch.where(ok, det, one),
                        Sxy)
    icept = torch.where(ok, (Sy - Sx * slope) / N, Sy)
    b = torch.clamp(slope, -2.0, 2.0)

    q = data.z.shape[1]
    c = torch.zeros((cv_wts.shape[0], q), dtype=b.dtype, device=b.device)
    icept_sum = _snp_reduce(op, icept.sum(dim=1), "sum")
    if q > 1:
        # non-genetic covariates (columns 2..q; column 1 is the intercept)
        zc_cols = data.z[:, 1:]                              # (n_pad, q-1)
        Szx = W @ zc_cols
        Szxx = W @ (zc_cols * zc_cols)
        Szxy = WY @ zc_cols
        detz = N * Szxx - Szx * Szx
        okz = detz > 1e-12
        onez = torch.ones_like(detz)
        slz = torch.where(okz, (N * Szxy - Szx * Sy)
                          / torch.where(okz, detz, onez), Szxy)
        icz = torch.where(okz, (Sy - Szx * slz) / N, Sy)
        c[:, 1:] = torch.clamp(slz, -2.0, 2.0)
        icept_sum = icept_sum + icz.sum(dim=1)
    c[:, 0] = torch.clamp(icept_sum / (op.p + q - 1), -2.0, 2.0)
    return b, c


def init_state(op, data: FitData, cfg: FitConfig, k, cv_wts,
               init_beta: bool = False) -> IHTState:
    """Initial IHTState for a batch of tasks.

    k: (B,) per-task sparsity; cv_wts: (B, n_pad) 0/1 training masks
    (already zero at padding); ``init_beta`` starts from
    :func:`_initialize_beta`."""
    dtype, device = op.dtype, op.device
    k = torch.as_tensor(k, dtype=torch.int64, device=device).reshape(
        cv_wts.shape[0])
    # a sharded operator's rank holds its task rows and SNP columns
    k, cv_wts = _local_tasks(op, k, cv_wts)
    B = cv_wts.shape[0]
    p = getattr(op, "p_local", op.p)
    q, n_pad = data.z.shape[1], op.n_pad
    cv_wts = cv_wts.to(dtype)
    zeros = dict(dtype=dtype, device=device)

    b = torch.zeros((B, p), **zeros)
    c = torch.zeros((B, q), **zeros)
    # intercept by Newton on the training-sample mean
    ybar = (data.y[None, :] * cv_wts).sum(dim=1) / \
        torch.clamp((cv_wts != 0).sum(dim=1), min=1)
    c[:, 0] = _newton_intercept(cfg.link, ybar)
    zc = c @ data.z.T
    xb = torch.zeros((B, n_pad), **zeros)
    st = IHTState(
        b=b, c=c, b0=torch.zeros_like(b), c0=torch.zeros_like(c),
        best_b=torch.zeros_like(b), best_c=torch.zeros_like(c),
        df=torch.zeros_like(b), df2=torch.zeros_like(c),
        sel_idx=torch.zeros((B, cfg.S), dtype=torch.int64, device=device),
        sel_valid=torch.zeros((B, cfg.S), dtype=torch.bool, device=device),
        idc=torch.zeros((B, q), dtype=torch.bool, device=device),
        xb=xb, zc=zc, mu=glm.linkinv(cfg.link, xb + zc),
        nb_r=torch.ones((B,), **zeros),
        logl=torch.full((B,), float("-inf"), **zeros),
        best_logl=torch.full((B,), float("-inf"), **zeros),
        k=k, cv_wts=cv_wts,
        active=torch.ones((B,), dtype=torch.bool, device=device),
        failed=torch.zeros((B,), dtype=torch.bool, device=device),
        iters=torch.zeros((B,), dtype=torch.int64, device=device),
        eta=torch.zeros((B,), **zeros),
        backtracks=torch.zeros((B,), dtype=torch.int64, device=device),
        iteration=0,
    )

    df, df2 = _score(op, data, cfg, st)
    st = dataclasses.replace(st, df=df, df2=df2)
    weight = data.weight if cfg.has_weight else None
    if init_beta:
        # the linear predictors, mean and logl stay the intercept-only ones
        # (the JAX package's init_state does the same)
        b, c = _initialize_beta(op, data, st.cv_wts)
        b, c, sel_idx, _, sel_valid = _proj_joint(
            op, b, c, k + cfg.zkeepn, data.zkeep, cfg.S, weight=weight)
        return dataclasses.replace(
            st, b=b, c=c, b0=b, c0=c, sel_idx=sel_idx, sel_valid=sel_valid,
            idc=c != 0)
    if cfg.use_group:
        # reference quirk (src/utilities.jl:427-429): group init projects
        # the score but takes the support of the all-zero b, so the support
        # is empty and idc all true; the first step then takes the 1e-8
        # stepsize guard where the covariates' score is zero
        df_p = _proj_group(op, cfg, df, data.group, data.group_ks,
                           None if cfg.group_k_is_vector else k)
        return dataclasses.replace(
            st, df=df_p, sel_valid=torch.zeros_like(st.sel_valid),
            idc=torch.ones((B, q), dtype=torch.bool, device=device))
    # top-(k + zkeepn) of |score| defines the initial support; the score is
    # replaced by its projection, so the first gradient step moves only the
    # selected entries (reference src/utilities.jl:416-431)
    df_p, df2_p, sel_idx, _, sel_valid = _proj_joint(
        op, df, df2, k + cfg.zkeepn, data.zkeep, cfg.S, weight=weight)
    df2_p = torch.where(data.zkeep[None, :], df2, df2_p)
    return dataclasses.replace(
        st, df=df_p, df2=df2_p, sel_idx=sel_idx, sel_valid=sel_valid,
        idc=data.zkeep[None, :].expand(B, q).clone())
