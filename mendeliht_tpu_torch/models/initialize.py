"""Solver-state initialization (reference ``init_iht_indices!``,
src/utilities.jl:366-438): Newton intercept, score, top-(k + zkeepn)
projection of the score.  Batched over tasks, which may differ in sparsity k
and in their sample mask."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import glm
from ..ops.projections import project_topk_joint
from .state import IHTState, FitConfig, FitData
from .univariate import _score


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


def init_state(op, data: FitData, cfg: FitConfig, k, cv_wts) -> IHTState:
    """Initial IHTState for a batch of tasks.

    k: (B,) per-task sparsity; cv_wts: (B, n_pad) 0/1 training masks
    (already zero at padding)."""
    dtype, device = op.dtype, op.device
    B = cv_wts.shape[0]
    p, q, n_pad = op.p, data.z.shape[1], op.n_pad
    k = torch.as_tensor(k, dtype=torch.int64, device=device).reshape(B)
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

    # top-(k + zkeepn) of |score| defines the initial support; the score is
    # replaced by its projection, so the first gradient step moves only the
    # selected entries (reference src/utilities.jl:416-431)
    df, df2 = _score(op, data, cfg, st)
    df_p, df2_p, sel_idx, _, sel_valid = project_topk_joint(
        df, df2, k + cfg.zkeepn, data.zkeep, cfg.S)
    df2_p = torch.where(data.zkeep[None, :], df2, df2_p)
    return dataclasses.replace(
        st, df=df_p, df2=df2_p, sel_idx=sel_idx, sel_valid=sel_valid,
        idc=data.zkeep[None, :].expand(B, q).clone())
