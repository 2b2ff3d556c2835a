"""Debiasing: an exact GLM refit on the current support (reference
src/utilities.jl:1014-1020; the JAX package's ``models/debias.py``).  As in
the reference, the refit uses the genetic columns alone, no intercept or
covariates, and ignores the cv weights; both quirks stay for parity.

Batched IRLS on the gathered standardized columns: for Normal / identity
one weighted least-squares solve (exact); otherwise at most ``_IRLS_MAX``
iterations, stopping once no task's coefficients move by more than
``_IRLS_TOL`` of their scale, read on the host once an iteration."""

from __future__ import annotations

import torch

from ..ops import glm
from .state import FitConfig, FitData
from .univariate import _split_sel

_IRLS_MAX = 25
_IRLS_TOL = 1e-6


def debias_refit(op, data: FitData, cfg: FitConfig, st):
    """The (B, p) genetic model with its support's coefficients refitted."""
    gidx, gval = _split_sel(st.sel_idx, st.sel_valid, op.p)
    Xk = op.gather_cols(gidx, gval)                       # (B, S, n_pad)
    S = Xk.shape[1]
    beta0 = torch.gather(st.b, 1, gidx) * gval

    m = data.sample_mask[None, :]
    eye = torch.eye(S, dtype=Xk.dtype, device=Xk.device)[None]
    invalid_diag = eye * (~gval).to(Xk.dtype)[:, :, None]

    def irls_step(beta):
        eta = torch.einsum("bsn,bs->bn", Xk, beta)
        mu = glm.linkinv(cfg.link, eta)
        me = glm.mueta(cfg.link, eta)
        var = torch.clamp(glm.glmvar(cfg.dist, mu, nb_r=st.nb_r[:, None]),
                          min=1e-30)
        w = (me * me / var) * m
        zw = eta + (data.y[None, :] - mu) / torch.where(
            me == 0, torch.ones_like(me), me)
        Xw = Xk * w[:, None, :]
        A = torch.einsum("bsn,btn->bst", Xw, Xk) + invalid_diag + 1e-8 * eye
        rhs = torch.einsum("bsn,bn->bs", Xw, zw)
        return torch.linalg.solve(A, rhs[..., None])[..., 0] * gval

    beta = irls_step(beta0)
    if not (cfg.dist == "normal" and cfg.link == "identity"):
        prev, i = beta0, 1
        while i < _IRLS_MAX and float(
                (beta - prev).abs().max()
                / (prev.abs().max() + 1.0)) > _IRLS_TOL:
            beta, prev, i = irls_step(beta), beta, i + 1

    # write the valid slots alone: an invalid slot's index (0) may be a
    # valid slot's too
    hit = torch.zeros_like(st.b, dtype=torch.int32).scatter_add_(
        1, gidx, gval.to(torch.int32)) > 0
    refit = torch.zeros_like(st.b).scatter_add_(
        1, gidx, torch.where(gval, beta, torch.zeros_like(beta)))
    return torch.where(hit, refit, st.b)
