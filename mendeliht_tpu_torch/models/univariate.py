"""Batched univariate IHT solver, stepped from the host.

Mirrors the reference algorithm step for step (src/fit.jl:145-263
``fit_iht!`` / ``iht_one_step!``, src/utilities.jl:252-280
``_iht_gradstep!``, :722-764 ``iht_stepsize!``) and the JAX package's
``models/univariate.py`` piece for piece.  PyTorch has no traced while loop,
so the iteration and its bounded backtracking line search run on the host,
as in the JAX package's ``models/streamed.py``: one
``need.any()`` read per backtrack check and one ``active.any()`` read per
iteration.  Tasks ride a leading batch axis B with masked updates; the
support is a fixed-size list of S slots.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import glm
from ..ops.projections import project_topk_joint, select_support
from .state import IHTState, FitConfig, FitData

_INF_STEP_GUARD = 1e-8


def _where_b(mask, new, old):
    """Merge with a (B,)-bool mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _split_sel(sel_idx, sel_valid, p):
    """sel indexes the concatenated [b; c] vector; split the genetic part."""
    is_g = sel_idx < p
    gidx = torch.where(is_g, sel_idx, torch.zeros_like(sel_idx))
    return gidx, sel_valid & is_g


def _take_b(arr, gidx, gval):
    """Masked (B, S) gather from a (B, p) array along the SNP axis."""
    v = torch.gather(arr, 1, gidx)
    return torch.where(gval, v, torch.zeros_like(v))


def _stepsize(op, data: FitData, cfg: FitConfig, st: IHTState):
    """eta = ||grad_supp||^2 / ||sqrt(W) X grad_supp||^2
    (reference src/utilities.jl:722-764)."""
    gidx, gval = _split_sel(st.sel_idx, st.sel_valid, op.p)
    df_sel = _take_b(st.df, gidx, gval)
    numer = (df_sel * df_sel).sum(dim=1)
    df2_supp = torch.where(st.idc, st.df2, torch.zeros_like(st.df2))
    numer = numer + (df2_supp * df2_supp).sum(dim=1)

    xgk = op.forward_sel(gidx, df_sel, gval.to(df_sel.dtype))
    xgk = xgk + df2_supp @ data.z.T
    me = glm.mueta(cfg.link, st.xb + st.zc)
    gv = torch.clamp(glm.glmvar(cfg.dist, st.mu), min=1e-30)
    w = torch.sqrt(me * me / gv) * st.cv_wts
    wx = xgk * w
    eta = numer / (wx * wx).sum(dim=1)
    bad = torch.isinf(eta) | torch.isnan(eta)
    return torch.where(bad, torch.full_like(eta, _INF_STEP_GUARD), eta)


def _gradstep(data: FitData, cfg: FitConfig, st: IHTState, eta):
    """b = P_k(b0 + eta*df), c = P(c0 + eta*df2); returns (b, c, sel_idx,
    sel_valid, idc) (reference src/utilities.jl:252-280, joint branch)."""
    b1 = st.b0 + eta[:, None] * st.df
    c1 = st.c0 + eta[:, None] * st.df2
    b_new, c_new, sel_idx, _, sel_valid = project_topk_joint(
        b1, c1, st.k + cfg.zkeepn, data.zkeep, cfg.S)
    return b_new, c_new, sel_idx, sel_valid, c_new != 0


def _forward(op, data: FitData, b, c, sel_idx, sel_valid):
    """xb = X[:, supp] b_supp; zc = Z c (reference src/utilities.jl:93-118;
    the Normal family needs no clamp)."""
    gidx, gval = _split_sel(sel_idx, sel_valid, op.p)
    bcoef = _take_b(b, gidx, gval)
    xb = op.forward_sel(gidx, bcoef, gval.to(b.dtype))
    return xb, c @ data.z.T


def _loglik(data: FitData, cfg: FitConfig, mu, cv_wts):
    return glm.loglikelihood(cfg.dist, data.y[None, :], mu, cv_wts,
                             data.n_true, dim=1)


def _score(op, data: FitData, cfg: FitConfig, st: IHTState):
    """df = X' W (y-mu), df2 = Z' W (y-mu) (reference
    src/utilities.jl:126-135)."""
    r = glm.score_residual(cfg.dist, cfg.link, data.y[None, :], st.mu,
                           st.xb + st.zc, st.cv_wts)
    return op.xtr(r), r @ data.z


def _save_prev(st: IHTState) -> IHTState:
    """save_prev (reference src/utilities.jl:702-712)."""
    act = st.active
    improved = act & (st.logl > st.best_logl)
    return dataclasses.replace(
        st, b0=_where_b(act, st.b, st.b0), c0=_where_b(act, st.c, st.c0),
        best_b=_where_b(improved, st.b, st.best_b),
        best_c=_where_b(improved, st.c, st.best_c),
        best_logl=torch.where(improved, st.logl, st.best_logl))


def _take_step(op, data: FitData, cfg: FitConfig, st: IHTState, eta_t):
    """One projected gradient step + model refresh at stepsize eta_t (the
    body of the backtracking line search, reference src/fit.jl:213-263)."""
    b, c, sel_idx, sel_valid, idc = _gradstep(data, cfg, st, eta_t)
    xb, zc = _forward(op, data, b, c, sel_idx, sel_valid)
    mu = glm.linkinv(cfg.link, xb + zc)
    logl = _loglik(data, cfg, mu, st.cv_wts)
    return dict(b=b, c=c, sel_idx=sel_idx, sel_valid=sel_valid, idc=idc,
                xb=xb, zc=zc, mu=mu, logl=logl)


def _bt_need(act, old_logl, cur, n_bt, max_step):
    return act & (old_logl > cur["logl"]) & (n_bt < max_step)


def _iteration(op, data: FitData, cfg: FitConfig, st: IHTState) -> IHTState:
    """One IHT iteration: save_prev, stepsize, step, backtracking, score,
    convergence."""
    act = st.active
    st = _save_prev(st)
    eta = _stepsize(op, data, cfg, st)
    old_logl = st.logl
    cur = _take_step(op, data, cfg, st, eta)
    n_bt = torch.zeros_like(eta, dtype=torch.int64)
    while True:
        need = _bt_need(act, old_logl, cur, n_bt, cfg.max_step)
        if not bool(need.any()):
            break
        eta = torch.where(need, eta / 2, eta)
        nxt = _take_step(op, data, cfg, st, eta)
        cur = {k: _where_b(need, nxt[k], cur[k]) for k in cur}
        n_bt = n_bt + need.to(torch.int64)
    return _post_step(op, data, cfg, st, cur, eta, n_bt)


def _post_step(op, data: FitData, cfg: FitConfig, st: IHTState, cur, eta,
               n_bt) -> IHTState:
    """Accept the line-search result: score, NaN guard, convergence."""
    act = st.active
    new = dataclasses.replace(
        st, **{k: _where_b(act, cur[k], getattr(st, k)) for k in cur},
        eta=torch.where(act, eta, st.eta),
        backtracks=torch.where(act, n_bt, st.backtracks))

    # score at the accepted iterate
    df, df2 = _score(op, data, cfg, new)
    new = dataclasses.replace(new, df=_where_b(act, df, new.df),
                              df2=_where_b(act, df2, new.df2))

    # non-finite loglikelihood -> fail the task (reference throws, fit.jl:259)
    bad = act & (torch.isnan(new.logl) | torch.isinf(new.logl))

    # convergence (reference src/utilities.jl:953-957, fit.jl:193-203)
    it = new.iteration + 1             # 1-based iteration just completed
    scaled = _scaled_change(new)
    done = act & (((it >= cfg.min_iter) & (scaled < cfg.tol)) | bad)
    if cfg.log_iters:
        print(f"Iteration {it}: loglikelihood = {float(new.logl[0])}, "
              f"backtracks = {int(new.backtracks[0])}, "
              f"tol = {float(scaled[0])}")
    return dataclasses.replace(
        new, active=act & ~done, failed=new.failed | bad,
        iters=torch.where(done, torch.full_like(new.iters, it), new.iters),
        iteration=it)


def _scaled_change(st: IHTState):
    """max|[b;c] - [b0;c0]| / (max|[b0;c0]| + 1) per task."""
    db = (st.b - st.b0).abs().amax(dim=1)
    dc = (st.c - st.c0).abs().amax(dim=1)
    denom = torch.maximum(st.b0.abs().amax(dim=1), st.c0.abs().amax(dim=1))
    return torch.maximum(db, dc) / (denom + 1.0)


def run_segment(op, data: FitData, cfg: FitConfig, st: IHTState,
                stop: int) -> IHTState:
    """Advance until all tasks converge, ``stop`` iterations are reached, or
    max_iter - 1 steps have run (the reference's ``for iter in 1:max_iter``
    breaks before stepping at iter == max_iter).  Resumable."""
    limit = min(int(stop), cfg.max_iter - 1)
    while st.iteration < limit and bool(st.active.any()):
        st = _iteration(op, data, cfg, st)
    return st


def finalize_iht(op, data: FitData, cfg: FitConfig, st: IHTState) -> IHTState:
    """Count the last iterate, restore the best one, and recompute its
    linear predictors (reference save_best_model!,
    src/utilities.jl:995-1006)."""
    # tasks that never converged report max_iter (reference fit.jl:169-179)
    iters = torch.where(st.active, torch.full_like(st.iters, cfg.max_iter),
                        st.iters)
    improved = st.logl > st.best_logl
    best_b = _where_b(improved, st.b, st.best_b)
    best_c = _where_b(improved, st.c, st.best_c)
    best_logl = torch.where(improved, st.logl, st.best_logl)
    sel_idx, sel_valid = select_support(best_b, best_c, data.zkeep, cfg.S)
    xb, zc = _forward(op, data, best_b, best_c, sel_idx, sel_valid)
    mu = glm.linkinv(cfg.link, xb)     # genotype-only mean, used by pve
    return dataclasses.replace(
        st, b=best_b, c=best_c, best_b=best_b, best_c=best_c,
        best_logl=best_logl, iters=iters,
        active=torch.zeros_like(st.active), sel_idx=sel_idx,
        sel_valid=sel_valid, idc=best_c != 0, xb=xb, zc=zc, mu=mu)


def run_iht(op, data: FitData, cfg: FitConfig, st: IHTState) -> IHTState:
    """Full solve: loop to completion, then restore the best model."""
    st = run_segment(op, data, cfg, st, cfg.max_iter - 1)
    return finalize_iht(op, data, cfg, st)


def predict_deviance(op, data: FitData, cfg: FitConfig, st: IHTState,
                     test_wts: torch.Tensor) -> torch.Tensor:
    """Holdout deviance (B,) of the fitted models (reference predict!,
    src/cross_validation.jl:279-286): the full mean g^-1(xb + zc) against
    the held-out samples of each task."""
    mu = glm.linkinv(cfg.link, st.xb + st.zc)
    return glm.deviance(cfg.dist, data.y[None, :], mu, test_wts, dim=1)


def cv_fused(op, data: FitData, cfg: FitConfig, ks, train_wts, test_wts):
    """init + solve + finalize + holdout deviance of the whole
    cross-validation grid as one batch of tasks."""
    from .initialize import init_state

    st = init_state(op, data, cfg, ks, train_wts)
    st = run_iht(op, data, cfg, st)
    return predict_deviance(op, data, cfg, st, test_wts)


def _sparse_extract(st: IHTState, sigma_g):
    """Sparse result pieces: ~S floats instead of the (B, p) beta."""
    full = torch.cat([st.b, st.c], dim=1)
    sel_bc = torch.gather(full, 1, st.sel_idx) * st.sel_valid
    return (st.sel_idx, st.sel_valid, sel_bc, st.c, st.best_logl, st.iters,
            st.failed, sigma_g)
