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
import sys

import torch

from ..ops import glm, negbin
from ..ops.projections import (project_group_sparse_batched,
                               project_group_sparse_per_task,
                               project_topk_joint, put_slots, select_support)
from .state import IHTState, FitConfig, FitData

_INF_STEP_GUARD = 1e-8
# iterations between two progress lines of a cv (the JAX package's)
_PROGRESS_STEP = 5


def _where_b(mask, new, old):
    """Merge with a (B,)-bool mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _split_sel(sel_idx, sel_valid, p):
    """sel indexes the concatenated [b; c] vector; split the genetic part."""
    is_g = sel_idx < p
    gidx = torch.where(is_g, sel_idx, torch.zeros_like(sel_idx))
    return gidx, sel_valid & is_g


# --- operator-routed support primitives and SNP-axis reductions ----------
# A sharded operator (parallel.ShardedPackedOp) holds only its rank's SNP
# columns of every (B, p) array, so it overrides these, as the JAX
# package's dispatchers route them (mendeliht_tpu/models/univariate.py:
# 53-95): gathers and projections exchange (B, S) candidate lists between
# its ranks, reductions over the SNP axis combine its ranks' partial ones,
# and the task axis is split over its rank groups.  Any other operator
# takes the single-device code.

def _take_b(op, arr, gidx, gval):
    """Masked (B, S) gather from a (B, p) array along the SNP axis."""
    f = getattr(op, "take_b", None)
    if f is not None:
        return f(arr, gidx, gval)
    v = torch.gather(arr, 1, gidx)
    return torch.where(gval, v, torch.zeros_like(v))


def _put_b(op, arr, gidx, gval, vals):
    """``arr`` (B, p) with the valid slots' entries replaced by ``vals``
    (B, S) (``ops.projections.put_slots``)."""
    f = getattr(op, "put_b", None)
    if f is not None:
        return f(arr, gidx, gval, vals)
    return put_slots(arr, gidx, gval, vals)


def _proj_joint(op, b, c, k_plus_keep, zkeep, S, weight=None):
    f = getattr(op, "project_topk_joint", None)
    if f is not None:
        return f(b, c, k_plus_keep, zkeep, S, weight=weight)
    return project_topk_joint(b, c, k_plus_keep, zkeep, S, weight=weight)


def _sel_support(op, b, c, zkeep, S):
    f = getattr(op, "select_support", None)
    if f is not None:
        return f(b, c, zkeep, S)
    return select_support(b, c, zkeep, S)


def _proj_group(op, cfg, b1, group, group_ks, k_task):
    """The doubly-sparse projection; ``k_task`` None takes the per-group
    caps ``group_ks``, else every group's cap is the task's own k."""
    f = getattr(op, "project_group_sparse", None)
    if f is not None:
        return f(b1, group, cfg.J, group_ks, k_task, cfg.n_groups,
                 cfg.group_cand)
    if k_task is None:
        return project_group_sparse_batched(b1, group, cfg.J, group_ks,
                                            cfg.n_groups)
    return project_group_sparse_per_task(b1, group, cfg.J, k_task,
                                         cfg.n_groups)


def _snp_reduce(op, x, how: str):
    """``x``, a reduction over the SNP axis of this operator's columns,
    reduced over all of them: ``how`` "max" or "sum" (a sharded operator
    combines its ranks' partial results; any other has them all)."""
    f = getattr(op, "reduce_snp", None)
    return x if f is None else f(x, how)


def _local_tasks(op, *arrays):
    """The rows of this operator's tasks of each (B, ...) array (a sharded
    operator's task group holds a block of them; any other all)."""
    f = getattr(op, "task_rows", None)
    return arrays if f is None else tuple(f(a) for a in arrays)


def _all_tasks(op, x):
    """The (B, ...) result of every task from this operator's rows of it
    (the inverse of :func:`_local_tasks`)."""
    f = getattr(op, "gather_tasks", None)
    return x if f is None else f(x)


def _stepsize(op, data: FitData, cfg: FitConfig, st: IHTState):
    """eta = ||grad_supp||^2 / ||sqrt(W) X grad_supp||^2
    (reference src/utilities.jl:722-764)."""
    gidx, gval = _split_sel(st.sel_idx, st.sel_valid, op.p)
    df_sel = _take_b(op, st.df, gidx, gval)
    numer = (df_sel * df_sel).sum(dim=1)
    df2_supp = torch.where(st.idc, st.df2, torch.zeros_like(st.df2))
    numer = numer + (df2_supp * df2_supp).sum(dim=1)

    xgk = op.forward_sel(gidx, df_sel, gval.to(df_sel.dtype))
    xgk = xgk + df2_supp @ data.z.T
    me = glm.mueta(cfg.link, st.xb + st.zc)
    gv = torch.clamp(glm.glmvar(cfg.dist, st.mu, nb_r=st.nb_r[:, None]),
                     min=1e-30)
    w = torch.sqrt(me * me / gv) * st.cv_wts
    wx = xgk * w
    eta = numer / (wx * wx).sum(dim=1)
    bad = torch.isinf(eta) | torch.isnan(eta)
    return torch.where(bad, torch.full_like(eta, _INF_STEP_GUARD), eta)


def _gradstep(op, data: FitData, cfg: FitConfig, st: IHTState, eta):
    """b = P_k(b0 + eta*df), c = P(c0 + eta*df2); returns (b, c, sel_idx,
    sel_valid, idc) (reference src/utilities.jl:252-280)."""
    b1 = st.b0 + eta[:, None] * st.df
    c1 = st.c0 + eta[:, None] * st.df2
    if cfg.use_group:
        # the group path projects the genetic coefficients alone
        # (reference src/utilities.jl:267-269); a scalar per-group k is the
        # task's own st.k, which cv varies per (fold, k) combo
        b_new = _proj_group(op, cfg, b1, data.group, data.group_ks,
                            None if cfg.group_k_is_vector else st.k)
        sel_idx, sel_valid = _sel_support(op, b_new, torch.zeros_like(c1),
                                          data.zkeep, cfg.S)
        return b_new, c1, sel_idx, sel_valid, c1 != 0
    b_new, c_new, sel_idx, _, sel_valid = _proj_joint(
        op, b1, c1, st.k + cfg.zkeepn, data.zkeep, cfg.S,
        weight=data.weight if cfg.has_weight else None)
    return b_new, c_new, sel_idx, sel_valid, c_new != 0


def _forward(op, data: FitData, cfg: FitConfig, b, c, sel_idx, sel_valid):
    """xb = X[:, supp] b_supp; zc = Z c; both clamped to +-20 for every
    family but the normal (reference src/utilities.jl:93-118)."""
    gidx, gval = _split_sel(sel_idx, sel_valid, op.p)
    bcoef = _take_b(op, b, gidx, gval)
    xb = op.forward_sel(gidx, bcoef, gval.to(b.dtype))
    zc = c @ data.z.T
    if cfg.dist != "normal":
        xb = torch.clamp(xb, -20.0, 20.0)
        zc = torch.clamp(zc, -20.0, 20.0)
    return xb, zc


def _loglik(data: FitData, cfg: FitConfig, mu, cv_wts, nb_r):
    return glm.loglikelihood(cfg.dist, data.y[None, :], mu, cv_wts,
                             data.n_true, nb_r=nb_r[:, None], dim=1)


def _score(op, data: FitData, cfg: FitConfig, st: IHTState):
    """df = X' W (y-mu), df2 = Z' W (y-mu) (reference
    src/utilities.jl:126-135)."""
    r = glm.score_residual(cfg.dist, cfg.link, data.y[None, :], st.mu,
                           st.xb + st.zc, st.cv_wts, nb_r=st.nb_r[:, None])
    return op.xtr(r), r @ data.z


def _maybe_update_r(data: FitData, cfg: FitConfig, mu, nb_r, cv_wts):
    """The negative-binomial r re-estimated at mean mu (``cfg.est_r``), or
    nb_r as it is."""
    if cfg.est_r == "none":
        return nb_r
    return negbin.mle_for_r(cfg.est_r, data.y, mu, nb_r, data.sample_mask,
                            cv_wts, data.n_true)


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
    b, c, sel_idx, sel_valid, idc = _gradstep(op, data, cfg, st, eta_t)
    xb, zc = _forward(op, data, cfg, b, c, sel_idx, sel_valid)
    mu = glm.linkinv(cfg.link, xb + zc)
    nb_r = _maybe_update_r(data, cfg, mu, st.nb_r, st.cv_wts)
    logl = _loglik(data, cfg, mu, st.cv_wts, nb_r)
    return dict(b=b, c=c, sel_idx=sel_idx, sel_valid=sel_valid, idc=idc,
                xb=xb, zc=zc, mu=mu, nb_r=nb_r, logl=logl)


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
    """Accept the line-search result: score, NaN guard, debias,
    convergence."""
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

    # debias from the 5th iteration on, where the support did not change
    # (reference src/fit.jl:188, utilities.jl:1014-1020)
    if cfg.debias and new.iteration + 1 >= 5:
        from .debias import debias_refit
        supp_same = _snp_reduce(
            op, ((new.b != 0) != (new.b0 != 0)).sum(dim=1), "sum") == 0
        new = dataclasses.replace(new, b=_where_b(
            act & supp_same, debias_refit(op, data, cfg, new), new.b))

    # convergence (reference src/utilities.jl:953-957, fit.jl:193-203)
    it = new.iteration + 1             # 1-based iteration just completed
    scaled = _scaled_change(op, new)
    done = act & (((it >= cfg.min_iter) & (scaled < cfg.tol)) | bad)
    new = dataclasses.replace(
        new, active=act & ~done, failed=new.failed | bad,
        iters=torch.where(done, torch.full_like(new.iters, it), new.iters),
        iteration=it)
    if cfg.log_iters:
        # task 0's line (reference fit.jl:194-196)
        line = (f"Iteration {it}: loglikelihood = {float(new.logl[0])}, "
                f"backtracks = {int(new.backtracks[0])}, "
                f"tol = {float(scaled[0])}")
        if cfg.log_io is not None:
            print(line, file=cfg.log_io)
        print(line)
    return new


def _scaled_change(op, st: IHTState):
    """max|[b;c] - [b0;c0]| / (max|[b0;c0]| + 1) per task."""
    db, b0 = _snp_reduce(op, torch.stack([(st.b - st.b0).abs().amax(dim=1),
                                          st.b0.abs().amax(dim=1)]), "max")
    dc = (st.c - st.c0).abs().amax(dim=1)
    denom = torch.maximum(b0, st.c0.abs().amax(dim=1))
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
    sel_idx, sel_valid = _sel_support(op, best_b, best_c, data.zkeep, cfg.S)
    xb, zc = _forward(op, data, cfg, best_b, best_c, sel_idx, sel_valid)
    mu = glm.linkinv(cfg.link, xb)     # genotype-only mean, used by pve
    return dataclasses.replace(
        st, b=best_b, c=best_c, best_b=best_b, best_c=best_c,
        best_logl=best_logl, iters=iters,
        active=torch.zeros_like(st.active), sel_idx=sel_idx,
        sel_valid=sel_valid, idc=best_c != 0, xb=xb, zc=zc, mu=mu)


def run_segmented(op, data, cfg, st, advance=run_segment, *,
                  checkpoint_dir=None, checkpoint_every: int = 20,
                  progress: bool = False, verbose: bool = False):
    """Advance ``st`` (an IHTState, or an MIHTState with ``advance=
    mv.run_mv_segment``) until every task converges or max_iter - 1
    iterations have run, the one solve of every fit and cv.

    With neither ``checkpoint_dir`` nor ``progress`` it is one
    ``advance``.  Else it runs segments: with ``checkpoint_dir`` it first
    restores the newest state saved there (``utils/checkpoint.py``), runs
    segments of ``checkpoint_every`` iterations and saves the state after
    each; with ``progress`` (segments of ``_PROGRESS_STEP`` iterations
    where nothing is saved) it prints the converged-task count after each
    to stderr (the reference's ProgressMeter over (fold, k) fits,
    src/cross_validation.jl:95; tasks converge in lockstep here), as
    ``\r`` updates on a terminal and as lines otherwise.  The step is
    deterministic given the state, so how the run is segmented, or where
    it was killed and resumed, does not change a bit of the result."""
    if checkpoint_dir is None and not progress:
        return advance(op, data, cfg, st, cfg.max_iter - 1)
    from ..utils.checkpoint import restore_state, save_state
    if checkpoint_dir is not None:
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be at least 1, got "
                             f"{checkpoint_every}")
        restored = restore_state(checkpoint_dir, st)
        if restored is not None:
            st, at = restored
            if verbose:
                print(f"resuming from checkpoint step {at}")
        step = checkpoint_every
    else:
        step = _PROGRESS_STEP
    B = int(st.active.shape[0])
    tty = progress and getattr(sys.stderr, "isatty", lambda: False)()
    n_active = int(st.active.sum())
    while st.iteration < cfg.max_iter - 1 and n_active:
        st = advance(op, data, cfg, st, st.iteration + step)
        n_active = int(st.active.sum())
        if checkpoint_dir is not None:
            save_state(checkpoint_dir, st, st.iteration)
            if verbose:
                print(f"checkpoint at iteration {st.iteration}; {n_active} "
                      "tasks still active")
        if progress:
            msg = (f"Cross-validating: iteration {st.iteration:4d}, "
                   f"{B - n_active}/{B} models converged")
            print("\r" + msg if tty else msg, end="" if tty else "\n",
                  file=sys.stderr, flush=True)
    if tty:
        print(file=sys.stderr)
    return st


def run_iht(op, data: FitData, cfg: FitConfig, st: IHTState,
            **segments) -> IHTState:
    """Full solve: loop to completion (:func:`run_segmented`, with its
    checkpoint and progress ``segments`` options), then restore the best
    model."""
    st = run_segmented(op, data, cfg, st, **segments)
    return finalize_iht(op, data, cfg, st)


def predict_deviance(op, data: FitData, cfg: FitConfig, st: IHTState,
                     test_wts: torch.Tensor) -> torch.Tensor:
    """Holdout deviance (B,) of the fitted models (reference predict!,
    src/cross_validation.jl:279-286): the full mean g^-1(xb + zc) against
    the held-out samples of each task."""
    mu = glm.linkinv(cfg.link, st.xb + st.zc)
    return glm.deviance(cfg.dist, data.y[None, :], mu, test_wts,
                        nb_r=st.nb_r[:, None], dim=1)


def cv_fused(op, data: FitData, cfg: FitConfig, ks, train_wts, test_wts,
             init_beta: bool = False, **segments):
    """init + solve + finalize + holdout deviance of the whole
    cross-validation grid as one batch of tasks; ``segments`` are
    :func:`run_segmented`'s checkpoint and progress options."""
    from .initialize import init_state

    st = init_state(op, data, cfg, ks, train_wts, init_beta=init_beta)
    st = run_iht(op, data, cfg, st, **segments)
    (test_wts,) = _local_tasks(op, test_wts)
    return _all_tasks(op, predict_deviance(op, data, cfg, st, test_wts))


def _sparse_extract(op, st: IHTState, sigma_g):
    """Sparse result pieces of every task: ~S floats instead of the (B, p)
    beta."""
    p = op.p
    gidx, gval = _split_sel(st.sel_idx, st.sel_valid, p)
    is_c = st.sel_idx >= p
    cidx = torch.where(is_c, st.sel_idx - p, torch.zeros_like(st.sel_idx))
    sel_bc = torch.where(is_c, torch.gather(st.c, 1, cidx),
                         _take_b(op, st.b, gidx, gval)) * st.sel_valid
    return tuple(_all_tasks(op, t) for t in (
        st.sel_idx, st.sel_valid, sel_bc, st.c, st.best_logl, st.iters,
        st.failed, sigma_g))
