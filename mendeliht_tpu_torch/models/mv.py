"""Multivariate (multi-trait) Gaussian IHT, stepped from the host
(reference src/multivariate.jl; the JAX package's ``models/mv.py`` piece
for piece, with the host-level backtracking of its
``models/mv_streamed.py::_iteration_mv_host``).

Model: Y (r x n) ~ MatrixNormal(B X + C Z, Sigma).  IHT maximizes
  n/2 logdet(Gamma) - 1/2 tr(Gamma (Y-BX-CZ)(Y-BX-CZ)')
jointly over a k-sparse B and the precision Gamma (block ascent; Gamma
solved exactly each iteration, reference solve_Σ!, :276-282).

Tasks (cv folds x sparsity levels) ride a leading batch axis T, the traits
a small inner axis r.  The only O(n·p) work, the score ``Gamma R X'``, is
one pass of ``PackedOp.xtr`` at RHS width m = T·r.  As in
``models/univariate.py`` the host reads the device once per iteration
(``active.any()``) and once per backtrack check (``need.any()``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _time

import numpy as np
import torch

from ..ops.linalg import make_operator
from ..utils.device import float_dtype
from .fit import streamed_segments
from .initialize import _initialize_beta
from .pve import masked_var
from .results import MIHTResult, print_cv_results
from .state import FitConfig, FitData, state_from_numpy
from .univariate import _where_b as _where_t, run_segmented

_GUARD = 1e-8


@dataclasses.dataclass(frozen=True)
class MIHTState:
    """Batched multivariate IHT state (reference mIHTVariable,
    src/data_structures.jl:140-180).  Shapes: T tasks, r traits, p SNPs, q
    covariates, S column slots."""
    B: torch.Tensor          # (T, r, p) genetic effects
    C: torch.Tensor          # (T, r, q) covariate effects
    B0: torch.Tensor
    C0: torch.Tensor
    best_B: torch.Tensor
    best_C: torch.Tensor
    Gamma: torch.Tensor      # (T, r, r) precision
    Gamma0: torch.Tensor
    df: torch.Tensor         # (T, r, p) score
    df2: torch.Tensor        # (T, r, q)
    sel_idx: torch.Tensor    # (T, S) int64 SNP column support
    sel_valid: torch.Tensor  # (T, S) bool
    idc: torch.Tensor        # (T, q) bool
    BX: torch.Tensor         # (T, r, n_pad)
    CZ: torch.Tensor         # (T, r, n_pad)
    mu: torch.Tensor         # (T, r, n_pad)
    resid: torch.Tensor      # (T, r, n_pad)   (Y - mu) * cv_wts
    logl: torch.Tensor       # (T,)
    best_logl: torch.Tensor
    k: torch.Tensor          # (T,) int64
    cv_wts: torch.Tensor     # (T, n_pad)
    active: torch.Tensor
    failed: torch.Tensor
    iters: torch.Tensor      # (T,) int64
    eta: torch.Tensor
    backtracks: torch.Tensor  # (T,) int64
    iteration: int           # global loop counter, kept on the host

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "MIHTState":
        """Build from host arrays keyed by field name, e.g. the fields of
        the JAX package's MIHTState as numpy (extra keys are ignored)."""
        return state_from_numpy(cls, arrays, device)


@dataclasses.dataclass(frozen=True)
class MvData:
    Y: torch.Tensor            # (r, n_pad) zero-padded traits
    z: torch.Tensor            # (n_pad, q) zero-padded covariates
    zkeep: torch.Tensor        # (q,) bool
    sample_mask: torch.Tensor  # (n_pad,)
    n_true: int


@dataclasses.dataclass(frozen=True)
class MvConfig(FitConfig):
    S_entries: int = 32     # slots of the entry-level projection (k + zkeepn)


# ---------------------------------------------------------------------------
# projections over the trait-major [vec(B); vec(C)]
# ---------------------------------------------------------------------------

def _flatten_bc(Bm, Cm):
    """Trait-major flattening [vec(B_t1); vec(B_t2); ...; vec(C)], a free
    reshape of the (T, r, p) state (the reference's per-SNP order gives the
    same top-k)."""
    T = Bm.shape[0]
    return torch.cat([Bm.reshape(T, -1), Cm.reshape(T, -1)], dim=1)


def _unflatten_bc(full, r, p, q):
    T = full.shape[0]
    return (full[:, :p * r].reshape(T, r, p),
            full[:, p * r:].reshape(T, r, q))


def _project_joint_mv(Bm, Cm, k_plus_keep, zkeep, S_entries: int):
    """Top-k over the flattened [vec(B); vec(C)] with the zkeep columns
    pinned at +inf (reference project_k!, src/multivariate.jl:108-127)."""
    T, r, p = Bm.shape
    q = Cm.shape[2]
    full = _flatten_bc(Bm, Cm)
    pin = torch.cat([torch.zeros(p * r, dtype=torch.bool, device=Bm.device),
                     zkeep.repeat(r)])
    mag = full.abs().masked_fill(pin[None, :], float("inf"))
    _, topi = torch.topk(mag, S_entries, dim=1)
    vals = torch.gather(full, 1, topi)
    keep = (torch.arange(S_entries, device=Bm.device)[None, :]
            < k_plus_keep[:, None])
    new_full = torch.zeros_like(full).scatter_(
        1, topi, torch.where(keep, vals, torch.zeros_like(vals)))
    new_full = torch.where(pin[None, :], full, new_full)
    return _unflatten_bc(new_full, r, p, q)


def _column_support(Bm, S: int):
    """Top-S SNP columns by max |B| over the traits; valid = nonzero."""
    colmag = Bm.abs().amax(dim=1)                            # (T, p)
    vals, sel_idx = torch.topk(colmag, S, dim=1)
    return sel_idx, vals != 0


def _take_b_multi(arr, gidx, gval):
    """Masked (T, r, S) gather from a (T, r, p) array along the SNP axis."""
    T, r, _ = arr.shape
    v = torch.gather(arr, 2, gidx[:, None, :].expand(T, r, gidx.shape[1]))
    return v * gval[:, None, :]


# ---------------------------------------------------------------------------
# pieces of one step
# ---------------------------------------------------------------------------

def _forward_mv(op, data: MvData, Bm, Cm, sel_idx, sel_valid):
    Bsel = _take_b_multi(Bm, sel_idx, sel_valid)
    BX = op.forward_sel_multi(sel_idx, Bsel, sel_valid.to(Bm.dtype))
    CZ = torch.einsum("trq,nq->trn", Cm, data.z)
    return BX, CZ


def _resid(data: MvData, mu, cv_wts):
    """(Y - mu) * cv_wts (reference update_resid!,
    src/multivariate.jl:50-58)."""
    return (data.Y[None] - mu) * cv_wts[:, None, :]


def _solve_gamma(resid, nsamples):
    """Gamma = (R R' / nsamples + 1e-8 I)^-1 (reference solve_Σ!, :276-282,
    with the JAX package's ridge, which keeps a task whose trait residual
    is identically zero finite).  ``inv_ex`` checks no error, so there is
    no device-to-host sync."""
    RRt = torch.einsum("trn,tsn->trs", resid, resid)
    r = RRt.shape[-1]
    Sig = RRt / nsamples[:, None, None]
    Sig = Sig + 1e-8 * torch.eye(r, dtype=Sig.dtype, device=Sig.device)[None]
    return torch.linalg.inv_ex(Sig).inverse


def _loglik_mv(gamma, resid, nsamples):
    """n/2 logdet(Gamma) - 1/2 tr(Gamma R R') (reference :9-13); -inf
    where det(Gamma) <= 0."""
    sign, logdet = torch.linalg.slogdet(gamma)
    RRt = torch.einsum("trn,tsn->trs", resid, resid)
    tr = torch.einsum("trs,tsr->t", gamma, RRt)
    ld = torch.where(sign > 0, logdet, torch.full_like(logdet, -float("inf")))
    return nsamples / 2.0 * ld - 0.5 * tr


def _score_mv(op, data: MvData, gamma, resid):
    """df = (Gamma R) X', df2 = (Gamma R) Z' (reference score!, :66-70):
    one score pass at m = T·r."""
    GR = torch.einsum("trs,tsn->trn", gamma, resid)          # (T, r, n_pad)
    T, r, n_pad = GR.shape
    df = op.xtr(GR.reshape(T * r, n_pad)).reshape(T, r, -1)
    df2 = torch.einsum("trn,nq->trq", GR, data.z)
    return df, df2


def _stepsize_full(op, data: MvData, st: MIHTState):
    """eta = ||df_supp||_F^2 / ||U df_supp X||_F^2, U the upper Cholesky
    factor of Gamma (reference iht_stepsize!, src/multivariate.jl:220-254;
    the covariate terms left out as there).  ``cholesky_ex`` leaves finite
    values where Gamma is not positive definite, so U is set to NaN there
    (JAX's Cholesky returns NaN) and eta falls to the 1e-8 guard."""
    df_sel = _take_b_multi(st.df, st.sel_idx, st.sel_valid)
    numer = (df_sel * df_sel).sum(dim=(1, 2))
    dfX = op.forward_sel_multi(st.sel_idx, df_sel,
                               st.sel_valid.to(st.df.dtype))
    dfX = dfX * st.cv_wts[:, None, :]
    U, info = torch.linalg.cholesky_ex(st.Gamma, upper=True)
    U = torch.where((info != 0)[:, None, None],
                    torch.full_like(U, float("nan")), U)
    UdfX = torch.einsum("trs,tsn->trn", U, dfX)
    eta = numer / (UdfX * UdfX).sum(dim=(1, 2))
    bad = torch.isinf(eta) | torch.isnan(eta)
    return torch.where(bad, torch.full_like(eta, _GUARD), eta)


def _gradstep_mv(cfg: MvConfig, st: MIHTState, eta, zkeep):
    B1 = st.B0 + eta[:, None, None] * st.df
    C1 = st.C0 + eta[:, None, None] * st.df2
    B_new, C_new = _project_joint_mv(B1, C1, st.k + cfg.zkeepn, zkeep,
                                     cfg.S_entries)
    sel_idx, sel_valid = _column_support(B_new, cfg.S)
    return B_new, C_new, sel_idx, sel_valid, (C_new != 0).any(dim=1)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _mv_save_prev(st: MIHTState) -> MIHTState:
    """save_prev (reference src/multivariate.jl:356-367)."""
    act = st.active
    improved = act & (st.logl > st.best_logl)
    return dataclasses.replace(
        st,
        best_B=_where_t(improved, st.B, st.best_B),
        best_C=_where_t(improved, st.C, st.best_C),
        best_logl=torch.where(improved, st.logl, st.best_logl),
        B0=_where_t(act, st.B, st.B0), C0=_where_t(act, st.C, st.C0),
        Gamma0=_where_t(act, st.Gamma, st.Gamma0))


def _mv_take_step(op, data: MvData, cfg: MvConfig, st: MIHTState, eta_t,
                  nsamples):
    """One projected gradient step + model refresh at stepsize eta_t (the
    body of the backtracking line search)."""
    B, C, sel_idx, sel_valid, idc = _gradstep_mv(cfg, st, eta_t, data.zkeep)
    BX, CZ = _forward_mv(op, data, B, C, sel_idx, sel_valid)
    mu = BX + CZ
    resid = _resid(data, mu, st.cv_wts)
    gamma = _solve_gamma(resid, nsamples)
    logl = _loglik_mv(gamma, resid, nsamples)
    return dict(B=B, C=C, sel_idx=sel_idx, sel_valid=sel_valid, idc=idc,
                BX=BX, CZ=CZ, mu=mu, resid=resid, Gamma=gamma, logl=logl)


def _mv_bt_need(act, old_logl, cur, n_bt, max_step):
    return act & (old_logl > cur["logl"]) & (n_bt < max_step)


def _iteration_mv(op, data: MvData, cfg: MvConfig, st: MIHTState
                  ) -> MIHTState:
    """One mv IHT iteration with the backtracking loop on the host."""
    act = st.active
    nsamples = st.cv_wts.sum(dim=1)
    st = _mv_save_prev(st)
    eta = _stepsize_full(op, data, st)
    old_logl = st.logl
    cur = _mv_take_step(op, data, cfg, st, eta, nsamples)
    n_bt = torch.zeros_like(eta, dtype=torch.int64)
    while True:
        need = _mv_bt_need(act, old_logl, cur, n_bt, cfg.max_step)
        if not bool(need.any()):
            break
        eta = torch.where(need, eta / 2, eta)
        nxt = _mv_take_step(op, data, cfg, st, eta, nsamples)
        cur = {k: _where_t(need, nxt[k], cur[k]) for k in cur}
        n_bt = n_bt + need.to(torch.int64)
    return _mv_post_step(op, data, cfg, st, cur, eta, n_bt)


def _mv_post_step(op, data: MvData, cfg: MvConfig, st: MIHTState, cur, eta,
                  n_bt) -> MIHTState:
    """Accept the line-search result: score, NaN guard, convergence."""
    act = st.active
    new = dataclasses.replace(
        st, **{k: _where_t(act, cur[k], getattr(st, k)) for k in cur},
        eta=torch.where(act, eta, st.eta),
        backtracks=torch.where(act, n_bt, st.backtracks))

    df, df2 = _score_mv(op, data, new.Gamma, new.resid)
    new = dataclasses.replace(new, df=_where_t(act, df, new.df),
                              df2=_where_t(act, df2, new.df2))

    bad = act & (torch.isnan(new.logl) | torch.isinf(new.logl))
    it = new.iteration + 1
    dB = (new.B - new.B0).abs().amax(dim=(1, 2))
    dC = (new.C - new.C0).abs().amax(dim=(1, 2))
    denom = torch.maximum(new.B0.abs().amax(dim=(1, 2)),
                          new.C0.abs().amax(dim=(1, 2))) + 1.0
    scaled = torch.maximum(dB, dC) / denom
    done = act & (((it >= cfg.min_iter) & (scaled < cfg.tol)) | bad)
    return dataclasses.replace(
        new, active=act & ~done, failed=new.failed | bad,
        iters=torch.where(done, torch.full_like(new.iters, it), new.iters),
        iteration=it)


def run_mv_segment(op, data: MvData, cfg: MvConfig, st: MIHTState,
                   stop: int) -> MIHTState:
    """Advance until all tasks converge or ``stop`` iterations (at most
    max_iter - 1) have run.  Resumable."""
    limit = min(int(stop), cfg.max_iter - 1)
    while st.iteration < limit and bool(st.active.any()):
        st = _iteration_mv(op, data, cfg, st)
    return st


def finalize_mv_iht(op, data: MvData, cfg: MvConfig, st: MIHTState
                    ) -> MIHTState:
    """Count the last iterate, restore the best one and recompute its
    mean (reference save_best_model!, src/multivariate.jl:485-496)."""
    iters = torch.where(st.active, torch.full_like(st.iters, cfg.max_iter),
                        st.iters)
    improved = st.logl > st.best_logl
    best_B = _where_t(improved, st.B, st.best_B)
    best_C = _where_t(improved, st.C, st.best_C)
    sel_idx, sel_valid = _column_support(best_B, cfg.S)
    BX, CZ = _forward_mv(op, data, best_B, best_C, sel_idx, sel_valid)
    return dataclasses.replace(
        st, B=best_B, C=best_C, best_B=best_B, best_C=best_C,
        best_logl=torch.where(improved, st.logl, st.best_logl),
        iters=iters, active=torch.zeros_like(st.active), sel_idx=sel_idx,
        sel_valid=sel_valid, BX=BX, CZ=CZ, mu=BX + CZ,
        idc=(best_C != 0).any(dim=1))


def run_mv_iht(op, data: MvData, cfg: MvConfig, st: MIHTState,
               **segments) -> MIHTState:
    """Full solve: loop to completion (``univariate.run_segmented`` with
    its checkpoint and progress ``segments`` options), then restore the
    best model."""
    st = run_segmented(op, data, cfg, st, run_mv_segment, **segments)
    return finalize_mv_iht(op, data, cfg, st)


def fit_mv(op, data: MvData, cfg: MvConfig, ks, cv_wts,
           init_beta: bool = False, **segments):
    """init + solve; returns (state, Sigma = Gamma^-1 (T, r, r), per-trait
    PVE (T, r)) (the JAX package's ``fit_mv_fused``); ``segments`` as in
    :func:`run_mv_iht`."""
    st = init_mv_state(op, data, cfg, ks, cv_wts, init_beta=init_beta)
    st = run_mv_iht(op, data, cfg, st, **segments)
    Sigma = torch.linalg.inv_ex(st.Gamma).inverse
    vy = masked_var(data.Y, data.sample_mask, data.n_true)          # (r,)
    vm = masked_var(st.mu, data.sample_mask, data.n_true)           # (T, r)
    return st, Sigma, vm / vy[None]


def predict_mse_mv(data: MvData, st: MIHTState, test_wts):
    """sum_ij (Y - mu)^2 * wts_j per task (reference predict!,
    src/cross_validation.jl:288-299)."""
    d = data.Y[None] - st.mu
    return (d * d * test_wts[:, None, :]).sum(dim=(1, 2))


def cv_mv(op, data: MvData, cfg: MvConfig, ks, train_wts, test_wts,
          init_beta: bool = False, **segments):
    """init + solve + holdout mse of a batch of (fold, k) tasks;
    ``segments`` as in :func:`run_mv_iht` (checkpoints, the univariate
    cv's progress lines)."""
    st = init_mv_state(op, data, cfg, ks, train_wts, init_beta=init_beta)
    st = run_mv_iht(op, data, cfg, st, **segments)
    return predict_mse_mv(data, st, test_wts)


# ---------------------------------------------------------------------------
# init (reference init_iht_indices!, src/multivariate.jl:376-452)
# ---------------------------------------------------------------------------

def _initialize_beta_mv(op, data: MvData, cv_wts):
    """Per-(SNP, trait) univariate regressions (reference initialize_beta!,
    src/multivariate.jl:519-558): the univariate warm start of each trait,
    one ``PackedOp.col_moments`` pass (m = 2T, with S) a trait.  Returns
    (B (T, r, p), C (T, r, q))."""
    Bs, Cs = [], []
    for j in range(data.Y.shape[0]):
        trait = FitData(y=data.Y[j], z=data.z, zkeep=data.zkeep,
                        sample_mask=data.sample_mask, n_true=data.n_true)
        b, c = _initialize_beta(op, trait, cv_wts)
        Bs.append(b)
        Cs.append(c)
    return torch.stack(Bs, dim=1), torch.stack(Cs, dim=1)


def init_mv_state(op, data: MvData, cfg: MvConfig, k, cv_wts,
                  init_beta: bool = False) -> MIHTState:
    """Initial MIHTState for a batch of tasks: k (T,) per-task sparsity,
    cv_wts (T, n_pad) 0/1 training masks; ``init_beta`` starts from
    :func:`_initialize_beta_mv`."""
    dtype, device = op.dtype, op.device
    T = cv_wts.shape[0]
    r = data.Y.shape[0]
    p, q, n_pad = op.p, data.z.shape[1], op.n_pad
    k = torch.as_tensor(k, dtype=torch.int64, device=device).reshape(T)
    cv_wts = cv_wts.to(dtype)
    nsamples = cv_wts.sum(dim=1)
    kw = dict(dtype=dtype, device=device)

    Bm = torch.zeros((T, r, p), **kw)
    Cm = torch.zeros((T, r, q), **kw)
    # per-trait intercept = masked trait mean (reference :414-423)
    Cm[:, :, 0] = torch.einsum("rn,tn->tr", data.Y, cv_wts) / nsamples[:, None]
    Gamma = torch.eye(r, **kw)[None].repeat(T, 1, 1)
    st = MIHTState(
        B=Bm, C=Cm, B0=Bm, C0=Cm, best_B=Bm, best_C=Cm,
        Gamma=Gamma, Gamma0=Gamma,
        df=torch.zeros((T, r, p), **kw), df2=torch.zeros((T, r, q), **kw),
        sel_idx=torch.zeros((T, cfg.S), dtype=torch.int64, device=device),
        sel_valid=torch.zeros((T, cfg.S), dtype=torch.bool, device=device),
        idc=torch.zeros((T, q), dtype=torch.bool, device=device),
        BX=torch.zeros((T, r, n_pad), **kw),
        CZ=torch.zeros((T, r, n_pad), **kw),
        mu=torch.zeros((T, r, n_pad), **kw),
        resid=torch.zeros((T, r, n_pad), **kw),
        logl=torch.full((T,), -float("inf"), **kw),
        best_logl=torch.full((T,), -float("inf"), **kw),
        k=k, cv_wts=cv_wts,
        active=torch.ones((T,), dtype=torch.bool, device=device),
        failed=torch.zeros((T,), dtype=torch.bool, device=device),
        iters=torch.zeros((T,), dtype=torch.int64, device=device),
        eta=torch.zeros((T,), **kw),
        backtracks=torch.zeros((T,), dtype=torch.int64, device=device),
        iteration=0)

    if init_beta:
        Bm, Cm = _initialize_beta_mv(op, data, cv_wts)
        Bm, Cm = _project_joint_mv(Bm, Cm, k + cfg.zkeepn, data.zkeep,
                                   cfg.S_entries)
        sel_idx, sel_valid = _column_support(Bm, cfg.S)
        st = dataclasses.replace(st, B=Bm, C=Cm, B0=Bm, C0=Cm,
                                 sel_idx=sel_idx, sel_valid=sel_valid,
                                 idc=(Cm != 0).any(dim=1))

    BX, CZ = _forward_mv(op, data, st.B, st.C, st.sel_idx, st.sel_valid)
    mu = BX + CZ
    resid = _resid(data, mu, cv_wts)
    df, df2 = _score_mv(op, data, st.Gamma, resid)
    st = dataclasses.replace(st, BX=BX, CZ=CZ, mu=mu, resid=resid)
    if init_beta:
        return dataclasses.replace(st, df=df, df2=df2)
    # the initial support from the projected score (reference :436-445);
    # the projected score replaces df, so the first gradient step moves
    # only the selected entries
    df_p, df2_p = _project_joint_mv(df, df2, k + cfg.zkeepn, data.zkeep,
                                    cfg.S_entries)
    df2_p = torch.where(data.zkeep[None, None, :], df2, df2_p)
    sel_idx, sel_valid = _column_support(df_p, cfg.S)
    return dataclasses.replace(st, df=df_p, df2=df2_p, sel_idx=sel_idx,
                               sel_valid=sel_valid,
                               idc=(df2_p != 0).any(dim=1))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _prepare_mv(y, x, z, dtype):
    """Operator in ``dtype`` + zero-padded tensors in it: Y (r, n_pad), z
    (n_pad, q) from a (q, n) z (samples as columns), the sample mask
    (n_pad,)."""
    op = make_operator(x, dtype)
    n, n_pad = op.n, op.n_pad
    Y = np.asarray(y, np.float64)
    if Y.ndim != 2 or Y.shape[1] != n:
        raise ValueError(f"multivariate y must be (traits, n={n}); "
                         f"got {Y.shape}")
    r = Y.shape[0]
    if z is None:
        z = np.ones((1, n))
    z = np.asarray(z, np.float64)
    if z.ndim == 1:
        z = z[None, :]
    if z.shape[1] != n:
        raise ValueError(f"multivariate z must be (q, n={n}); got {z.shape}")
    Y_pad = np.zeros((r, n_pad))
    Y_pad[:, :n] = Y
    z_pad = np.zeros((n_pad, z.shape[0]))
    z_pad[:n] = z.T
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    kw = dict(dtype=op.dtype, device=op.device)
    return (op, torch.as_tensor(Y_pad, **kw), torch.as_tensor(z_pad, **kw),
            torch.as_tensor(mask, **kw))


def build_mv(y, x, z=None, *, k=10, zkeep=None, tol=1e-4, max_iter=200,
             min_iter=5, max_step=3, dtype=torch.float32):
    """Shared setup of the mv fit and cv: (op, data, cfg), in ``dtype``."""
    op, Y_pad, z_pad, mask = _prepare_mv(y, x, z, dtype)
    r, q = Y_pad.shape[0], z_pad.shape[1]
    if zkeep is None:
        zkeep_arr = np.ones(q, bool)
    else:
        zkeep_arr = np.asarray(zkeep, bool)
        if zkeep_arr.shape != (q,):
            raise ValueError(f"zkeep must have length {q}")
    zkeepn = r * int(zkeep_arr.sum())    # reference: r * sum(zkeep)
    k_max = int(np.max(k))
    S_entries = min(k_max + zkeepn + r * (q - int(zkeep_arr.sum())),
                    r * (op.p + q))
    S = min(k_max + q, op.p)             # at most k entries -> k columns
    data = MvData(Y=Y_pad, z=z_pad,
                  zkeep=torch.as_tensor(zkeep_arr, device=op.device),
                  sample_mask=mask, n_true=op.n)
    cfg = MvConfig(dist="mvnormal", link="identity", S=int(S), zkeepn=zkeepn,
                   max_iter=int(max_iter), min_iter=int(min_iter),
                   max_step=int(max_step), tol=float(tol),
                   S_entries=int(S_entries))
    return op, data, cfg


def fit_mv_iht(y, x, z=None, k=10, d=None, l=None, verbose=True, tol=1e-4,
               max_iter=200, min_iter=5, max_step=3, zkeep=None, io=None,
               init_beta=False, debias=False, dtype=torch.float32,
               checkpoint_dir=None, checkpoint_every=20):
    """Multivariate IHT fit (reference fit_iht with MvNormal,
    src/fit.jl:60), on the device of the genotypes.

    y (r, n) trait-major; x a PackedGenotypes (or a PackedOp) or a dense
    matrix (``fit.fit_iht``); z (q, n)
    with samples as columns, or None (intercept only).  ``d`` and ``l`` are
    taken and ignored (the model is MvNormal with the identity link).  As
    in the JAX package, a fit on a HostStreamedGenotypes saves its state
    to ``checkpoint_dir`` every ``checkpoint_every`` iterations and
    resumes from the newest one there, and a resident fit ignores both;
    ``dtype`` is float32 or float64 (``utils.device.float_dtype``)."""
    if int(np.min(k)) < 1:
        raise ValueError("Multivariate IHT requires k >= 1!")
    if debias:
        # reference multivariate.jl:570
        raise ValueError("Currently the debiasing routine for multivariate "
                         "IHT is broken, sorry!")
    dtype = float_dtype(dtype, "fit_iht")
    op, data, cfg = build_mv(y, x, z, k=k, zkeep=zkeep, tol=tol,
                             max_iter=max_iter, min_iter=min_iter,
                             max_step=max_step, dtype=dtype)
    if verbose:
        from ..utils.printing import print_iht_signature, print_parameters
        print_iht_signature(io)
        print_parameters(io, k, "mvnormal", "identity", False, None, debias,
                         tol, max_iter, min_iter, op.device)
    t0 = _time.time()
    st, Sigma, sigma_g = fit_mv(
        op, data, cfg, [int(k)], data.sample_mask[None, :],
        init_beta=init_beta, **streamed_segments(
            op, checkpoint_dir, checkpoint_every, verbose))
    B_h, C_h, logl_h, iters_h, failed_h, Sigma_h, sg_h = (
        t[0].cpu().numpy() for t in (st.B, st.C, st.best_logl, st.iters,
                                     st.failed, Sigma, sigma_g))
    tot = _time.time() - t0
    if bool(failed_h):
        raise FloatingPointError("Loglikelihood function is NaN/Inf, "
                                 "aborting...")
    result = MIHTResult(
        time=tot, logl=float(logl_h), iter=int(iters_h), beta=B_h, c=C_h,
        k=int(k), traits=data.Y.shape[0], Sigma=Sigma_h, sigma_g=sg_h)
    if verbose:
        print(result)
    return result


def cv_mv_iht(y, x, z=None, path=None, q=5, folds=None, zkeep=None,
              debias=False, verbose=True, max_iter=100, min_iter=5,
              init_beta=False, dtype=torch.float32, rng=None,
              checkpoint_dir=None, checkpoint_every=20, show_progress=False,
              task_chunk=None):
    """Multivariate cross validation (reference cv_iht with MvNormal,
    src/cross_validation.jl:60): the fold-size-weighted holdout mse per k
    of ``path``.

    The (fold, k) tasks run in chunks of ``task_chunk`` (exact: the tasks
    are independent), by default as many as take ~6 GB of state at 32
    (r, p) float32 arrays a task, the JAX package's budget.  ``debias`` is
    taken and ignored, as in the JAX package; ``show_progress`` prints the
    converged-task count every 5 iterations to stderr.  With
    ``checkpoint_dir`` each chunk saves its state every
    ``checkpoint_every`` iterations and resumes from the newest one, in
    ``checkpoint_dir`` itself where the tasks make one chunk, else in
    ``{checkpoint_dir}/chunk{lo}`` for the chunk from task ``lo`` on, as
    in the JAX package.  ``dtype`` is float32 or float64."""
    dtype = float_dtype(dtype, "cv_iht")
    from .cv import _task_masks, meanloss
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg = build_mv(y, x, z, k=max(path), zkeep=zkeep,
                             max_iter=max_iter, min_iter=min_iter,
                             dtype=dtype)
    if max(path) > op.p * data.Y.shape[0]:
        raise ValueError("Sparsity level in `path` cannot be larger than "
                         "total number of variables")
    folds, ks, train, test = _task_masks(op, q, path, folds, rng)
    T = int(ks.shape[0])
    if task_chunk is None:
        per_task = 32.0 * data.Y.shape[0] * op.p * 4.0
        task_chunk = max(1, int(6e9 / max(per_task, 1.0)))
    parts = []
    for lo in range(0, T, task_chunk):
        hi = min(lo + task_chunk, T)
        if verbose and task_chunk < T:
            print(f"cv tasks {lo + 1}-{hi} of {T}...")
        ckpt = checkpoint_dir
        if ckpt is not None and task_chunk < T:
            ckpt = os.path.join(ckpt, f"chunk{lo}")
        parts.append(cv_mv(op, data, cfg, ks[lo:hi], train[lo:hi],
                           test[lo:hi], init_beta=init_beta,
                           checkpoint_dir=ckpt,
                           checkpoint_every=checkpoint_every,
                           progress=show_progress,
                           verbose=verbose).cpu().numpy())
    mse = meanloss(np.concatenate(parts), q, folds)
    best_k = path[int(np.argmin(mse))]
    if verbose:
        print_cv_results(sys.stdout, mse, path, best_k)
    return mse

