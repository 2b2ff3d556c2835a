"""Parity of the port's multivariate (MvNormal) IHT and ``compat.py`` with
the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through both packages; the JAX
side runs its XLA path (tests/conftest.py).  Responses come from the JAX
package's ``simulate_random_multivariate_response`` with shared causal
SNPs, so the effects differ in magnitude and the top-k has no ties
(torch.topk and the JAX package's ``fast_top_k`` order ties differently;
supports are compared as sets of (trait, SNP)).

Tolerances.  The forward products, the score and the warm start within
1e-5 of their scale (f32 sums in another order); the projections exactly;
Gamma, the loglikelihood and the stepsize within 1e-5 relative, the
non-positive-definite Gamma's stepsize exactly the 1e-8 guard in both.
One iteration from the JAX package's state within 1e-5 of each array's
scale.  Whole fits, against the JAX package's host-stepped solver
(``mv_streamed``, which the port's loop follows) and its public
``fit_iht``: the same support, iterations within one, logl within 1e-5
relative, and B, C, Sigma and the per-trait PVE within ``MV_SPREAD``
(5e-4) of their max|.|, since loglikelihood ties at the end of a fit decide
its last steps (ROADMAP Queue 3).  Cross
validations: mse within 1e-4 relative, the same best k; chunked task
batches within 1e-4 of one batch (another batch width sums the score in
another order, and a task may end on a loglikelihood tie an iteration
apart, as the JAX package's own chunking test allows); ``show_progress``
equal to the plain run bit for bit.  The simulator draw for draw within
1e-12; ``compat.py`` within 1e-5 relative (f32), its files' k column
exactly.
"""

import contextlib
import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import mv as jmv
from mendeliht_tpu.models import mv_streamed as jmvs
from mendeliht_tpu.ops import decode as jdecode
from mendeliht_tpu.ops import glm as jglm
from mendeliht_tpu.ops import linalg as jlinalg

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import mv as tmv
from mendeliht_tpu_torch.ops import decode as tdecode
from mendeliht_tpu_torch.ops import linalg as tlinalg

N, P = 300, 600
K = 10


def _port(g):
    """The port's PackedGenotypes holding the JAX package's arrays."""
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=1e-5, scale=None):
    """Within tol of ``scale``, by default max|want|."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    if scale is None:
        scale = max(np.abs(want).max(), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, \
        np.max(np.abs(got - want)) / scale


def _entries(beta):
    """The support of an (r, p) beta as a set of (trait, SNP)."""
    return set(zip(*map(list, np.nonzero(_np(beta)))))


def _run(fn, *args, **kwargs):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*args, **kwargs)
    return res, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's many small ops, restored
    after it.  Where other test processes keep every core busy, the
    default thread pool oversubscribes the cores and each small op waits on
    it: the chunked cv test took 386 s on a fully loaded 8-core host with
    the default pool and 9 s with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geno():
    """Genotypes with missing calls (the forward products' M term)."""
    rng = np.random.default_rng(81)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(N, P),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    return g, _port(g)


@pytest.fixture(scope="module")
def sims(geno):
    """{r: (Y (r, n), true_b)} for r = 2 and 3, two causal SNPs shared by
    every trait."""
    g, _ = geno
    out = {}
    for r in (2, 3):
        Y, _, true_b, _ = m.simulate_random_multivariate_response(
            g, K, r, overlap=2, rng=np.random.default_rng(90 + r))
        out[r] = (np.ascontiguousarray(Y.T), true_b)
    return out


@pytest.fixture(scope="module")
def cov():
    rng = np.random.default_rng(83)
    return np.vstack([np.ones(N), rng.standard_normal(N)])      # (q, n)


# -- the forward products ----------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
def test_forward_sel_multi_matches_jax(missing):
    rng = np.random.default_rng(84)
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(150, 90), p=probs)
    g = m.PackedGenotypes.from_codes(codes)
    t = _port(g)
    assert t.has_missing == missing
    T, r, S = 3, 2, 7
    idx = rng.integers(0, 90, size=(T, S))
    coef = rng.standard_normal((T, r, S)).astype(np.float32)
    valid = (rng.random((T, S)) < 0.7).astype(np.float32)
    mu = np.asarray(g.mu)
    want = jdecode.sparse_forward_raw_multi(
        g.packed, jnp.asarray(idx), jnp.asarray(coef), jnp.asarray(mu),
        want_missing=missing)
    got = tdecode.sparse_forward_raw_multi(
        t.words, torch.from_numpy(idx), torch.from_numpy(coef), t.mu,
        want_missing=missing)
    _close(got, want)
    want = jlinalg.make_operator(g).forward_sel_multi(
        jnp.asarray(idx), jnp.asarray(coef), jnp.asarray(valid))
    got = tlinalg.make_operator(t).forward_sel_multi(
        torch.from_numpy(idx), torch.from_numpy(coef),
        torch.from_numpy(valid))
    _close(got, want)
    # each trait's row equals the univariate product of its coefficients
    one = tlinalg.make_operator(t).forward_sel(
        torch.from_numpy(idx), torch.from_numpy(coef[:, 1]),
        torch.from_numpy(valid))
    _close(got[:, 1], one)


# -- projections --------------------------------------------------------------

def test_project_joint_mv_and_column_support_match_jax():
    """Distinct magnitudes; per-task k; one covariate pinned: the same
    entries, exactly."""
    rng = np.random.default_rng(85)
    T, r, p, q = 4, 3, 50, 2
    B = rng.permutation(T * r * p).reshape(T, r, p).astype(np.float32) - 300
    C = rng.standard_normal((T, r, q)).astype(np.float32)
    k = np.array([1, 4, 9, 0])
    zkeep = np.array([True, False])
    zkeepn = r * int(zkeep.sum())
    S_entries = int(k.max()) + zkeepn + r
    Bj, Cj = jmv._project_joint_mv(jnp.asarray(B), jnp.asarray(C),
                                   jnp.asarray(k + zkeepn),
                                   jnp.asarray(zkeep), S_entries)
    Bt, Ct = tmv._project_joint_mv(torch.from_numpy(B), torch.from_numpy(C),
                                   torch.from_numpy(k + zkeepn),
                                   torch.from_numpy(zkeep), S_entries)
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    S = 6
    ij, vj = jmv._column_support(Bj, S)
    it, vt = tmv._column_support(Bt, S)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for b in range(T):
        assert set(it[b].numpy()[vt[b].numpy()]) == \
            set(np.asarray(ij[b])[np.asarray(vj[b])])
    full = tmv._flatten_bc(torch.from_numpy(B), torch.from_numpy(C))
    Bu, Cu = tmv._unflatten_bc(full, r, p, q)
    assert torch.equal(Bu, torch.from_numpy(B))
    assert torch.equal(Cu, torch.from_numpy(C))


# -- Gamma, the loglikelihood, the stepsize ----------------------------------

def _state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _setups(g, t, Y, z=None, **kw):
    jop, jdata, jcfg = jmv.build_mv(Y, g, z, **kw)
    op, data, cfg = tmv.build_mv(Y, t, z, **kw)
    assert (cfg.S, cfg.S_entries, cfg.zkeepn) == (jcfg.S, jcfg.S_entries,
                                                  jcfg.zkeepn)
    return (jop, jdata, jcfg), (op, data, cfg)


def test_solve_gamma_loglik_and_stepsize_match_jax(geno, sims):
    g, t = geno
    Y, _ = sims[3]
    rng = np.random.default_rng(86)
    resid = rng.standard_normal((2, 3, 320)).astype(np.float32)
    ns = np.array([300.0, 200.0], np.float32)
    gj = jmv._solve_gamma(jnp.asarray(resid), jnp.asarray(ns))
    gt = tmv._solve_gamma(torch.from_numpy(resid), torch.from_numpy(ns))
    _close(gt, gj)
    _close(tmv._loglik_mv(gt, torch.from_numpy(resid), torch.from_numpy(ns)),
           jmv._loglik_mv(gj, jnp.asarray(resid), jnp.asarray(ns)))
    # det(Gamma) <= 0 gives -inf in both
    neg = np.array([[[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]]] * 2,
                   np.float32)
    assert np.all(np.isneginf(np.asarray(jmv._loglik_mv(
        jnp.asarray(neg), jnp.asarray(resid), jnp.asarray(ns)))))
    assert torch.isneginf(tmv._loglik_mv(
        torch.from_numpy(neg), torch.from_numpy(resid),
        torch.from_numpy(ns))).all()

    (jop, jdata, jcfg), (op, data, cfg) = _setups(g, t, Y, k=K)
    cw = jnp.broadcast_to(jdata.sample_mask[None, :], (2, jop.n_pad))
    sj = jmv.init_mv_state(jop, jdata, jcfg, jnp.asarray([K, 4]), cw)
    arrays = _state_numpy(sj)
    gamma = np.asarray(sj.Gamma).copy()
    gamma[1] = neg[0]          # not positive definite: the 1e-8 guard
    gamma[0] = gamma[0] + 0.3 * np.eye(3, dtype=np.float32)
    arrays["Gamma"] = gamma
    sj = dataclasses.replace(sj, Gamma=jnp.asarray(gamma))
    st = tmv.MIHTState.from_numpy(arrays, "cpu")
    ej = np.asarray(jmv._stepsize_full(jop, jdata, sj))
    et = tmv._stepsize_full(op, data, st).numpy()
    assert et[1] == ej[1] == np.float32(1e-8)
    np.testing.assert_allclose(et[0], ej[0], rtol=1e-5)
    assert ej[0] != np.float32(1e-8)


# -- init and one iteration ---------------------------------------------------

@pytest.mark.parametrize("init_beta", [False, True])
def test_init_mv_state_matches_jax(geno, sims, cov, init_beta):
    g, t = geno
    Y, _ = sims[2]
    kw = dict(k=6, zkeep=[True, False])
    (jop, jdata, jcfg), (op, data, cfg) = _setups(g, t, Y, cov, **kw)
    folds = np.tile([1, 2], N // 2)
    train = np.zeros((2, op.n_pad), np.float32)
    for i in range(2):
        train[i, :N] = folds != i + 1
    ks = np.array([6, 3])
    sj = jmv.init_mv_state(jop, jdata, jcfg, jnp.asarray(ks),
                           jnp.asarray(train), init_beta=init_beta)
    st = tmv.init_mv_state(op, data, cfg, torch.from_numpy(ks),
                           torch.from_numpy(train), init_beta=init_beta)
    for name in ("B", "C", "B0", "C0", "df", "BX", "CZ", "mu", "resid",
                 "Gamma"):
        _close(getattr(st, name), getattr(sj, name))
    # the intercept's score is a sum that cancels to f32 roundings: held
    # at the genetic score's scale
    _close(st.df2, sj.df2, scale=np.abs(np.asarray(sj.df)).max())
    np.testing.assert_array_equal(st.idc.numpy(), np.asarray(sj.idc))
    for b in range(2):
        vt, vj = st.sel_valid[b].numpy(), np.asarray(sj.sel_valid[b])
        assert set(st.sel_idx[b].numpy()[vt]) == \
            set(np.asarray(sj.sel_idx[b])[vj])
        want = _entries(np.asarray(sj.B[b] if init_beta else sj.df[b]))
        got = _entries(st.B[b] if init_beta else st.df[b])
        assert got == want


def test_iteration_from_jax_state(geno, sims, cov):
    """The first iteration from the JAX package's initial state against
    its host-stepped iteration (``mv_streamed._iteration_mv_host``)."""
    g, t = geno
    Y, _ = sims[3]
    (jop, jdata, jcfg), (op, data, cfg) = _setups(g, t, Y, cov, k=K,
                                                  zkeep=[True, False])
    cw = jnp.broadcast_to(jdata.sample_mask[None, :], (1, jop.n_pad))
    sj = jmv.init_mv_state(jop, jdata, jcfg, jnp.asarray([K]), cw)
    st = tmv.MIHTState.from_numpy(_state_numpy(sj), "cpu")
    sj1 = jmvs._iteration_mv_host(jop, jdata, jcfg, sj)
    st1 = tmv._iteration_mv(op, data, cfg, st)
    assert st1.iteration == int(sj1.iteration) == 1
    assert int(st1.backtracks[0]) == int(sj1.backtracks[0])
    assert bool(st1.active[0]) == bool(sj1.active[0])
    assert _entries(st1.B[0]) == _entries(np.asarray(sj1.B[0]))
    for name in ("B", "C", "Gamma", "df", "mu", "eta", "logl", "B0"):
        _close(getattr(st1, name), getattr(sj1, name))
    _close(st1.df2, sj1.df2, scale=np.abs(np.asarray(sj1.df)).max())
    # the initial state's -inf loglikelihood is the best so far in both
    assert torch.isneginf(st1.best_logl).all()
    assert np.all(np.isneginf(np.asarray(sj1.best_logl)))


# -- whole fits ---------------------------------------------------------------

FIT_CASES = {"r2": (2, {}), "r3": (3, {}),
             "r3-zkeep": (3, dict(zkeep=[True, False], z=True)),
             "r2-init_beta": (2, dict(init_beta=True))}


# a fit ends on a loglikelihood plateau, where successive iterates' f32
# loglikelihoods differ by a rounding or two (about 6e-5 at |logl| ~ 900):
# such ties decide the last backtracks and the stop, so the two packages
# may end an iteration apart (measured: B 2.5e-4, the PVE 3.0e-4 of their
# max, Sigma 5e-6), though one iteration from the same state agrees to 1e-5
MV_SPREAD = 5e-4


def _jax_host_fit(Y, g, z, k, zkeep=None, init_beta=False):
    """The JAX package's mv fit through its host-stepped solver:
    (B, C, logl, iters, Sigma, sigma_g)."""
    op, data, cfg = jmv.build_mv(Y, g, z, k=k, zkeep=zkeep)
    cw = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    st, Sigma, pve = jmvs.fit_mv_host(op, data, cfg, jnp.asarray([k]), cw,
                                      init_beta=init_beta)
    return (np.asarray(st.B[0]), np.asarray(st.C[0]),
            float(st.best_logl[0]), int(st.iters[0]), np.asarray(Sigma[0]),
            np.asarray(pve[0]))


def _assert_mv_fits_agree(rt, want):
    B, C, logl, iters, Sigma, sg = want
    assert _entries(rt.beta) == _entries(B)
    assert abs(rt.iter - iters) <= 1
    for got, want in ((rt.beta, B), (rt.c, C), (rt.Sigma, Sigma),
                      (rt.sigma_g, sg)):
        _close(got, want, MV_SPREAD)
    assert rt.logl == pytest.approx(logl, rel=1e-5)


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_matches_jax(geno, sims, cov, case):
    g, t = geno
    r, kw = FIT_CASES[case]
    kw = dict(kw)
    Y, true_b = sims[r]
    z = cov if kw.pop("z", False) else None
    rt = mt.fit_iht(Y, t, z, k=K, d=mt.MvNormal(), verbose=False, **kw)
    assert isinstance(rt, mt.MIHTResult) and rt.traits == r
    assert rt.beta.shape == (r, P) and rt.Sigma.shape == (r, r)
    _assert_mv_fits_agree(rt, _jax_host_fit(Y, g, z, K, **kw))
    rj = m.fit_iht(Y, g, z, k=K, d=m.MvNormal(), verbose=False, **kw)
    _assert_mv_fits_agree(rt, (rj.beta, rj.c, rj.logl, rj.iter, rj.Sigma,
                               rj.sigma_g))
    if "zkeep" in kw:
        assert np.all(rt.c[:, 0] != 0)
        assert int((rt.beta != 0).sum() + (rt.c[:, 1] != 0).sum()) <= K
    else:
        assert int((rt.beta != 0).sum()) == K
    # the large shared effects are found
    big = _entries(np.abs(true_b.T) > 0.5)
    assert len(big & _entries(rt.beta)) >= len(big) - 1


def test_fit_verbose_output_matches_jax(geno, sims):
    g, t = geno
    Y, _ = sims[2]
    rt, out_t, _ = _run(mt.fit_iht, Y, t, k=4, d=mt.MvNormal())
    rj, out_j, _ = _run(m.fit_iht, Y, g, k=4, d=m.MvNormal())
    head = lambda s: [ln for ln in s.splitlines()              # noqa: E731
                      if " = " in ln and not ln.startswith("Backend")]
    assert head(out_t) == head(out_j)
    assert "Running sparse Multivariate Gaussian regression" in out_t
    assert "Backend = torch cpu" in out_t
    assert str(rt) in out_t
    body = lambda s: s[s.index("Trait 1: IHT"):]               # noqa: E731
    assert body(out_t).splitlines()[:3] == body(out_j).splitlines()[:3]


def test_miht_result_text_matches_jax():
    rng = np.random.default_rng(87)
    beta = np.zeros((2, 30), np.float32)
    beta[0, [3, 17]] = [0.5, -1.25]
    beta[1, 8] = 2.0
    kw = dict(time=1.5, logl=-123.25, iter=7, beta=beta,
              c=np.array([[0.1], [0.0]], np.float32), k=3, traits=2,
              Sigma=rng.standard_normal((2, 2)),
              sigma_g=np.array([0.25, 0.5], np.float32))
    assert str(mt.MIHTResult(**kw)) == str(m.MIHTResult(**kw))
    assert repr(mt.MIHTResult(**kw)) == repr(m.MIHTResult(**kw))


# -- cross validation ---------------------------------------------------------

CV_PATH = [2, 4, 6, 8, 10, 12]


@pytest.mark.parametrize("case", ["plain", "init_beta-zkeep"])
def test_cv_matches_jax(geno, sims, cov, case):
    g, t = geno
    Y, _ = sims[2]
    folds = np.random.default_rng(88).integers(1, 4, size=N)
    kw = dict(path=CV_PATH, q=3, folds=folds, verbose=False)
    z = None
    if case != "plain":
        kw.update(init_beta=True, zkeep=[True, False])
        z = cov
    want = m.cv_iht(Y, g, z, d=m.MvNormal(), **kw)
    got = mt.cv_iht(Y, t, z, d=mt.MvNormal(), **kw)
    assert got.shape == (len(CV_PATH),) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_cv_chunked_progress_and_debias(geno, sims, capsys):
    g, t = geno
    Y, _ = sims[3]
    folds = np.random.default_rng(89).integers(1, 3, size=N)
    kw = dict(path=[2, 6, 10, 14], q=2, folds=folds, verbose=False)
    whole = tmv.cv_mv_iht(Y, t, **kw)
    np.testing.assert_allclose(tmv.cv_mv_iht(Y, t, task_chunk=3, **kw),
                               whole, rtol=1e-4)
    capsys.readouterr()
    np.testing.assert_array_equal(
        mt.cv_iht(Y, t, show_progress=True, **kw), whole)
    err = capsys.readouterr().err
    assert "Cross-validating: iteration" in err and "8/8 models" in err
    # debias is taken and ignored, as in the JAX package
    np.testing.assert_array_equal(mt.cv_iht(Y, t, debias=True, **kw), whole)
    # verbose: the chunk lines and the JAX package's cv table
    got, out_t, _ = _run(tmv.cv_mv_iht, Y, t, task_chunk=5,
                         **{**kw, "verbose": True})
    want, out_j, _ = _run(jmv.cv_mv_iht, Y, g, task_chunk=5,
                          **{**kw, "verbose": True})
    np.testing.assert_allclose(got, want, rtol=1e-4)
    lines = lambda s: [ln.split("\t")[:2] for ln in s.splitlines()]  # noqa
    assert lines(out_t) == lines(out_j)
    assert "cv tasks 6-8 of 8..." in out_t


def test_default_task_chunk_is_the_jax_budget(geno, sims, monkeypatch):
    """6e9 / (32 r p 4) tasks a chunk: at r = 3, p = 1M, 15 (two chunks of
    the UKBB protocol's 30 tasks); here, with p scaled down, every task in
    one chunk but where the budget is shrunk."""
    _, t = geno
    Y, _ = sims[3]
    seen = []
    real = tmv.cv_mv

    def record(op, data, cfg, ks, *args, **kwargs):
        seen.append(int(ks.shape[0]))
        return real(op, data, cfg, ks, *args, **kwargs)

    monkeypatch.setattr(tmv, "cv_mv", record)
    folds = np.tile([1, 2], N // 2)
    tmv.cv_mv_iht(Y, t, path=[2, 4, 6], q=2, folds=folds, verbose=False)
    assert seen == [6]
    assert int(6e9 / (32.0 * 3 * 1_000_000 * 4.0)) == 15


# -- the simulator ------------------------------------------------------------

@pytest.mark.parametrize("traits,overlap", [(2, 2), (3, 1), (4, 0)])
def test_simulator_matches_jax(geno, traits, overlap):
    g, t = geno
    for r in (2, 5):
        np.testing.assert_allclose(
            mt.random_covariance_matrix(r, rng=np.random.default_rng(r)),
            m.random_covariance_matrix(r, rng=np.random.default_rng(r)),
            rtol=0, atol=1e-12)
    Zu = np.random.default_rng(3).standard_normal((N, traits))
    kw = dict(k=8, traits=traits, overlap=overlap, Zu=Zu)
    Yt, St, bt, pt = mt.simulate_random_multivariate_response(
        t, rng=np.random.default_rng(4), **kw)
    Yj, Sj, bj, pj = m.simulate_random_multivariate_response(
        g, rng=np.random.default_rng(4), **kw)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-12)
    noise = lambda Y, b: Y - g.to_dense_standardized() @ b - Zu  # noqa: E731
    np.testing.assert_allclose(noise(Yt, bt), noise(Yj, bj), rtol=0,
                               atol=1e-12)
    if overlap:
        np.testing.assert_allclose(Yt, Yj, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(pt, pj)
        return
    # overlap = 0: the port keeps the effects that the JAX package draws
    # and drops (ROADMAP Queue 3), at the draws' column-major positions
    assert not bj.any() and len(pj) == 0
    rng = np.random.default_rng(4)
    where = rng.choice(traits * P, size=8, replace=False)
    np.testing.assert_array_equal(bt.ravel(order="F")[where],
                                  rng.standard_normal(8))
    assert len(pt) == 8 and np.count_nonzero(bt) == 8
    with pytest.raises(ValueError, match="overlap"):
        mt.simulate_random_multivariate_response(t, 3, 2, overlap=2)


# -- the errors ---------------------------------------------------------------

@pytest.mark.parametrize("call,kwargs", [
    ("fit", dict(k=0)), ("fit", dict(debias=True)),
    ("fit", dict(y="short")), ("fit", dict(z="short")),
    ("fit", dict(zkeep=[True, False])), ("cv", dict(path=[1, 2 * P + 1])),
    ("cv", dict(y="short"))])
def test_errors_match_jax(geno, sims, call, kwargs):
    g, t = geno
    Y, _ = sims[2]
    kwargs = dict(kwargs)
    if kwargs.pop("y", None):
        Y = Y[:, :-1]
    z = np.ones((1, N - 1)) if kwargs.pop("z", None) else None
    fn_j, fn_t = ((m.fit_iht, mt.fit_iht) if call == "fit"
                  else (m.cv_iht, mt.cv_iht))
    kw = dict(d=m.MvNormal(), verbose=False, **kwargs)
    if call == "fit":
        kw.setdefault("k", 3)
    else:
        kw.update(q=2, folds=np.tile([1, 2], N // 2))
    with pytest.raises(ValueError) as ej:
        fn_j(Y, g, z, **kw)
    with pytest.raises(ValueError) as et:
        fn_t(Y, t, z, **kw)
    assert str(et.value) == str(ej.value)


def test_unported_inputs_raise(geno, sims, tmp_path):
    g, t = geno
    Y, _ = sims[2]
    # a checkpoint_dir raised NotImplementedError naming item 12 before
    # checkpointing was ported: now the JAX package's checkpointed mv cv,
    # and a resumed run equal to the plain one bit for bit
    kw = dict(path=[1], q=2, folds=np.tile([1, 2], N // 2), verbose=False,
              max_iter=10)
    ck = str(tmp_path / "mvck")
    got = mt.cv_iht(Y, t, checkpoint_dir=ck, checkpoint_every=3, **kw)
    np.testing.assert_allclose(
        got, m.cv_iht(Y, g, checkpoint_dir=str(tmp_path / "jax"),
                      checkpoint_every=3, **kw), rtol=1e-4)
    assert sorted(os.listdir(ck)) == ["step_6", "step_9"]
    np.testing.assert_array_equal(
        mt.cv_iht(Y, t, checkpoint_dir=ck, checkpoint_every=3, **kw), got)
    np.testing.assert_array_equal(mt.cv_iht(Y, t, **kw), got)
    ck_dir = tmp_path / "mvck"
    # a dense x raised NotImplementedError before DenseOp was ported: now
    # the JAX package's multivariate fit on the same matrix
    X = g.to_dense_standardized()
    a = mt.fit_iht(Y, torch.from_numpy(X), k=3, verbose=False)
    b = m.fit_iht(Y, X, k=3, verbose=False)
    assert _entries(a.beta) == _entries(b.beta)
    assert abs(a.iter - b.iter) <= 1
    for got, want in ((a.beta, b.beta), (a.Sigma, b.Sigma)):
        _close(got, want, tol=MV_SPREAD)
    # another design matrix type raised NotImplementedError naming item 13
    # before the streamed genotypes were ported: now the JAX package's
    # TypeError
    with pytest.raises(TypeError, match="unsupported design matrix type"):
        mt.cv_iht(Y, object(), path=[1], q=2, verbose=False)
    # a float64 dtype raised NotImplementedError before float64 fits were
    # ported: now the fit and the cv run in float64; bfloat16 and None
    # still raise
    r64 = mt.fit_iht(Y, t, k=3, verbose=False, dtype=np.float64)
    assert r64.beta.dtype == r64.Sigma.dtype == np.float64
    assert _entries(r64.beta) == _entries(mt.fit_iht(Y, t, k=3,
                                                     verbose=False).beta)
    mse = mt.cv_iht(Y, t, path=[1, 3], q=2, folds=np.tile([1, 2], N // 2),
                    verbose=False, dtype=np.float64)
    assert mse.dtype == np.float64 and np.isfinite(mse).all()
    for fn in (mt.fit_iht, mt.cv_iht):
        for bad in (jnp.bfloat16, None):
            with pytest.raises(NotImplementedError,
                               match="float32 or float64 only"):
                fn(Y, t, verbose=False, dtype=bad)
    # the resident fit takes checkpoint_dir and ignores it, as the JAX
    # package's resident fit does; nothing is written
    a = mt.fit_iht(Y, t, k=3, verbose=False,
                   checkpoint_dir=str(tmp_path / "fit"))
    b = mt.fit_iht(Y, t, k=3, verbose=False)
    np.testing.assert_array_equal(a.beta, b.beta)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax", ck_dir.name]


# -- compat.py ----------------------------------------------------------------

COMPAT_FAMILIES = [("Normal", "IdentityLink"), ("Bernoulli", "LogitLink"),
                   ("Poisson", "LogLink"), ("Gamma", "LogLink"),
                   ("NegativeBinomial", "LogLink")]


@pytest.mark.parametrize("family,link", COMPAT_FAMILIES)
def test_compat_glm_functions_match_jax(family, link):
    rng = np.random.default_rng(91)
    n = 200
    eta = 0.3 * rng.standard_normal(n)
    mu = np.asarray(jglm.linkinv(link.replace("Link", "").lower(),
                                      jnp.asarray(eta)), np.float64)
    y = {"Normal": lambda: mu + rng.standard_normal(n),
         "Bernoulli": lambda: (rng.random(n) < mu).astype(float),
         "Poisson": lambda: rng.poisson(mu).astype(float),
         "Gamma": lambda: rng.gamma(2.0, mu / 2.0),
         "NegativeBinomial": lambda: rng.poisson(mu).astype(float)}[family]()
    wts = (rng.random(n) < 0.8).astype(float)
    dj, dt = getattr(m, family)(), getattr(mt, family)()
    lj, lt = getattr(m, link)(), getattr(mt, link)()
    for w in (None, wts):
        assert mt.loglikelihood(dt, y, mu, w) == pytest.approx(
            m.loglikelihood(dj, y, mu, w), rel=1e-5)
        assert mt.deviance(dt, y, mu, w) == pytest.approx(
            m.deviance(dj, y, mu, w), rel=1e-5)
        _close(mt.score(dt, lt, y, mu, eta, w),
               m.score(dj, lj, y, mu, eta, w))


@pytest.mark.parametrize("est_r", ["MM", "Newton", ":newton"])
def test_compat_mle_for_r_matches_jax(est_r):
    rng = np.random.default_rng(92)
    mu = np.exp(0.5 * rng.standard_normal(300))
    y = rng.negative_binomial(3.0, 3.0 / (3.0 + mu)).astype(float)
    assert mt.mle_for_r(y, mu, 1.5, est_r) == pytest.approx(
        m.mle_for_r(y, mu, 1.5, est_r), rel=1e-4)
    with pytest.raises(ValueError, match="est_r"):
        mt.mle_for_r(y, mu, 1.0, "bisection")


def test_compat_initialize_beta_matches_jax(geno, sims, cov):
    g, t = geno
    y = sims[2][0][0]
    for z in (None, cov.T):
        bj, cj = m.initialize_beta(y, g, z)
        bt, ct = mt.initialize_beta(y, t, z)
        _close(bt, bj)
        _close(ct, cj)


def test_compat_cv_iht_distribute_fold_matches_jax(geno, sims, tmp_path):
    g, t = geno
    y = sims[2][0][1]
    folds = np.tile([1, 2, 3], N // 3)
    path = [1, 3, 5]
    kw = dict(folds=folds, max_iter=50)
    want = m.cv_iht_distribute_fold(m.Normal(), None, g, None, y, 1, path, 3,
                                    destin=str(tmp_path / "jax"), **kw)
    got = mt.cv_iht_distribute_fold(mt.Normal(), None, t, None, y, 1, path,
                                    3, destin=str(tmp_path / "port"), **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, mt.cv_iht(y, t, path=path, q=3,
                                              verbose=False, **kw),
                               rtol=1e-6)
    for i in (1, 2, 3):
        ft = np.loadtxt(tmp_path / "port" / f"cviht_fold{i}.txt", skiprows=1)
        fj = np.loadtxt(tmp_path / "jax" / f"cviht_fold{i}.txt", skiprows=1)
        assert (tmp_path / "port" / f"cviht_fold{i}.txt").read_text() \
            .startswith("k\tmse\n")
        np.testing.assert_array_equal(ft[:, 0], fj[:, 0])
        np.testing.assert_allclose(ft[:, 1], fj[:, 1], rtol=1e-4)
