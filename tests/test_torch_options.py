"""Parity of the port's univariate fit options with the JAX package, on the
CPU: ``init_beta`` (``PackedOp.col_moments`` and ``_initialize_beta``),
``debias`` (``gather_cols`` and ``debias_refit``), the group projections
with ``J`` and a vector ``k``, ``weight`` (``maf`` and ``maf_weights``),
``zkeep``, the teed lines of ``io``, ``use_maf`` and the public helpers.

Both packages get the same genotype words, responses and covariates as
numpy, made from seeds; the JAX side runs its XLA path (tests/conftest.py).

Tolerances.  The column moments and the warm start within 1e-5 of their
scale (f32 sums in another order); the debias refit from one JAX state
within 1e-5 of max|beta|; the projections on inputs without ties, and
``maf`` / ``maf_weights``, exactly.  Whole Gaussian fits as
tests/test_torch_fit.py holds them: the same support and iterations, betas
within 1e-4 of max|beta|, logl within 1e-4 relative.  The port steps its
solver from the host, so ``init_beta`` and group fits, which backtrack on
loglikelihood ties near their end, are held to the JAX package's
host-stepped driver (``streamed.fit_fused_sparse_host``): its fused driver
stops the ``group-vector-k`` fit an iteration earlier (6 and 7) and ends
the ``init_beta`` fit of ``sim`` 1.5e-4 of max|beta| from the host-stepped
one.  ``init_beta`` fits then agree to the f32 tolerances above; group
fits in support and iterations, with betas and c within ``GROUP_SPREAD``
of max|beta| (the ``group-vector-k`` fit's last steps leave 2.6e-4 between
them, c 5e-4, though one iteration from the same state agrees to 1e-7).
A debiased Bernoulli fit ends on a loglikelihood plateau, so it is held to
the spread tests/test_torch_families.py documents: the same support,
iterations within 3, betas within 2e-3 of max|beta|, logl within 1e-4
relative.
Cross validations as tests/test_torch_cv.py: mse within 1e-4 relative, the
same best k.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import debias as jdebias
from mendeliht_tpu.models import fit as jfit
from mendeliht_tpu.models import initialize as jinit
from mendeliht_tpu.models import streamed as jstreamed
from mendeliht_tpu.ops import linalg as jlinalg
from mendeliht_tpu.ops import projections as jproj

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import debias as tdebias
from mendeliht_tpu_torch.models import fit as tfit
from mendeliht_tpu_torch.models import initialize as tinit
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.ops import linalg as tlinalg
from mendeliht_tpu_torch.ops import projections as tproj

N, P, K = 300, 600, 5
GROUP = np.repeat(np.arange(1, 11), 60)             # 10 groups of 60 SNPs
GROUP_KS = [2, 1, 3, 0, 2, 1, 1, 2, 0, 1]


def _port(g):
    """The port's PackedGenotypes holding the JAX package's arrays."""
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


def _support(beta):
    return set(np.flatnonzero(beta).tolist())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.abs(want).max(), 1e-30)


GROUP_SPREAD = 3e-4


def _assert_fits_agree(rj, rt, spread=1e-4, plateau=False):
    assert _support(rt.beta) == _support(rj.beta)
    if plateau:
        assert abs(rt.iter - rj.iter) <= 3
    else:
        assert rt.iter == rj.iter
    scale = max(np.abs(rj.beta).max(), 1e-30)
    tol = 2e-3 if plateau else spread
    assert np.max(np.abs(rt.beta - rj.beta)) <= tol * scale
    np.testing.assert_allclose(rt.c, rj.c, rtol=tol, atol=tol * scale)
    assert abs(rt.logl - rj.logl) <= 1e-4 * abs(rj.logl)
    assert rt.J == rj.J and rt.k == rj.k
    np.testing.assert_array_equal(rt.group, rj.group)


def _jax_host_fit(y, g, z=None, *, k, init_beta=False, J=1, group=None,
                  **kwargs):
    """The JAX package's fit_iht through its host-stepped driver, as an
    IHTResult (fit_iht runs it for streamed genotypes)."""
    op, data, cfg, k_scalar = jfit.build_fit(y, g, z, k=k, J=J, group=group,
                                             **kwargs)
    k_task = (0 if cfg.group_k_is_vector
              else int(k) if cfg.use_group else k_scalar)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    idx, valid, bc, c, logl, iters, _, sg = jax.device_get(
        jstreamed.fit_fused_sparse_host(op, data, cfg,
                                        jnp.asarray([k_task], jnp.int32),
                                        cv_wts, init_beta=init_beta))
    beta = np.zeros(op.p, np.float32)
    keep = valid[0] & (idx[0] < op.p)
    beta[idx[0][keep]] = bc[0][keep]
    return m.IHTResult(
        time=0.0, logl=float(logl[0]), iter=int(iters[0]), beta=beta,
        c=np.asarray(c[0]), J=J,
        k=list(np.asarray(k)) if cfg.group_k_is_vector else int(k),
        group=np.asarray(group) if group is not None else np.array([], int),
        d=m.Normal(), sigma_g=float(sg[0]))


def _assert_fit_matches_jax(y, g, t, z=None, **kw):
    """The port's fit against the JAX package's: the host-stepped driver
    for ``init_beta`` and group fits (module docstring), else fit_iht."""
    rt = mt.fit_iht(y, t, z, verbose=False, **kw)
    if "group" in kw or kw.get("init_beta", False):
        rj = _jax_host_fit(y, g, z, **kw)
        _assert_fits_agree(rj, rt, GROUP_SPREAD if "group" in kw else 1e-4)
    else:
        _assert_fits_agree(m.fit_iht(y, g, z, verbose=False, **kw), rt)
    return rt


@pytest.fixture(scope="module")
def sim():
    """Genotypes without missing calls, a Gaussian y over K causal SNPs."""
    rng = np.random.default_rng(71)
    x, _ = m.simulate_random_snparray(None, N, P, rng=rng)
    y, _, _ = m.simulate_random_response(x, K, m.Normal(), rng=rng)
    return x, _port(x), y


@pytest.fixture(scope="module")
def cov_problem():
    """Genotypes with missing calls, an intercept and one covariate."""
    rng = np.random.default_rng(72)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(N, P),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    causal = rng.choice(P, K, replace=False)
    cov = rng.standard_normal(N)
    y = (g.to_dense_standardized()[:, causal] @ rng.choice([-1.0, 1.0], K)
         + 0.5 * cov + 1.0 + rng.standard_normal(N))
    return g, _port(g), y, np.stack([np.ones(N), cov], axis=1)


def _masks(n_pad, n, seed, B=3):
    w = np.zeros((B, n_pad), np.float32)
    w[:, :n] = np.random.default_rng(seed).integers(0, 2, size=(B, n))
    w[0, :n] = 1.0
    return w


# -- init_beta --------------------------------------------------------------

@pytest.mark.parametrize("which", ["plain", "missing"])
def test_col_moments_match_jax(sim, cov_problem, which):
    g, t = (sim[0], sim[1]) if which == "plain" else cov_problem[:2]
    assert g.has_missing == (which == "missing")
    y = np.random.default_rng(73).standard_normal(t.n_pad).astype(np.float32)
    y[t.n:] = 0.0
    W = _masks(t.n_pad, t.n, 74)
    WY = W * y[None, :]
    want = jlinalg.PackedOp(g).col_moments(jnp.asarray(W), jnp.asarray(WY))
    got = tlinalg.PackedOp(t).col_moments(torch.from_numpy(W),
                                          torch.from_numpy(WY))
    for name, a, b in zip(("Sx", "Sxx", "Sxy"), got, want):
        assert a.shape == (3, P)
        assert _rel(a.numpy(), b) <= 1e-5, name


@pytest.mark.parametrize("which", ["plain", "covariate"])
def test_initialize_beta_matches_jax(sim, cov_problem, which):
    if which == "plain":
        g, t, y = sim
        z = None
    else:
        g, t, y, z = cov_problem
    jop, jdata, _, _ = jfit.build_fit(y, g, z, k=K)
    op, data, _, _ = tfit.build_fit(y, t, z, k=K)
    W = _masks(op.n_pad, op.n, 75)
    bj, cj = jinit._initialize_beta(jop, jdata, jnp.asarray(W))
    bt, ct = tinit._initialize_beta(op, data, torch.from_numpy(W))
    assert _rel(bt.numpy(), bj) <= 1e-5
    assert _rel(ct.numpy(), cj) <= 1e-5


# -- debias -----------------------------------------------------------------

def _state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def test_gather_cols_match_jax(cov_problem):
    g, t, _, _ = cov_problem
    idx = np.array([[3, 599, 0, 17], [250, 4, 4, 100]])
    valid = np.array([[1, 1, 0, 1], [1, 1, 1, 0]], np.float32)
    want = jlinalg.PackedOp(g).gather_cols(jnp.asarray(idx),
                                           jnp.asarray(valid))
    got = tlinalg.PackedOp(t).gather_cols(torch.from_numpy(idx),
                                          torch.from_numpy(valid))
    assert _rel(got.numpy(), want) <= 1e-6
    np.testing.assert_allclose(got[0, :, :N].numpy(),
                               g.to_dense_standardized()[:, idx[0]].T
                               * valid[0][:, None], atol=1e-5)


@pytest.mark.parametrize("dist", ["normal", "bernoulli"])
def test_debias_refit_matches_jax(cov_problem, dist):
    """The refit from the same JAX state after three iterations."""
    g, t, y, z = cov_problem
    if dist == "bernoulli":
        y, _, _ = m.simulate_random_response(g, K, m.Bernoulli(),
                                             rng=np.random.default_rng(76))
    jop, jdata, jcfg, k = jfit.build_fit(y, g, z, k=K, d=dist, debias=True)
    op, data, cfg, _ = tfit.build_fit(y, t, z, k=K, d=dist, debias=True)
    cw = jnp.broadcast_to(jdata.sample_mask[None, :], (1, jop.n_pad))
    sj = jinit.init_state(jop, jdata, jcfg, jnp.asarray([k], jnp.int32), cw)
    for _ in range(3):
        sj = jstreamed._iteration_host(jop, jdata, jcfg, sj)
    st = IHTState.from_numpy(_state_numpy(sj), "cpu")
    want = np.asarray(jdebias.debias_refit(jop, jdata, jcfg, sj))
    got = tdebias.debias_refit(op, data, cfg, st).numpy()
    assert _support(got[0]) == _support(want[0])
    assert _rel(got, want) <= 1e-5


# -- projections ------------------------------------------------------------

def _values(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("k", [2, [2, 1, 3, 0, 2, 1, 1, 2, 0, 1]])
def test_project_group_sparse_matches_jax(k):
    y = _values(80, (3, P))
    for J in (1, 3, 10):
        want = np.asarray(jproj.project_group_sparse(jnp.asarray(y), GROUP,
                                                     J, k))
        got = mt.project_group_sparse(torch.from_numpy(y), GROUP, J, k)
        np.testing.assert_array_equal(got.numpy(), want)
        got1 = mt.project_group_sparse(y[0], GROUP, J, k)
        np.testing.assert_array_equal(got1.numpy(), want[0])
        assert np.all((want != 0).sum(axis=1) <= J * np.max(k))


def test_project_group_sparse_batched_and_per_task_match_jax():
    y = _values(81, (4, P))
    ks = np.array(GROUP_KS)
    want = jproj.project_group_sparse_batched(jnp.asarray(y), GROUP, 3, ks,
                                              10)
    got = tproj.project_group_sparse_batched(torch.from_numpy(y), GROUP, 3,
                                             torch.from_numpy(ks), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k_task = np.array([1, 2, 5, 0])
    want = jproj.project_group_sparse_per_task(jnp.asarray(y), GROUP, 2,
                                               jnp.asarray(k_task), 10)
    got = tproj.project_group_sparse_per_task(torch.from_numpy(y), GROUP, 2,
                                              torch.from_numpy(k_task), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True])
def test_project_k_matches_jax(weighted):
    x = _values(82, P)
    w = np.abs(_values(83, P)) if weighted else None
    for k in (1, 5, 40):
        want = jproj.project_k(jnp.asarray(x), k,
                               None if w is None else jnp.asarray(w))
        got = mt.project_k(torch.from_numpy(x), k,
                           None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_project_k_ties_keep_the_lower_index():
    x = np.array([1.0, -3.0, 3.0, 0.5, -3.0], np.float32)
    want = np.asarray(jproj.project_k(jnp.asarray(x), 2))
    np.testing.assert_array_equal(mt.project_k(torch.from_numpy(x), 2).numpy(),
                                  want)
    np.testing.assert_array_equal(want, [0.0, -3.0, 3.0, 0.0, 0.0])


def test_weighted_project_topk_joint_matches_jax():
    b, c = _values(84, (3, P)), _values(85, (3, 2))
    w = (1.0 + np.abs(_values(86, P + 2))).astype(np.float32)
    zkeep = np.array([True, False])
    kk = np.array([4, 7, 1])
    want = jproj.project_topk_joint(jnp.asarray(b), jnp.asarray(c),
                                    jnp.asarray(kk), jnp.asarray(zkeep), 9,
                                    weight=jnp.asarray(w))
    got = tproj.project_topk_joint(torch.from_numpy(b), torch.from_numpy(c),
                                   torch.from_numpy(kk),
                                   torch.from_numpy(zkeep), 9,
                                   weight=torch.from_numpy(w))
    for a, e in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    for t in range(3):
        sel = set(got[2][t][got[4][t]].tolist())
        assert sel == set(np.asarray(want[2][t])[np.asarray(want[4][t])]
                          .tolist())
    # the weights change the selection
    plain = tproj.project_topk_joint(torch.from_numpy(b), torch.from_numpy(c),
                                     torch.from_numpy(kk),
                                     torch.from_numpy(zkeep), 9)
    assert not torch.equal(plain[0], got[0])


# -- weights ----------------------------------------------------------------

def test_maf_and_maf_weights_match_jax(cov_problem):
    g, tg, _, _ = cov_problem
    # from codes: the counts' float64 frequencies
    t = mt.PackedGenotypes.from_codes(g.to_codes(), device="cpu")
    np.testing.assert_array_equal(mt.maf(t), m.maf(g))
    assert mt.maf(t).dtype == np.float64
    np.testing.assert_array_equal(mt.maf_weights(t), m.maf_weights(g))
    np.testing.assert_array_equal(mt.maf_weights(t, max_weight=2.5),
                                  m.maf_weights(g, max_weight=2.5))
    # from words and stats: derived from the f32 mu, as the JAX package's
    jg = m.PackedGenotypes.from_packed(
        g.packed_np(), np.asarray(g.mu), np.asarray(g.inv_sd), n=g.n, p=g.p,
        has_missing=g.has_missing)
    assert tg.maf_ is None and jg.maf_ is None
    np.testing.assert_array_equal(mt.maf(tg), m.maf(jg))
    assert mt.maf(tg).dtype == m.maf(jg).dtype == np.float32
    np.testing.assert_array_equal(mt.maf_weights(tg), m.maf_weights(jg))


# -- whole fits -------------------------------------------------------------

FIT_CASES = {
    "init_beta": dict(init_beta=True),
    "debias": dict(debias=True),
    "group": dict(group=GROUP, J=3, k=2),
    "group-vector-k": dict(group=GROUP, J=3, k=GROUP_KS),
    "weight": "weight",
    "zkeep": dict(zkeep=[True, False]),
    "init_beta-zkeep-weight": "all",
}


def _fit_kwargs(case, t):
    kw = FIT_CASES[case]
    w = mt.maf_weights(t)
    if kw == "weight":
        return dict(weight=w)
    if kw == "all":
        return dict(init_beta=True, zkeep=[False, True], weight=w)
    return dict(kw)


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_options_match_jax(cov_problem, case):
    g, t, y, z = cov_problem
    kw = dict(k=K)
    kw.update(_fit_kwargs(case, t))
    rt = _assert_fit_matches_jax(y, g, t, z, **kw)
    if "group" in kw:
        # at most J groups, each within its cap
        ks = np.broadcast_to(kw["k"], 10)
        sel_groups = set(GROUP[np.flatnonzero(rt.beta)].tolist())
        assert 0 < len(sel_groups) <= kw["J"]
        for gi in sel_groups:
            assert (rt.beta[GROUP == gi] != 0).sum() <= ks[gi - 1]
    else:
        # k counts the SNPs and the covariates that zkeep does not pin
        free = ~np.asarray(kw.get("zkeep", [True, True]))
        assert len(_support(rt.beta)) + int((rt.c[free] != 0).sum()) == K


def test_fit_options_without_covariates_match_jax(sim):
    g, t, y = sim
    for kw in (dict(init_beta=True), dict(debias=True),
               dict(group=GROUP, J=2, k=3)):
        _assert_fit_matches_jax(y, g, t, **{"k": K, **kw})


def test_debiased_bernoulli_fit_matches_jax(cov_problem):
    g, t, _, z = cov_problem
    y, _, _ = m.simulate_random_response(g, K, m.Bernoulli(),
                                         rng=np.random.default_rng(77))
    kw = dict(k=K, d=m.Bernoulli(), debias=True, verbose=False)
    rj = m.fit_iht(y, g, z, **kw)
    rt = mt.fit_iht(y, t, z, d=mt.Bernoulli(), k=K, debias=True,
                    verbose=False)
    _assert_fits_agree(rj, rt, plateau=True)


def test_debias_changes_the_fit(cov_problem):
    """The option does something: the debiased betas differ from the plain
    fit's on the same support."""
    _, t, y, z = cov_problem
    a = mt.fit_iht(y, t, z, k=K, verbose=False)
    b = mt.fit_iht(y, t, z, k=K, verbose=False, debias=True)
    assert not np.array_equal(a.beta, b.beta)


# -- teed lines and printing --------------------------------------------------

def _run(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kwargs)
    return res, out.getvalue()


def _iteration_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("Iteration ")]


def test_teed_lines_match_stdout_and_jax(cov_problem):
    g, t, y, z = cov_problem
    tee_t, tee_j = io.StringIO(), io.StringIO()
    rt, out_t = _run(mt.fit_iht, y, t, z, k=K, io=tee_t, debias=True,
                     weight=mt.maf_weights(t))
    rj, out_j = _run(m.fit_iht, y, g, z, k=K, io=tee_j, debias=True,
                     weight=mt.maf_weights(t))
    _assert_fits_agree(rj, rt)
    lines_t = _iteration_lines(tee_t.getvalue())
    assert lines_t and lines_t == _iteration_lines(out_t)
    assert len(lines_t) == rt.iter == len(_iteration_lines(tee_j.getvalue()))
    for a, b in zip(lines_t, _iteration_lines(tee_j.getvalue())):
        assert a.split(":")[0] == b.split(":")[0]
        la = float(a.split("loglikelihood = ")[1].split(",")[0])
        lb = float(b.split("loglikelihood = ")[1].split(",")[0])
        assert abs(la - lb) <= 1e-4 * abs(lb)
    # the parameter block goes to io; the result block to stdout alone
    head_t = [ln for ln in tee_t.getvalue().splitlines()
              if " = " in ln and not ln.startswith(("Iteration", "Backend"))]
    head_j = [ln for ln in tee_j.getvalue().splitlines()
              if " = " in ln and not ln.startswith(("Iteration", "Backend"))]
    assert head_t == head_j
    assert "Debias = on" in head_t
    assert "IHT estimated" in out_t and "IHT estimated" not in \
        tee_t.getvalue()


@pytest.mark.parametrize("kwargs", [dict(use_maf=True),
                                    dict(k=[1, 1, 2, 0, 1, 0, 0, 0, 0, 0],
                                         group=GROUP)])
def test_parameter_block_matches_jax(sim, kwargs):
    g, t, y = sim
    kw = {"k": K, **kwargs}
    _, out_t = _run(mt.fit_iht, y, t, **kw)
    _, out_j = _run(m.fit_iht, y, g, **kw)
    pick = lambda s: [ln for ln in s.splitlines()                # noqa: E731
                      if ln.startswith(("Sparsity", "Prior", "Doubly",
                                        "Debias"))]
    assert pick(out_t) == pick(out_j)
    assert len(pick(out_t)) == 4


# -- use_maf, the errors, F3 ------------------------------------------------

def test_use_maf_is_accepted_and_ignored(sim):
    g, t, y = sim
    want = mt.fit_iht(y, t, k=K, verbose=False)
    got = mt.fit_iht(y, t, k=K, verbose=False, use_maf=True)
    np.testing.assert_array_equal(got.beta, want.beta)
    assert (got.iter, got.logl) == (want.iter, want.logl)
    folds = np.tile(np.arange(1, 4), N // 3)
    kw = dict(path=[1, 3], q=3, folds=folds, verbose=False)
    np.testing.assert_array_equal(mt.cv_iht(y, t, use_maf=True, **kw),
                                  mt.cv_iht(y, t, **kw))
    np.testing.assert_array_equal(
        mt.iht_run_many_models(y, t, path=[1, 3], use_maf=True,
                               verbose=False),
        mt.iht_run_many_models(y, t, path=[1, 3], verbose=False))


@pytest.mark.parametrize("k,group,match", [
    ([1, 2], None, "no group information"),
    ([1, 2], [1], "no group information"),
    ([1, 70], GROUP[:120] * 0 + np.repeat([1, 2], 60), "group 2 was 70"),
    (-1, GROUP, "nonnegative"),
    (2, GROUP[:10], "group must have length"),
])
def test_check_group_errors_match_jax(sim, k, group, match):
    g, t, y = sim
    if group is not None and len(group) == 120:
        group = np.concatenate([group, np.full(P - 120, 3)])
    with pytest.raises(ValueError, match=match) as ej:
        m.fit_iht(y, g, k=k, group=group, verbose=False)
    with pytest.raises(ValueError, match=match) as et:
        mt.fit_iht(y, t, k=k, group=group, verbose=False)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kwargs,match", [
    (dict(weight=np.ones(7)), "weight must have length"),
    (dict(zkeep=[True, False, True]), "zkeep must have length"),
    (dict(init_beta=True, d="bernoulli"), "Gaussian")])
def test_option_errors_match_jax(cov_problem, kwargs, match):
    g, t, y, z = cov_problem
    if kwargs.get("d") == "bernoulli":
        y = (y > np.median(y)).astype(float)
    with pytest.raises(ValueError, match=match) as ej:
        m.fit_iht(y, g, z, k=K, verbose=False, **kwargs)
    with pytest.raises(ValueError, match=match) as et:
        mt.fit_iht(y, t, z, k=K, verbose=False, **kwargs)
    assert str(et.value) == str(ej.value)


# -- cross validation --------------------------------------------------------

CV_CASES = {"init_beta": dict(init_beta=True), "debias": dict(debias=True),
            "group": dict(group=GROUP), "weight-zkeep": "weight-zkeep"}


@pytest.mark.parametrize("case", list(CV_CASES))
def test_cv_options_match_jax(cov_problem, case):
    g, t, y, z = cov_problem
    kw = CV_CASES[case]
    if kw == "weight-zkeep":
        kw = dict(weight=mt.maf_weights(t), zkeep=[True, False])
    folds = np.tile(np.arange(1, 4), N // 3)
    common = dict(path=[2, 4, 6], q=3, folds=folds, verbose=False, **kw)
    want = m.cv_iht(y, g, z, **common)
    got = mt.cv_iht(y, t, z, **common)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_iht_run_many_models_options_match_jax(cov_problem):
    g, t, y, z = cov_problem
    for kw in (dict(group=GROUP), dict(debias=True),
               dict(weight=mt.maf_weights(t))):
        want = m.iht_run_many_models(y, g, z, path=[1, 3, 5], verbose=False,
                                     **kw)
        got = mt.iht_run_many_models(y, t, z, path=[1, 3, 5], verbose=False,
                                     **kw)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pve_matches_jax(sim):
    g, t, y = sim
    beta = np.zeros(P)
    beta[[3, 77, 400]] = [0.5, -1.0, 0.25]
    # the JAX package's inverse link runs in f32 (x64 off), the port's in
    # float64: 1e-6 relative
    assert mt.pve(y, t, beta) == pytest.approx(m.pve(y, g, beta), rel=1e-6)
    yy = np.stack([y, 2 * y + 1], axis=1)
    bb = np.stack([beta, -0.5 * beta], axis=1)
    np.testing.assert_allclose(mt.pve(yy, t, bb, l="log"),
                               m.pve(yy, g, bb, l="log"), rtol=1e-6)
    assert mt.allocate_fold_and_k(2, [1, 3]) == m.allocate_fold_and_k(2,
                                                                       [1, 3])
