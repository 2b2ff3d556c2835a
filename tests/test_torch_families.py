"""Parity of the port's non-Gaussian fits with the JAX package, on the CPU:
the first solver iteration from the JAX package's state, whole ``fit_iht``
runs of every family and the links a GWAS uses, ``cv_iht`` and
``iht_run_many_models`` with a family and ``est_r``, and the errors.

Both packages get the same genotype words and responses as numpy.

Tolerances.  The first iteration from the same state is held as tightly as
the Gaussian fit (tests/test_torch_fit.py): the same support, backtracks
and convergence flag, b, c, the score and logl within 1e-4 of their scale,
the negative binomial's r within 1e-4 relative for MM and, for Newton, as
good a maximiser as the JAX package's (the float64 loglikelihood at both r
within 1e-4 relative): Newton's accept tests tie where the loglikelihood is
flat in r to f32 precision, and its step size persists across its
iterations, so a tie early changes its path (see
tests/test_torch_glm.py::test_newton_r_within_the_f32_spread).

A whole GLM fit ends on a loglikelihood plateau where the loglikelihood of
successive iterates differs by a few f32 roundings, so ties decide which
iterate is best, whether a step backtracks and when the fit stops.  The
JAX package's own two drivers (``fit_fused`` and the host-stepped
``streamed.run_iht_host``) disagree there by up to 2 iterations, 2e-3 of
max|beta| and 2e-2 in the Newton r (6 seeds x 4 families at 1000 x 2000).
Whole fits are therefore held to: the same support, iterations within 3,
betas within 2e-3 of max|beta|, logl within 1e-4 relative (1e-3 with the
Newton r, which the loglikelihood carries), r within 5e-2 relative (Newton)
or 1e-4 (MM).  Cross validations are held to the Gaussian cv's tolerance
(tests/test_torch_cv.py: mse within 1e-4 relative, the same best k).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import fit as jfit
from mendeliht_tpu.models import streamed as jstreamed
from mendeliht_tpu.models import univariate as juni
from mendeliht_tpu.models.initialize import init_state as jinit_state

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import fit as tfit
from mendeliht_tpu_torch.models import univariate as tuni
from mendeliht_tpu_torch.models.initialize import init_state as tinit_state
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.ops import glm as tglm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (family, link, est_r) of every fit compared; the index is the seed offset
# of its response
CASES = [("bernoulli", None, "none"), ("bernoulli", "probit", "none"),
         ("bernoulli", "cloglog", "none"), ("poisson", None, "none"),
         ("negativebinomial", "log", "newton"),
         ("negativebinomial", "log", "mm"), ("gamma", "log", "none"),
         ("inversegaussian", "log", "none")]
IDS = ["logit", "probit", "cloglog", "poisson", "nb-newton", "nb-mm",
       "gamma", "invgauss"]
K = 5
FOLDS = np.tile(np.arange(1, 4), 334)[:1000]     # fixed cv folds, q = 3


def _port(g):
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


@pytest.fixture(scope="module")
def geno():
    """1000 x 2000 simulated genotypes (JAX) and the port's copy."""
    x, _ = m.simulate_random_snparray(None, 1000, 2000,
                                      rng=np.random.default_rng(7))
    return x, _port(x)


def _response(x, case):
    """The case's response from seed 100 + its index: the JAX simulator's,
    with r = 2 for the negative binomial (at its default r = 10 and means
    near 1 the counts are nearly Poisson and r is not identified), but for
    the inverse Gaussian, whose simulator draws effects of sd 1 under the
    log link (a mean spread over e^+-10, fits that crawl to max_iter):
    there Wald draws around exp(X b) with effects of sd 0.3, as the
    simulator gives the other log-link families."""
    i = CASES.index(case)
    d, l, _ = case
    rng = np.random.default_rng(100 + i)
    if d != "inversegaussian":
        return m.simulate_random_response(x, K, d, l, r=2, rng=rng)[0]
    b = np.zeros(x.p)
    b[rng.choice(x.p, K, replace=False)] = rng.normal(0.0, 0.3, K)
    return rng.wald(np.exp(x.to_dense_standardized() @ b), 1.0)


def _state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _nb_ll64(y, mu, wts, n_true, r):
    """float64 negative-binomial loglikelihood per task at r (B,)."""
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    return tglm.loglikelihood("negativebinomial", d(y)[None], d(mu), d(wts),
                              n_true, nb_r=d(r)[:, None], dim=1).numpy()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_iteration_from_jax_state(geno, case):
    """The first iteration started from the JAX package's initial state,
    against its host-stepped iteration (``streamed._iteration_host``).
    Later ones are not compared this way: a step that stalls (eta ~ 0) sets
    the JAX package's logl against the port's of the same iterate, a tie
    that decides whether it backtracks."""
    x, t = geno
    d, l, est_r = case
    y = _response(x, case)
    jop, jdata, jcfg, k = jfit.build_fit(y, x, None, k=K, d=d, l=l,
                                         est_r=est_r)
    op, data, cfg, _ = tfit.build_fit(y, t, None, k=K, d=d, l=l,
                                      est_r=est_r)
    ks = jnp.asarray([k], jnp.int32)
    cw = jnp.broadcast_to(jdata.sample_mask[None, :], (1, jop.n_pad))
    sj = jinit_state(jop, jdata, jcfg, ks, cw)
    st = IHTState.from_numpy(_state_numpy(sj), "cpu")
    sj1 = jstreamed._iteration_host(jop, jdata, jcfg, sj)
    st1 = tuni._iteration(op, data, cfg, st)
    assert st1.iteration == int(sj1.iteration) == 1
    assert (set(st1.sel_idx[0].tolist())
            == set(np.asarray(sj1.sel_idx[0]).tolist()))
    assert int(st1.backtracks[0]) == int(sj1.backtracks[0])
    assert bool(st1.active[0]) == bool(sj1.active[0])
    r_j, r_t = np.asarray(sj1.nb_r), st1.nb_r.numpy()
    if est_r == "newton":
        mu = np.asarray(sj1.mu)[:, :x.n]
        ones = np.ones((1, x.n))
        np.testing.assert_allclose(_nb_ll64(y, mu, ones, x.n, r_t),
                                   _nb_ll64(y, mu, ones, x.n, r_j),
                                   rtol=1e-4)
        # the score at the JAX package's r, so that both see one r
        df, df2 = tuni._score(op, data, cfg, dataclasses.replace(
            st1, nb_r=torch.from_numpy(r_j)))
        st1 = dataclasses.replace(st1, df=df, df2=df2)
    else:
        np.testing.assert_allclose(r_t, r_j, rtol=1e-4)
    for name in ("b", "c", "df", "df2", "logl"):
        want = np.asarray(getattr(sj1, name))
        got = getattr(st1, name).numpy()
        assert np.max(np.abs(got - want)) <= \
            1e-4 * max(1.0, np.abs(want).max()), name


def _recorder(fn):
    """(states, fn that records the states fn returns)."""
    states = []

    def recording(*args, **kwargs):
        states.append(fn(*args, **kwargs))
        return states[-1]
    return states, recording


@pytest.fixture(scope="module")
def fits(geno):
    """Every case fitted by both packages: {case: (JAX result, port result,
    JAX final r, port final r)}."""
    x, t = geno
    out = {}
    for case in CASES:
        d, l, est_r = case
        y = _response(x, case)
        rj = m.fit_iht(y, x, k=K, d=d, l=l, est_r=est_r, verbose=False)
        states, rec = _recorder(tuni.finalize_iht)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfit, "finalize_iht", rec)
            rt = mt.fit_iht(y, t, k=K, d=d, l=l, est_r=est_r, verbose=False)
        r_j = 1.0
        if d == "negativebinomial":
            # the JAX package's final state of the same fit
            op, data, cfg, k = jfit.build_fit(y, x, None, k=K, d=d, l=l,
                                              est_r=est_r)
            sj, _ = juni.fit_fused(
                op, data, cfg, jnp.asarray([k], jnp.int32),
                jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad)))
            r_j = float(sj.nb_r[0])
        out[case] = (rj, rt, r_j, float(states[-1].nb_r[0]))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fit_matches_jax(fits, case):
    rj, rt, r_j, r_t = fits[case]
    assert set(np.flatnonzero(rt.beta)) == set(np.flatnonzero(rj.beta))
    assert len(np.flatnonzero(rt.beta)) == K
    newton = case[2] == "newton"
    assert abs(rt.logl - rj.logl) <= (1e-3 if newton else 1e-4) * abs(rj.logl)
    assert abs(rt.iter - rj.iter) <= 3
    scale = max(np.abs(rj.beta).max(), 1e-30)
    assert np.max(np.abs(rt.beta - rj.beta)) <= 2e-3 * scale
    np.testing.assert_allclose(rt.c, rj.c, rtol=2e-3, atol=2e-3 * scale)
    assert abs(rt.sigma_g - rj.sigma_g) <= 2e-3
    r_tol = 5e-2 if newton else 1e-4
    assert abs(r_t - r_j) <= r_tol * abs(r_j)
    if case[0] != "negativebinomial":
        assert r_t == r_j == 1.0


@pytest.mark.parametrize("est_r", ["MM", ":newton", "Newton", ":mm"])
def test_est_r_spellings(geno, fits, est_r):
    """est_r as the JAX package normalises it: any case, a leading colon."""
    x, t = geno
    case = CASES[5] if "m" in est_r.lower() else CASES[4]
    rt = mt.fit_iht(_response(x, case), t, k=K, d=case[0], l=case[1],
                    est_r=est_r, verbose=False)
    want = fits[case][1]
    np.testing.assert_array_equal(rt.beta, want.beta)
    assert (rt.iter, rt.logl) == (want.iter, want.logl)


def test_canonical_link_is_the_default(geno, fits):
    x, t = geno
    case = CASES[0]
    rt = mt.fit_iht(_response(x, case), t, k=K, d=mt.Bernoulli(),
                    l=mt.LogitLink(), verbose=False)
    np.testing.assert_array_equal(rt.beta, fits[case][1].beta)


@pytest.mark.parametrize("d", ["bernoulli", "poisson"])
def test_cv_matches_jax(geno, d):
    x, t = geno
    y, _, _ = m.simulate_random_response(x, K, d,
                                         rng=np.random.default_rng(54))
    kw = dict(d=d, path=[3, 5, 7], q=3, folds=FOLDS, verbose=False)
    want = m.cv_iht(y, x, **kw)
    got = mt.cv_iht(y, t, **kw)
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_cv_and_path_with_est_r_match_jax(geno):
    """cv_iht and iht_run_many_models take est_r, as in the JAX package."""
    x, t = geno
    y, _, _ = m.simulate_random_response(x, K, "negativebinomial", r=2,
                                         rng=np.random.default_rng(55))
    kw = dict(d="negativebinomial", l="log", est_r="mm", path=[3, 5, 7],
              q=3, folds=FOLDS, verbose=False)
    got, want = mt.cv_iht(y, t, **kw), m.cv_iht(y, x, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))
    kw = dict(d="negativebinomial", l="log", est_r="mm", path=[3, 5],
              verbose=False)
    np.testing.assert_allclose(mt.iht_run_many_models(y, t, **kw),
                               m.iht_run_many_models(y, x, **kw), rtol=1e-4)


def test_verbose_family_fit_prints_its_regression(geno, capsys):
    x, t = geno
    mt.fit_iht(_response(x, CASES[0]), t, k=K, d=mt.Bernoulli())
    out = capsys.readouterr().out
    assert "Running sparse logistic regression" in out
    assert "Link function = logit" in out
    mt.fit_iht(_response(x, CASES[5]), t, k=K, d=mt.NegativeBinomial(),
               l=mt.LogLink(), est_r="mm")
    assert "Running sparse NegativeBinomial regression" in \
        capsys.readouterr().out


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(d="normal", est_r="mm"), ValueError, "nuisance"),
    (dict(d="poisson", est_r="newton"), ValueError, "nuisance"),
    (dict(d="bernoulli"), ValueError, "0 or 1"),
    (dict(d="binomial"), ValueError, "unknown distribution binomial"),
    (dict(d="gamma"), FloatingPointError, "NaN/Inf"),
    (dict(d="inversegaussian"), FloatingPointError, "NaN/Inf"),
    (dict(d="negativebinomial", init_beta=True), ValueError,
     "only works for Gaussian")], ids=["est_r-normal", "est_r-poisson", "bernoulli-y",
                       "binomial", "gamma-inverse", "invgauss-inversesquare",
                       "init_beta"])
def test_errors_match_jax(geno, kwargs, exc, match):
    """The JAX package's errors: est_r off the negative binomial, a
    Bernoulli y that is not 0/1, a Binomial fit (its deviance is not
    defined), and the inverse-type canonical links of Gamma and inverse
    Gaussian, whose intercept starts at an infinite mean; init_beta off
    the Gaussian family (it raised NotImplementedError before init_beta
    was ported)."""
    x, t = geno
    y, _, _ = m.simulate_random_response(x, K, "gamma", "log",
                                         rng=np.random.default_rng(3))
    with pytest.raises(exc, match=match):
        mt.fit_iht(y, t, k=K, verbose=False, **kwargs)
    if exc is not NotImplementedError:
        with pytest.raises(exc, match=match):
            m.fit_iht(y, x, k=K, verbose=False, **kwargs)


def test_init_state_nb_r_and_clamp(geno):
    """The initial state's r is 1; a step's linear predictors are clamped to
    +-20 for a non-normal family (reference src/utilities.jl:93-118)."""
    x, t = geno
    y = _response(x, CASES[3])
    op, data, cfg, k = tfit.build_fit(y, t, None, k=K, d="poisson")
    st = tinit_state(op, data, cfg, [k], data.sample_mask[None, :])
    assert st.nb_r.tolist() == [1.0]
    b = torch.zeros_like(st.b)
    b[0, 0] = 1e4
    sel = torch.zeros_like(st.sel_idx)
    valid = torch.zeros_like(st.sel_valid)
    valid[0, 0] = True
    c = torch.full_like(st.c, -1e3)
    xb, zc = tuni._forward(op, data, cfg, b, c, sel, valid)
    n = t.n
    assert xb.abs().max() == 20.0 and torch.all(zc[:, :n] == -20.0)
    normal = dataclasses.replace(cfg, dist="normal")
    xb, zc = tuni._forward(op, data, normal, b, c, sel, valid)
    assert xb.abs().max() > 20.0 and torch.all(zc[:, :n] == -1e3)
