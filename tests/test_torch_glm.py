"""Parity of the port's GLM layer with the JAX package, on the CPU: every
family's and link's elementwise function, the negative-binomial r updates,
``simulate_random_response`` and the state carried across.

The same numpy arrays go through ``mendeliht_tpu.ops.glm`` / ``negbin``
(XLA on the CPU, tests/conftest.py) and their ports.  Tolerances: the
elementwise functions within 1e-5 relative (f32 special functions of two
libraries differ by ulps); the r updates within 1e-4 relative where the
answer is determined to that precision in f32 (see
``test_newton_r_within_the_f32_spread``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import fit as jfit
from mendeliht_tpu.models.initialize import init_state as jinit_state
from mendeliht_tpu.ops import glm as jglm
from mendeliht_tpu.ops import negbin as jnegbin

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.ops import glm as tglm
from mendeliht_tpu_torch.ops import negbin as tnegbin
from mendeliht_tpu_torch.utils.simulate import simulate_random_response

LINKS = ["identity", "logit", "log", "inverse", "sqrt", "probit", "cloglog",
         "inversesquare"]
FAMILIES = ["normal", "bernoulli", "poisson", "negativebinomial", "gamma",
            "inversegaussian"]
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    """Equal NaN/inf pattern; finite entries within rtol of each other or
    of the array's scale (entries that cancel to ~0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        scale = np.abs(want[fin]).max()
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   atol=rtol * 1e-2 * scale)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _eta(link, rng, n=400):
    """Linear predictors in the link's domain, with the +-20 clamp edges
    where the link takes any real."""
    if link in ("inverse", "inversesquare"):
        return np.concatenate([rng.uniform(0.05, 5.0, n - 2), [1e-3, 20.0]])
    e = rng.normal(0.0, 3.0, n - 4)
    return np.concatenate([e, [-20.0, 20.0, 0.0, -1e-4]])


def _data(dist, rng, n=400):
    """(y, mu, wt) for a family: responses in its support, means with the
    clip edges (mu at 0 and 1 for the Bernoulli, ~1e-35 for the counts),
    a 0/1 weight with holdout samples."""
    wt = (rng.random(n) > 0.3).astype(np.float64)
    if dist == "bernoulli":
        mu = rng.uniform(0.0, 1.0, n)
        mu[:4] = [0.0, 1.0, 1e-12, 1.0 - 1e-9]
        y = (rng.random(n) < 0.5).astype(np.float64)
        y[:4] = [1.0, 0.0, 1.0, 0.0]
    elif dist in ("poisson", "negativebinomial"):
        mu = np.exp(rng.normal(0.0, 1.0, n))
        mu[:2] = [1e-35, 1e-8]
        y = rng.poisson(2.0, n).astype(np.float64)
        y[:3] = [3.0, 0.0, 0.0]
    elif dist in ("gamma", "inversegaussian"):
        mu = np.exp(rng.normal(0.0, 1.0, n))
        y = rng.gamma(1.0, mu)
    else:
        mu = rng.normal(0.0, 2.0, n)
        y = mu + rng.normal(0.0, 1.0, n)
    return y, mu, wt


@pytest.mark.parametrize("link", LINKS)
def test_linkinv_and_mueta_match_jax(link):
    eta = _eta(link, np.random.default_rng(1))
    _close(tglm.linkinv(link, _t(eta)).numpy(), jglm.linkinv(link, _j(eta)))
    _close(tglm.mueta(link, _t(eta)).numpy(), jglm.mueta(link, _j(eta)))


def test_unknown_names_raise():
    for fn, args in ((tglm.linkinv, ("cauchit", _t([0.0]))),
                     (tglm.mueta, ("cauchit", _t([0.0]))),
                     (tglm.glmvar, ("tweedie", _t([1.0]))),
                     (tglm.devresid, ("binomial", _t([1.0]), _t([0.5]))),
                     (tglm.loglik_obs, ("tweedie", _t([1.0]), _t([1.0]),
                                        _t([1.0]), _t([1.0])))):
        with pytest.raises(ValueError, match="unknown"):
            fn(*args)
    with pytest.raises(ValueError, match="unknown distribution binomial"):
        jglm.devresid("binomial", _j([1.0]), _j([0.5]))


@pytest.mark.parametrize("dist", FAMILIES + ["binomial"])
def test_glmvar_matches_jax(dist):
    _, mu, _ = _data(dist if dist != "binomial" else "bernoulli",
                     np.random.default_rng(2))
    for r in (0.5, 7.0):
        _close(tglm.glmvar(dist, _t(mu), nb_r=torch.tensor(r)).numpy(),
               jglm.glmvar(dist, _j(mu), nb_r=jnp.float32(r)))


@pytest.mark.parametrize("dist", FAMILIES)
def test_devresid_and_loglik_obs_match_jax(dist):
    rng = np.random.default_rng(3)
    y, mu, wt = _data(dist, rng)
    r = np.float32(3.5)
    _close(tglm.devresid(dist, _t(y), _t(mu), nb_r=torch.tensor(r)).numpy(),
           jglm.devresid(dist, _j(y), _j(mu), nb_r=r))
    for phi in (0.3, 1.7):
        _close(tglm.loglik_obs(dist, _t(y), _t(mu), _t(wt), torch.tensor(phi),
                               nb_r=torch.tensor(r)).numpy(),
               jglm.loglik_obs(dist, _j(y), _j(mu), _j(wt), jnp.float32(phi),
                               nb_r=r))


def test_binomial_loglik_obs_matches_jax():
    """The binomial branch: the weight is the trial count."""
    rng = np.random.default_rng(4)
    wt = rng.integers(0, 6, 300).astype(np.float64)
    mu = rng.uniform(0.0, 1.0, 300)
    mu[:2] = [0.0, 1.0]
    y = rng.binomial(wt.astype(int), 0.4) / np.maximum(wt, 1)
    _close(tglm.loglik_obs("binomial", _t(y), _t(mu), _t(wt),
                           torch.tensor(1.0)).numpy(),
           jglm.loglik_obs("binomial", _j(y), _j(mu), _j(wt),
                           jnp.float32(1.0)))


@pytest.mark.parametrize("dist", FAMILIES)
def test_batched_deviance_loglikelihood_match_jax(dist):
    """(B, n) with a per-task r (B, 1) and per-task masks, summed over
    samples, as the solver calls them; and the unbatched totals."""
    rng = np.random.default_rng(5)
    y, mu0, _ = _data(dist, rng)
    mu = np.stack([mu0, mu0[::-1].copy(), mu0 * 0.9 if dist != "bernoulli"
                   else mu0 * 0.5])
    wts = (rng.random(mu.shape) > 0.25).astype(np.float64)
    wts[:, -5:] = 0.0
    r = np.array([[1.0], [4.0], [40.0]], np.float32)
    kw_t, kw_j = dict(nb_r=torch.from_numpy(r)), dict(nb_r=jnp.asarray(r))
    _close(tglm.deviance(dist, _t(y)[None], _t(mu), _t(wts), dim=1,
                         **kw_t).numpy(),
           jglm.deviance(dist, _j(y)[None], _j(mu), _j(wts), axis=1, **kw_j))
    _close(tglm.loglikelihood(dist, _t(y)[None], _t(mu), _t(wts), 395, dim=1,
                              **kw_t).numpy(),
           jglm.loglikelihood(dist, _j(y)[None], _j(mu), _j(wts), 395,
                              axis=1, **kw_j))
    _close(tglm.loglikelihood(dist, _t(y), _t(mu0), _t(wts[0]), 400,
                              nb_r=torch.tensor(2.0)).numpy(),
           jglm.loglikelihood(dist, _j(y), _j(mu0), _j(wts[0]), 400,
                              nb_r=jnp.float32(2.0)))


@pytest.mark.parametrize("dist,link", [(d, "log") for d in FAMILIES]
                         + [("bernoulli", "logit"), ("bernoulli", "probit"),
                            ("bernoulli", "cloglog"), ("normal", "identity"),
                            ("poisson", "sqrt"), ("gamma", "inverse"),
                            ("inversegaussian", "inversesquare")])
def test_score_residual_matches_jax(dist, link):
    rng = np.random.default_rng(6)
    eta = _eta(link, rng)
    y, _, wt = _data(dist, rng)
    mu_t = tglm.linkinv(link, _t(eta))
    mu_j = jglm.linkinv(link, _j(eta))
    r = np.array([[2.5]], np.float32)
    _close(tglm.score_residual(dist, link, _t(y)[None], mu_t[None],
                               _t(eta)[None], _t(wt)[None],
                               nb_r=torch.from_numpy(r)).numpy(),
           jglm.score_residual(dist, link, _j(y)[None], mu_j[None],
                               _j(eta)[None], _j(wt)[None],
                               nb_r=jnp.asarray(r)))


def test_names_links_and_canonical_links_match_jax():
    for d in FAMILIES + ["binomial", "mvnormal"]:
        assert repr(tglm.canonicallink(d)) == repr(jglm.canonicallink(d))
    for cls_t, cls_j in ((mt.Bernoulli, m.Bernoulli), (mt.Gamma, m.Gamma),
                         (mt.NegativeBinomial, m.NegativeBinomial),
                         (mt.InverseGaussian, m.InverseGaussian),
                         (mt.Poisson, m.Poisson), (mt.Binomial, m.Binomial),
                         (mt.MvNormal, m.MvNormal)):
        assert tglm.dist_name(cls_t()) == jglm.dist_name(cls_j())
        assert tglm.dist_name(cls_t) == jglm.dist_name(cls_j)
    assert mt.NegativeBinomial(r=3.0).r == 3.0
    for link in LINKS:
        cls = tglm._LINKS[link]
        assert tglm.link_name(cls()) == tglm.link_name(cls) == link
        assert cls() == cls() and hash(cls()) == hash(link)
        assert repr(cls()) == repr(jglm._LINKS[link]())
    assert mt.LogLink() != mt.LogitLink()
    assert mt.canonicallink(mt.Bernoulli()) == mt.LogitLink()


# ---------------------------------------------------------------------------
# negative-binomial r
# ---------------------------------------------------------------------------

def _nb_problem(r_true, seed=0, n=1000, B=3):
    """Counts y from NB(r_true) around means mu (B, n), 37 padding samples,
    and three tasks with different cv masks."""
    rng = np.random.default_rng(seed)
    mu = np.exp(rng.normal(0.5, 0.5, (B, n))).astype(np.float32)
    y = rng.negative_binomial(r_true, 1 / (1 + mu[0] / r_true))
    y = y.astype(np.float32)
    sm = np.ones(n, np.float32)
    sm[-37:] = 0.0
    y[-37:] = 0.0
    cw = np.stack([sm * (rng.random(n) > f) for f in (0.0, 0.2, 0.33)])
    r0 = np.array([1.0, 3.0, 0.7], np.float32)
    return y, mu, sm, cw.astype(np.float32), r0, n - 37


def test_update_r_mm_matches_jax():
    y, mu, sm, _, r0, _ = _nb_problem(2.0)
    for r in (r0, np.array([5.0, 0.2, 40.0], np.float32)):
        got = tnegbin.update_r_mm(_t(y), _t(mu), _t(r), _t(sm)).numpy()
        want = np.asarray(jnegbin.update_r_mm(_j(y), _j(mu), _j(r), _j(sm)))
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("max_iter", [1, 2, 5, 100])
def test_update_r_newton_matches_jax(max_iter):
    """B = 3 tasks with different masks: the first Newton iterations, and
    the whole default run where r is well determined (r = 2 data)."""
    y, mu, sm, cw, r0, n_true = _nb_problem(2.0)
    got = tnegbin.update_r_newton(_t(y), _t(mu), _t(r0), _t(sm), _t(cw),
                                  n_true, max_iter=max_iter).numpy()
    want = np.asarray(jnegbin.update_r_newton(
        _j(y), _j(mu), _j(r0), _j(sm), _j(cw), n_true, max_iter=max_iter))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("r_true", [10.0, 50.0])
def test_newton_r_within_the_f32_spread(r_true):
    """Where the loglikelihood is flat in r to f32 precision (larger r), the
    line search's accept tests are ties and Newton's r is known only to
    that width (the JAX package's own f32 r then differs from the float64
    run's by up to 1e-3 relative).  There the port's r and the JAX
    package's must be equally good: their float64 loglikelihoods within a
    few f32 roundings (1e-6 relative) of each other."""
    y, mu, sm, cw, r0, n_true = _nb_problem(r_true, seed=1)
    got = tnegbin.update_r_newton(_t(y), _t(mu), _t(r0), _t(sm), _t(cw),
                                  n_true).numpy()
    want = np.asarray(jnegbin.update_r_newton(_j(y), _j(mu), _j(r0), _j(sm),
                                              _j(cw), n_true))

    def ll64(r):
        d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa
        return tglm.loglikelihood("negativebinomial", d(y)[None], d(mu),
                                  d(cw), n_true, nb_r=d(r)[:, None],
                                  dim=1).numpy()

    np.testing.assert_allclose(ll64(got), ll64(want), rtol=1e-6)


def test_newton_stays_at_the_optimum():
    """Started where the JAX package's Newton run ended, one more Newton
    iteration (where the line search finds no better halving, r moves by
    step 2^-20 inc: task 1 here) leaves r there, the same in both
    packages."""
    y, mu, sm, cw, r0, n_true = _nb_problem(2.0)
    opt = np.asarray(jnegbin.update_r_newton(_j(y), _j(mu), _j(r0), _j(sm),
                                             _j(cw), n_true))
    got = tnegbin.update_r_newton(_t(y), _t(mu), _t(opt), _t(sm), _t(cw),
                                  n_true, max_iter=1).numpy()
    want = np.asarray(jnegbin.update_r_newton(_j(y), _j(mu), _j(opt), _j(sm),
                                              _j(cw), n_true, max_iter=1))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, opt, rtol=1e-4)


def test_mle_for_r_dispatch():
    y, mu, sm, cw, r0, n_true = _nb_problem(2.0)
    args = (_t(y), _t(mu), _t(r0), _t(sm), _t(cw), n_true)
    np.testing.assert_array_equal(
        tnegbin.mle_for_r("mm", *args).numpy(),
        tnegbin.update_r_mm(*args[:4]).numpy())
    np.testing.assert_array_equal(
        tnegbin.mle_for_r("newton", *args).numpy(),
        tnegbin.update_r_newton(*args).numpy())
    with pytest.raises(ValueError, match="est_r"):
        tnegbin.mle_for_r("em", *args)


# ---------------------------------------------------------------------------
# the simulator and the state carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def geno():
    """JAX genotypes with missing calls and the port's copy of them."""
    rng = np.random.default_rng(8)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(700, 1003),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    t = mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")
    return g, t


@pytest.mark.parametrize("dist,link,exact", [
    ("normal", None, False), ("bernoulli", None, True),
    ("poisson", None, True), ("negativebinomial", None, True),
    ("gamma", "log", False), ("inversegaussian", "log", False)])
def test_simulate_random_response_matches_jax(geno, dist, link, exact):
    """The same draws from the same seed.  The port decodes only the causal
    columns and sums their k products, the JAX package multiplies the dense
    matrix: eta agrees to f64 rounding; a continuous y follows its mean,
    which the JAX package takes through float32 for the non-identity links
    (so within 1e-6 of the scale), a count or 0/1 y is drawn equal."""
    g, t = geno
    Zu = np.random.default_rng(9).normal(0.0, 0.1, g.n)
    for zu in (None, Zu):
        yj, bj, pj = m.simulate_random_response(
            g, 7, dist, link, Zu=zu, rng=np.random.default_rng(5))
        yt, bt, pt = simulate_random_response(
            t, 7, dist, link, Zu=zu, rng=np.random.default_rng(5))
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(pt, pj)
        assert yt.dtype == np.float64 and yt.shape == (g.n,)
        if exact:
            np.testing.assert_array_equal(yt, yj)
        else:
            assert np.max(np.abs(yt - yj)) <= 1e-6 * np.abs(yj).max()


def test_simulate_random_response_dense_and_errors(geno):
    g, t = geno
    x = g.to_dense_standardized()
    yd, bd, pd = simulate_random_response(x, 5, mt.Poisson(),
                                          rng=np.random.default_rng(2))
    yt, bt, pt = simulate_random_response(t, 5, mt.Poisson(),
                                          rng=np.random.default_rng(2))
    np.testing.assert_array_equal(yd, yt)
    np.testing.assert_array_equal(bd, bt)
    for dist in ("negativebinomial", "gamma"):
        with pytest.raises(ValueError, match="LogLink"):
            simulate_random_response(t, 5, dist, "identity")
    with pytest.raises(ValueError, match="cannot simulate"):
        simulate_random_response(t, 5, "binomial")


def test_state_from_numpy_carries_nb_r(geno):
    """The JAX package's initial NB state as the port's, nb_r included."""
    g, t = geno
    y, _, _ = m.simulate_random_response(g, 5, "negativebinomial",
                                         rng=np.random.default_rng(1))
    op, data, cfg, k = jfit.build_fit(y, g, None, k=5, d="negativebinomial",
                                      est_r="newton")
    ks = jnp.asarray([k], jnp.int32)
    cw = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    sj = jinit_state(op, data, cfg, ks, cw)
    arrays = {f.name: np.asarray(getattr(sj, f.name))
              for f in dataclasses.fields(sj)}
    arrays["nb_r"] = np.array([2.5], np.float32)
    st = IHTState.from_numpy(arrays, "cpu")
    assert st.nb_r.dtype == torch.float32 and st.nb_r.tolist() == [2.5]
    assert cfg.est_r == "newton"
