"""Parity of the PyTorch port's Gaussian fit with the JAX package, on the CPU.

Both packages get the same genotype words, phenotypes and covariates as
numpy.  Tolerances: the two run the same iterates in f32, with sums taken in
another order, so supports must agree as sets and iteration counts exactly,
betas within 1e-4 of max|beta| and loglikelihoods within 1e-4 relative.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import fit as jfit
from mendeliht_tpu.models import streamed as jstreamed
from mendeliht_tpu.models.initialize import init_state as jinit_state

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import fit as tfit
from mendeliht_tpu_torch.models import univariate as tuni
from mendeliht_tpu_torch.models.initialize import init_state as tinit_state
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.utils.simulate import simulate_packed_problem


def _port_genotypes(g):
    """The port's PackedGenotypes holding the JAX package's arrays."""
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


def _support(beta):
    return set(np.flatnonzero(beta).tolist())


def _assert_fits_agree(rj, rt):
    assert _support(rt.beta) == _support(rj.beta)
    assert rt.iter == rj.iter
    scale = max(np.abs(rj.beta).max(), 1e-30)
    assert np.max(np.abs(rt.beta - rj.beta)) <= 1e-4 * scale
    np.testing.assert_allclose(rt.c, rj.c, rtol=1e-4, atol=1e-4 * scale)
    assert abs(rt.logl - rj.logl) <= 1e-4 * abs(rj.logl)
    assert abs(rt.sigma_g - rj.sigma_g) <= 1e-4


@pytest.fixture(scope="module")
def missing_cov_problem():
    """Genotypes with missing calls plus an intercept and one covariate."""
    rng = np.random.default_rng(31)
    n, p = 300, 600
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    causal = rng.choice(p, 5, replace=False)
    x = g.to_dense_standardized()
    cov = rng.standard_normal(n)
    y = x[:, causal] @ rng.choice([-1.0, 1.0], 5) + 0.5 * cov \
        + 1.0 + rng.standard_normal(n)
    z = np.stack([np.ones(n), cov], axis=1)
    return g, y, z


def test_fit_matches_jax_small_sim(small_sim):
    x, y, _, _ = small_sim
    rj = m.fit_iht(y, x, k=5, verbose=False)
    rt = mt.fit_iht(y, _port_genotypes(x), k=5, verbose=False)
    _assert_fits_agree(rj, rt)


def test_fit_matches_jax_missing_and_covariate(missing_cov_problem):
    g, y, z = missing_cov_problem
    assert g.has_missing
    rj = m.fit_iht(y, g, z, k=5, verbose=False)
    rt = mt.fit_iht(y, _port_genotypes(g), z, k=5, verbose=False)
    _assert_fits_agree(rj, rt)
    assert np.all(rt.c != 0)                   # both covariates are kept


def _jax_init(g, y, z, k):
    op, data, cfg, k_scalar = jfit.build_fit(y, g, z, k=k)
    ks = jnp.asarray([k_scalar], jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    return op, data, cfg, jinit_state(op, data, cfg, ks, cv_wts)


def _port_setup(g, y, z, k):
    op, data, cfg, k_scalar = tfit.build_fit(y, _port_genotypes(g), z, k=k)
    return op, data, cfg, k_scalar


def _state_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def test_init_state_matches_jax(missing_cov_problem):
    g, y, z = missing_cov_problem
    *_, sj = _jax_init(g, y, z, 5)
    op, data, cfg, k = _port_setup(g, y, z, 5)
    st = tinit_state(op, data, cfg, [k], data.sample_mask[None, :])
    assert set(st.sel_idx[0].tolist()) == set(np.asarray(sj.sel_idx[0]).tolist())
    for name in ("c", "df", "df2", "zc", "mu"):
        want = np.asarray(getattr(sj, name))
        got = getattr(st, name).numpy()
        assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(st.idc.numpy(), np.asarray(sj.idc))


def test_one_iteration_from_jax_state(missing_cov_problem):
    """Start the port from the JAX package's init_state and compare one
    iteration of both host-stepped loops."""
    g, y, z = missing_cov_problem
    jop, jdata, jcfg, sj = _jax_init(g, y, z, 5)
    op, data, cfg, _ = _port_setup(g, y, z, 5)
    st = IHTState.from_numpy(_state_numpy(sj), "cpu")
    assert st.sel_idx.dtype == torch.int64 and st.iteration == 0

    sj1 = jstreamed._iteration_host(jop, jdata, jcfg, sj)
    st1 = tuni._iteration(op, data, cfg, st)
    assert st1.iteration == int(sj1.iteration) == 1
    assert set(st1.sel_idx[0].tolist()) == set(np.asarray(sj1.sel_idx[0]).tolist())
    eta_j = float(sj1.eta[0])
    assert abs(float(st1.eta[0]) - eta_j) <= 1e-5 * abs(eta_j)
    assert int(st1.backtracks[0]) == int(sj1.backtracks[0])
    for name in ("b", "c", "logl", "df"):
        want = np.asarray(getattr(sj1, name))
        got = getattr(st1, name).numpy()
        assert np.max(np.abs(got - want)) <= 1e-4 * max(1.0, np.abs(want).max())


def test_run_segment_stops_at_max_iter(small_sim):
    """Unconverged tasks stop after max_iter - 1 steps and report max_iter,
    as in the JAX package."""
    x, y, _, _ = small_sim
    rj = m.fit_iht(y, x, k=5, verbose=False, max_iter=3, min_iter=5)
    rt = mt.fit_iht(y, _port_genotypes(x), k=5, verbose=False, max_iter=3,
                    min_iter=5)
    assert rj.iter == rt.iter == 3
    assert _support(rt.beta) == _support(rj.beta)


def test_verbose_fit_prints_progress(small_sim, capsys):
    x, y, _, _ = small_sim
    rt = mt.fit_iht(y, _port_genotypes(x), k=5, verbose=True)
    out = capsys.readouterr().out
    assert "Running sparse linear regression" in out
    assert f"Iteration {rt.iter}: loglikelihood = " in out
    assert "IHT estimated 5 nonzero SNP predictors" in out


@pytest.mark.parametrize("kwargs", [dict(weight=[1.0]), dict(zkeep=[True]),
                                    dict(use_maf=True), dict(debias=True),
                                    dict(group=[1, 2]), dict(init_beta=True),
                                    dict(J=2)])
def test_unported_arguments_raise(small_sim, kwargs):
    """Arguments that raised NotImplementedError before the fit options
    were ported: each call now equals the JAX package's.  A weight or group
    of the wrong length raises its ValueError; ``zkeep``, ``use_maf`` (which
    only prints), ``debias`` and ``J`` without groups (unused) fit as
    fit_iht does, and ``init_beta`` as the JAX package's host-stepped driver
    does (the port's drives its steps from the host too, and the fused
    driver ends this fit on another of its loglikelihood ties), all to this
    file's tolerances."""
    x, y, _, _ = small_sim
    g = _port_genotypes(x)
    try:
        want = m.fit_iht(y, x, k=5, verbose=False, **kwargs)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            mt.fit_iht(y, g, k=5, verbose=False, **kwargs)
        assert str(got.value) == str(err)
        return
    got = mt.fit_iht(y, g, k=5, verbose=False, **kwargs)
    if "init_beta" in kwargs:
        want = _jax_host_fit(y, x, k=5, init_beta=True)
    _assert_fits_agree(want, got)


def _jax_host_fit(y, g, *, k, init_beta):
    """The JAX package's fit_iht through its host-stepped driver (which
    fit_iht runs for streamed genotypes): (beta, c, logl, iter, sigma_g)."""
    op, data, cfg, k_scalar = jfit.build_fit(y, g, None, k=k)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    idx, valid, bc, c, logl, iters, _, sg = jax.device_get(
        jstreamed.fit_fused_sparse_host(op, data, cfg,
                                        jnp.asarray([k_scalar], jnp.int32),
                                        cv_wts, init_beta=init_beta))
    beta = np.zeros(op.p, np.float32)
    keep = valid[0] & (idx[0] < op.p)
    beta[idx[0][keep]] = bc[0][keep]
    return types.SimpleNamespace(beta=beta, c=np.asarray(c[0]),
                                 logl=float(logl[0]), iter=int(iters[0]),
                                 sigma_g=float(sg[0]))


@pytest.mark.parametrize("kwargs", [dict(d="bernoulli"), dict(d="poisson"),
                                    dict(l="log")])
def test_family_arguments_match_jax(small_sim, kwargs):
    """The family and link arguments, which raised NotImplementedError
    before the families were ported: the fit runs and agrees with the JAX
    package's, on a response of the family (a positive one for the Normal
    family's log link).  Tolerances as tests/test_torch_families.py holds
    whole GLM fits: the same support and logl, iterations within 3 and
    betas within 2e-3 of max|beta| (f32 ties on the loglikelihood's
    plateau)."""
    x, _, _, _ = small_sim
    d = kwargs.get("d", "gamma")
    y, _, _ = m.simulate_random_response(x, 5, d, "log" if d == "gamma"
                                         else None,
                                         rng=np.random.default_rng(12))
    rj = m.fit_iht(y, x, k=5, verbose=False, **kwargs)
    rt = mt.fit_iht(y, _port_genotypes(x), k=5, verbose=False, **kwargs)
    assert _support(rt.beta) == _support(rj.beta)
    assert len(_support(rt.beta)) == 5
    assert abs(rt.logl - rj.logl) <= 1e-4 * abs(rj.logl)
    assert abs(rt.iter - rj.iter) <= 3
    scale = np.abs(rj.beta).max()
    assert np.max(np.abs(rt.beta - rj.beta)) <= 2e-3 * scale


def test_unported_defaults_and_unknown_arguments(small_sim):
    x, y, _, _ = small_sim
    g = _port_genotypes(x)
    r = mt.fit_iht(y, g, k=5, verbose=False, debias=False, group=None,
                   est_r="none", J=1)
    assert len(_support(r.beta)) == 5
    with pytest.raises(TypeError, match="unexpected keyword"):
        mt.fit_iht(y, g, k=5, verbose=False, no_such_argument=1)


@pytest.mark.parametrize("kwargs", [
    dict(memory_efficient=False), dict(memory_efficient=True),
    dict(dtype=torch.float32), dict(dtype=np.float32), dict(dtype="float32"),
    dict(dtype=jnp.float32), dict(checkpoint_every=7),
    dict(checkpoint_dir="ckpt"), dict(checkpoint_dir="ckpt",
                                      checkpoint_every=3)])
def test_jax_api_arguments_accepted(small_sim, tmp_path, monkeypatch, kwargs):
    """Arguments the JAX package's fit_iht accepts and ignores here
    (``memory_efficient``; the checkpoint arguments, used only by its
    streamed fits; the float32 ``dtype``): the fit equals the same call
    without them, and no checkpoint is written."""
    x, y, _, _ = small_sim
    g = _port_genotypes(x)
    monkeypatch.chdir(tmp_path)
    want = mt.fit_iht(y, g, k=5, verbose=False)
    got = mt.fit_iht(y, g, k=5, verbose=False, **kwargs)
    np.testing.assert_array_equal(got.beta, want.beta)
    np.testing.assert_array_equal(got.c, want.c)
    assert (got.iter, got.logl) == (want.iter, want.logl)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, "float64",
                                   jnp.bfloat16, None])
def test_other_dtypes_raise(small_sim, dtype):
    """float64, however it is spelled, runs a float64 fit: beta and c
    float64, the float32 fit's support.  A dtype no fit runs in (bfloat16,
    None) raises NotImplementedError naming the two that do."""
    x, y, _, _ = small_sim
    g = _port_genotypes(x)
    if dtype is None or dtype is jnp.bfloat16:
        with pytest.raises(NotImplementedError,
                           match="float32 or float64 only"):
            mt.fit_iht(y, g, k=5, verbose=False, dtype=dtype)
        return
    r = mt.fit_iht(y, g, k=5, verbose=False, dtype=dtype)
    assert r.beta.dtype == np.float64 and np.asarray(r.c).dtype == np.float64
    assert _support(r.beta) == _support(mt.fit_iht(y, g, k=5,
                                                   verbose=False).beta)


@pytest.mark.parametrize("n,p", [(301, 8195), (10, 13)])
def test_simulate_matches_bench_generator(n, p):
    """The port's chunked generator writes the bytes, stats and effects of
    the JAX package's benchmark generator straight into quad words."""
    import bench
    from mendeliht_tpu.genotype.snparray import _bytes_to_words
    packed, mu, inv_sd, has_missing, causal, beta = bench._gen_problem(
        np.random.default_rng(5), n=n, p=p)
    words, mu2, inv2, hm2, causal2, beta2 = simulate_packed_problem(
        np.random.default_rng(5), n, p, k=bench.K)
    np.testing.assert_array_equal(words, _bytes_to_words(packed))
    np.testing.assert_array_equal(mu2, mu)
    np.testing.assert_array_equal(inv2, inv_sd)
    assert hm2 == has_missing is False
    np.testing.assert_array_equal(causal2, causal)
    np.testing.assert_array_equal(beta2, beta)


def test_simulate_missing_counts():
    rng = np.random.default_rng(6)
    words, mu, inv_sd, hm, _, _ = simulate_packed_problem(rng, 200, 33,
                                                          missing=True)
    assert hm
    g = mt.PackedGenotypes.from_numpy(words, mu, inv_sd, n=200, p=33,
                                      has_missing=hm, device="cpu")
    codes = g.to_codes()
    n_mis = (codes == 1).sum(axis=0)
    obs = 200 - n_mis
    want_mu = ((codes == 2).sum(axis=0) + 2.0 * (codes == 3).sum(axis=0)) / obs
    np.testing.assert_allclose(mu, want_mu)
    assert 0.15 < n_mis.sum() / codes.size < 0.35
