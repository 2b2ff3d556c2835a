"""Parity of the port's out-of-core genotypes (``ops/streaming.py``,
``models/streamed.py``, ``models/mv_streamed.py``) with the JAX package's,
on the CPU.

Both packages get the same words: one ``mendeliht_tpu.PackedGenotypes``
and its ``np.asarray(words)``.  The port streams tiny blocks (at least 8
a pass) so every call runs the block loop; the JAX package streams a few
larger ones (its result does not depend on the blocks beyond f32 order,
and its eager block loop costs a second a pass at 4-SNP blocks).  The ops
and the univariate fits are held to the JAX package's streamed path; the
cv and the multivariate fit and cv, whose host-stepped JAX runs take
10-14 s each here, to its resident solver, which its own
tests/test_streaming.py holds equal to its streamed one at these
tolerances.

Tolerances.  The ops within 2e-5 of their scale (tests/test_pallas.py's
bound; f32 sums in another order).  Inside the port the forward products
and column gathers read the same bytes in the same order, so they equal
the resident ``PackedOp``'s bit for bit; the score and moments are held
within 2e-5, since on the CPU every block is its own f32 GEMM and the BLAS
picks its kernel, and with it the order of a column's sums, by the
block's row count (at m = 1 a block's sums differ from the whole
matrix's in the last place).  Whole fits against the JAX package's
streamed fit within the families' plateau spread (tests/
test_torch_families.py: the same support, iterations within 3, betas
within 2e-3 of max|beta|, logl within 1e-4 relative); cvs within 1e-4
relative with the same best k; the multivariate fit and cv within
``MV_SPREAD`` (5e-4, tests/test_torch_mv.py).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.genotype.snparray import PackedGenotypes as JG
from mendeliht_tpu.models.mv import cv_mv_iht as jcv_mv
from mendeliht_tpu.ops import streaming as jstreaming

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models.mv import cv_mv_iht as tcv_mv
from mendeliht_tpu_torch.ops import streaming as tstreaming
from mendeliht_tpu_torch.ops.linalg import PackedOp, make_operator

TOL = 2e-5
SPREAD = 2e-3
MV_SPREAD = 5e-4
PORT_BLOCK = 2048          # 4 SNPs a block at n4 = 512
JAX_BLOCK = 2048 * 25      # 100 SNPs a block


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's many small ops (as in
    tests/test_torch_mv.py), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n, p, missing=False):
    rng = np.random.default_rng(seed)
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p), p=probs)
    return JG.from_codes(codes), rng


def _port(g):
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


def _jax_stream(g, resident_bytes=0, block_bytes=JAX_BLOCK):
    return jstreaming.HostStreamedGenotypes.from_snparray(
        g, block_bytes=block_bytes, resident_bytes=resident_bytes)


def _port_stream(t, resident_bytes=0, block_bytes=PORT_BLOCK):
    return mt.HostStreamedGenotypes.from_snparray(
        t, block_bytes=block_bytes, resident_bytes=resident_bytes)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.max(np.abs(got - want)) <= tol * scale, \
        np.max(np.abs(got - want)) / scale


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def op_case():
    g, rng = _problem(1, 150, 90, missing=True)
    R = rng.standard_normal((3, 4 * g.words.shape[1])).astype(np.float32)
    R[:, g.n:] = 0.0
    idx = rng.integers(0, g.p, size=(3, 7))
    coef = rng.standard_normal((3, 7)).astype(np.float32)
    valid = (rng.random((3, 7)) < 0.8).astype(np.float32)
    return g, R, idx, coef, valid


# resident quad rows of the prefix: none, some, all
RESIDENT = {"none": 0, "part": 10, "all": 10**6}


@pytest.mark.parametrize("resident", list(RESIDENT))
def test_streamed_ops_match_jax_and_resident(op_case, resident):
    g, R, idx, coef, valid = op_case
    t = _port(g)
    nbytes = RESIDENT[resident] * g.words.shape[1] * 4
    s = _port_stream(t, resident_bytes=nbytes)
    sop = make_operator(s)
    assert isinstance(sop, tstreaming.StreamedPackedOp)
    assert sop.p_res == min(4 * RESIDENT[resident], g.p)
    if resident != "all":
        assert len(sop._blocks()) >= 8
    if sop.prefix is not None:
        assert sop.prefix.words_t is None          # kernel 1's layout only
    jop = jstreaming.StreamedPackedOp(_jax_stream(g, resident_bytes=nbytes))
    rop = PackedOp(t)
    Rt = torch.from_numpy(R)
    for m_ in (1, 3):
        got = sop.xtr(Rt[:m_])
        _close(got, np.asarray(jop.xtr(jnp.asarray(R[:m_]))))
        _close(got, rop.xtr(Rt[:m_]))
    W, WY = Rt[:2].abs(), Rt[:2].abs() * Rt[1:]
    for a, b, c in zip(sop.col_moments(W, WY),
                       jop.col_moments(jnp.asarray(W), jnp.asarray(WY)),
                       rop.col_moments(W, WY)):
        _close(a, np.asarray(b))
        _close(a, c)
    ti, tc, tv = map(torch.from_numpy, (idx, coef, valid))
    got = sop.forward_sel(ti, tc, tv)
    _close(got, np.asarray(jop.forward_sel(jnp.asarray(idx),
                                           jnp.asarray(coef),
                                           jnp.asarray(valid))))
    assert torch.equal(got, rop.forward_sel(ti, tc, tv))
    tc3 = torch.from_numpy(np.stack([coef, 2 * coef], axis=1))
    assert torch.equal(sop.forward_sel_multi(ti, tc3, tv),
                       rop.forward_sel_multi(ti, tc3, tv))
    got = sop.gather_cols(ti, tv.bool())
    _close(got, np.asarray(jop.gather_cols(jnp.asarray(idx),
                                           jnp.asarray(valid.astype(bool)))))
    assert torch.equal(got, rop.gather_cols(ti, tv.bool()))
    # on the CPU the blocks are views of the host words: nothing copied
    assert sop.copies == 0 and np.shares_memory(sop._host.numpy(), s.words)
    if sop.prefix is not None:
        assert np.shares_memory(sop.prefix.words.numpy(), s.words)


def test_host_streamed_genotypes_fields(op_case):
    g = op_case[0]
    s = _port_stream(_port(g))
    j = _jax_stream(g, block_bytes=PORT_BLOCK)
    np.testing.assert_array_equal(s.words, j.words_np)
    assert (s.n, s.p, s.n_pad, s.block_p, s.has_missing) == \
        (j.n, j.p, j.n_pad, j.block_p, j.has_missing)
    assert s.shape == (g.n, g.p) and s.device.type == "cpu"
    assert s.dtype == torch.float32
    assert "host" in repr(s) and "block_p=4" in repr(s)


def test_resident_budget_from_environment(op_case, monkeypatch):
    g = op_case[0]
    s = _port_stream(_port(g), resident_bytes=None)
    name = "MENDELIHT_STREAM_RESIDENT_BYTES"
    monkeypatch.delenv(name, raising=False)
    assert tstreaming._resident_budget() == 10 * 2**30
    assert make_operator(s).p_res == g.p              # 10 GiB holds it all
    monkeypatch.setenv(name, str(12 * g.words.shape[1] * 4))
    assert make_operator(s).p_res == 48
    monkeypatch.setenv(name, "0")
    assert make_operator(s).p_res == 0
    monkeypatch.setenv(name, "10GiB")
    with pytest.raises(ValueError, match=name):
        make_operator(s)


def test_operators_share_the_resident_prefix(op_case):
    """Every operator over the same genotypes (each fit_iht / cv_iht call
    builds one) reuses the prefix the first made; a new budget makes a
    new one, and the scores do not change."""
    g, R = op_case[:2]
    row = g.words.shape[1] * 4
    s = _port_stream(_port(g), resident_bytes=10 * row)
    a, b = make_operator(s), make_operator(s)
    assert b.prefix.words is a.prefix.words and a.p_res == 40
    s.resident_bytes = 5 * row
    c = make_operator(s)
    assert c.p_res == 20 and c.prefix.words.shape[0] == 5
    assert make_operator(s).prefix.words is c.prefix.words
    Rt = torch.from_numpy(R)
    assert torch.equal(c.forward_sel(*(torch.from_numpy(x) for x in
                                       op_case[2:])),
                       a.forward_sel(*(torch.from_numpy(x) for x in
                                       op_case[2:])))
    _close(c.xtr(Rt), a.xtr(Rt))


def test_make_operator_rejects_other_types():
    with pytest.raises(TypeError, match="unsupported design matrix type"):
        make_operator(object())


def test_streamed_genotypes_need_a_device(tmp_path, monkeypatch):
    """Without a device and without a card, building raises rather than
    fall back to the CPU."""
    x, _ = m.simulate_random_snparray(str(tmp_path / "s.bed"), 20, 9,
                                      rng=np.random.default_rng(3))
    m.make_bim_fam_files(x, np.zeros(20), str(tmp_path / "s"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.HostStreamedGenotypes.from_plink(str(tmp_path / "s"))


def test_from_plink_matches_jax_and_read_plink(tmp_path):
    rng = np.random.default_rng(4)
    x, _ = m.simulate_random_snparray(str(tmp_path / "s.bed"), 83, 61,
                                      rng=rng)
    m.make_bim_fam_files(x, rng.standard_normal(83), str(tmp_path / "s"))
    prefix = str(tmp_path / "s")
    s = mt.HostStreamedGenotypes.from_plink(prefix, device="cpu",
                                            block_bytes=PORT_BLOCK)
    j = jstreaming.HostStreamedGenotypes.from_plink(prefix)
    r = mt.read_plink(prefix, device="cpu").snparray
    assert (s.n, s.p, s.has_missing) == (83, 61, r.has_missing)
    assert isinstance(s.words, np.ndarray) and s.words.dtype == np.int32
    np.testing.assert_array_equal(s.words, j.words_np)
    np.testing.assert_array_equal(s.words, r.words.numpy())
    assert torch.equal(s.mu, r.mu) and torch.equal(s.inv_sd, r.inv_sd)
    np.testing.assert_allclose(s.mu.numpy(), np.asarray(j.mu), atol=1e-6)
    assert s.block_bytes == PORT_BLOCK and s.resident_bytes is None


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

# case: (family, options)
FITS = {
    "normal": ("Normal", {}),
    "bernoulli": ("Bernoulli", {}),
    "poisson": ("Poisson", {}),
    "debias-weights": ("Normal", dict(debias=True)),
}


@pytest.fixture(scope="module")
def fit_problem():
    g, rng = _problem(602, 300, 400)
    ys = {}
    for name, (family, _) in FITS.items():
        ys[name] = m.simulate_random_response(
            g, 5, getattr(m, family)(),
            rng=np.random.default_rng(700 + len(ys)))[0]
    return g, ys


def _fit_kw(name, p, pkg=m):
    family, options = FITS[name]
    kw = dict(options, d=getattr(pkg, family)(), k=5, max_iter=50,
              verbose=False)
    if name == "debias-weights":
        kw["weight"] = np.linspace(0.5, 1.5, p)
    return kw


@pytest.fixture(scope="module")
def jax_fits(fit_problem):
    g, ys = fit_problem
    return {name: m.fit_iht(ys[name], _jax_stream(g), **_fit_kw(name, g.p))
            for name in FITS}


def _assert_fits_agree(a, b, spread=SPREAD):
    assert np.flatnonzero(a.beta).tolist() == np.flatnonzero(b.beta).tolist()
    assert abs(a.iter - b.iter) <= 3
    _close(a.beta, b.beta, tol=spread)
    assert a.logl == pytest.approx(b.logl, rel=1e-4)


@pytest.mark.parametrize("name", list(FITS))
def test_streamed_fit_matches_jax(fit_problem, jax_fits, name):
    g, ys = fit_problem
    t = _port(g)
    kw = _fit_kw(name, g.p, mt)
    got = mt.fit_iht(ys[name], _port_stream(t), **kw)
    _assert_fits_agree(got, jax_fits[name])
    _assert_fits_agree(got, mt.fit_iht(ys[name], t, **kw))


def test_streamed_hybrid_fit_matches_jax(fit_problem, jax_fits):
    g, ys = fit_problem
    s = _port_stream(_port(g), resident_bytes=30 * g.words.shape[1] * 4)
    assert 0 < make_operator(s).p_res < g.p
    got = mt.fit_iht(ys["normal"], s, **_fit_kw("normal", g.p, mt))
    _assert_fits_agree(got, jax_fits["normal"])


def test_streamed_fit_io_tee(fit_problem):
    """The per-iteration lines go to ``io`` and stdout, as from the JAX
    package's streamed fit."""
    g, ys = fit_problem
    buf, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out):
        r = mt.fit_iht(ys["normal"], _port_stream(_port(g)), k=5,
                       max_iter=50, verbose=True, io=buf)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Iteration ")]
    assert len(lines) == r.iter
    assert lines[0].startswith("Iteration 1: loglikelihood = ")
    assert "backtracks = " in lines[0] and "tol = " in lines[0]
    assert all(ln in out.getvalue() for ln in lines)


# ---------------------------------------------------------------------------
# cv and the multivariate path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cv_problem():
    g, rng = _problem(20260820, 200, 150)
    y = m.simulate_random_response(g, 4, m.Normal(), rng=rng)[0]
    folds = np.random.default_rng(5).integers(1, 4, size=g.n)
    return g, y, folds


def test_streamed_cv_matches_jax(cv_problem):
    g, y, folds = cv_problem
    t = _port(g)
    kw = dict(path=range(1, 8), q=3, folds=folds, verbose=False)
    want = m.cv_iht(y, g, **kw)
    got = mt.cv_iht(y, _port_stream(t), **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.argmin(got) == np.argmin(want)
    np.testing.assert_allclose(got, mt.cv_iht(y, t, **kw), rtol=1e-4)


@pytest.fixture(scope="module")
def mv_problem():
    g, rng = _problem(604, 200, 150)
    Xd = g.to_dense_standardized()
    B = np.zeros((2, g.p))
    for j in rng.choice(g.p, 4, replace=False):
        B[rng.integers(0, 2), j] = rng.standard_normal() * 2
    Y = B @ Xd.T + 0.1 * rng.standard_normal((2, g.n))
    return g, Y


def _mv_agree(a, b):
    assert set(zip(*np.nonzero(a.beta))) == set(zip(*np.nonzero(b.beta)))
    assert abs(a.iter - b.iter) <= 1
    for x, y in ((a.beta, b.beta), (a.Sigma, b.Sigma)):
        _close(x, y, tol=MV_SPREAD)
    assert a.logl == pytest.approx(b.logl, rel=1e-5)


def test_streamed_mv_fit_matches_jax(mv_problem):
    g, Y = mv_problem
    t = _port(g)
    kw = dict(k=4, max_iter=40, verbose=False)
    got = mt.fit_iht(Y, _port_stream(t), d=mt.MvNormal(), **kw)
    _mv_agree(got, m.fit_iht(Y, g, d=m.MvNormal(), **kw))
    _mv_agree(got, mt.fit_iht(Y, t, **kw))


def test_streamed_mv_cv_matches_jax(mv_problem):
    g, Y = mv_problem
    t = _port(g)
    kw = dict(path=range(1, 5), q=3, verbose=False,
              folds=np.random.default_rng(5).integers(1, 4, size=g.n))
    got = tcv_mv(Y, _port_stream(t), **kw)
    np.testing.assert_allclose(got, jcv_mv(Y, g, **kw), rtol=1e-4)
    np.testing.assert_allclose(got, tcv_mv(Y, t, **kw), rtol=1e-4)


def test_streamed_entries_equal_the_solver(cv_problem):
    """``models/streamed.py`` and ``mv_streamed.py`` name the fit and cv
    that ``fit_iht`` / ``cv_iht`` run on a streamed operator, and give
    their results bit for bit."""
    from mendeliht_tpu_torch.models import fit as tfit
    from mendeliht_tpu_torch.models import mv as tmv
    from mendeliht_tpu_torch.models import mv_streamed, streamed, univariate
    assert streamed.fit_fused_sparse_host is tfit.fit_fused_sparse
    assert streamed.cv_fused_host is univariate.cv_fused
    assert mv_streamed.fit_mv_host is tmv.fit_mv
    assert mv_streamed.cv_mv_host is tmv.cv_mv
    g, y, folds = cv_problem
    op, data, cfg, _ = tfit.build_fit(y, _port_stream(_port(g)), None, k=4)
    cv_wts = data.sample_mask[None, :]
    a = streamed.fit_fused_sparse_host(op, data, cfg, [4], cv_wts)
    b = tfit.fit_fused_sparse(op, data, cfg, [4], cv_wts)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    ks = torch.tensor([2, 4])
    tr = torch.stack([data.sample_mask, data.sample_mask])
    te = torch.zeros_like(tr)
    te[:, :10] = 1.0
    assert torch.equal(streamed.cv_fused_host(op, data, cfg, ks, tr, te),
                       univariate.cv_fused(op, data, cfg, ks, tr, te))
