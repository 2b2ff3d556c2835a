"""Parity of the port's cross-validation slice with the JAX package, on the
CPU: the transposed dual layout and its score, the read probe's plain
version, ``cv_iht`` and ``iht_run_many_models``.

The same numpy inputs, made from seeds, go through both packages.  The JAX
side runs on the CPU XLA backend (tests/conftest.py), its transposed Pallas
kernel in interpret mode as tests/test_pallas.py runs it.  Tolerances: the
score within 2e-5 of the output's scale (f32 sums in another order, the
bound tests/test_pallas.py holds the Pallas kernels to); cv mse vectors
within 1e-4 relative with the same best k, and path loglikelihoods within
the fit tolerance of tests/test_torch_fit.py (1e-4 relative).
"""

import contextlib
import io
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.genotype import snparray as jsnp
from mendeliht_tpu.models import cv as jcv
from mendeliht_tpu.models import fit as jfit
from mendeliht_tpu.models import streamed as jstreamed
from mendeliht_tpu.models import univariate as juni
from mendeliht_tpu.models.initialize import init_state as jinit_state
from mendeliht_tpu.ops import decode as jdecode
from mendeliht_tpu.ops import pallas_kernels as jpk

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import cv as tcv
from mendeliht_tpu_torch.models import fit as tfit
from mendeliht_tpu_torch.models import univariate as tuni
from mendeliht_tpu_torch.models.initialize import init_state as tinit_state
from mendeliht_tpu_torch.ops import decode as tdecode
from mendeliht_tpu_torch.ops import kernels as tkernels
from mendeliht_tpu_torch.ops import linalg as tlinalg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 2e-5


def _codes(rng, n, p, missing=True):
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    return rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)


def _words_t_host(packed_np):
    """Host oracle of the transposed word view (tests/test_pallas.py)."""
    p, n4 = packed_np.shape
    wh = np.ascontiguousarray(packed_np).view(np.dtype("<i4")).reshape(p, -1)
    return np.ascontiguousarray(wh.T)


def _port(g):
    """The port's PackedGenotypes holding the JAX package's arrays."""
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the dual layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p,chunk_q", [(100, 23, 2), (600, 37, 3),
                                         (1, 4, 1)])
def test_build_words_t_matches_jax(n, p, chunk_q):
    rng = np.random.default_rng(41)
    codes = _codes(rng, n, p)
    g = jsnp.PackedGenotypes.from_codes(codes, sample_major=False)
    t = _port(g)
    got = tkernels.build_words_t(t.words, p, chunk_q=chunk_q).numpy()
    want = np.asarray(jpk.build_words_t(g.words, p, chunk_q=chunk_q))
    assert got.dtype == np.int32
    assert got.shape == (g.words.shape[1] // 4, 4 * g.words.shape[0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :p],
                                  _words_t_host(jsnp.pack_codes(codes)))
    assert not np.any(got[:, p:])                    # pad SNP columns zero


def test_build_words_t_rejects_bad_p():
    words = torch.zeros((3, 512), dtype=torch.int32)
    for p in (8, 13):
        with pytest.raises(ValueError):
            tkernels.build_words_t(words, p)


def test_with_dual_layout_in_place_and_idempotent():
    rng = np.random.default_rng(42)
    g = jsnp.PackedGenotypes.from_codes(_codes(rng, 90, 21),
                                        sample_major=False)
    t = _port(g)
    assert t.words_t is None
    assert t.with_dual_layout() is t
    wt = t.words_t
    np.testing.assert_array_equal(wt.numpy(),
                                  np.asarray(g.with_dual_layout().words_t))
    assert t.with_dual_layout() is t and t.words_t is wt   # built once


# ---------------------------------------------------------------------------
# (b) the transposed score: plain version vs Pallas (interpret) and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want_missing", [False, True])
@pytest.mark.parametrize("want_sq", [False, True])
@pytest.mark.parametrize("n,p,m", [(200, 40, 1), (130, 37, 5)])
def test_xt_dots_words_t_parity(want_missing, want_sq, n, p, m):
    rng = np.random.default_rng(43)
    codes = _codes(rng, n, p, missing=want_missing)
    packed = jsnp.pack_codes(codes)
    n4 = packed.shape[1]
    g = jsnp.PackedGenotypes.from_codes(codes, sample_major=False)
    wt_j = jpk.build_words_t(g.words, p)
    rhs = rng.standard_normal((4 * n4, m)).astype(np.float32)
    kw = dict(want_missing=want_missing, want_sq=want_sq)
    oracle = jdecode.xt_dots(jnp.asarray(packed), jnp.asarray(rhs), **kw)
    pallas = jpk.xt_dots_words_t(wt_j, jnp.asarray(rhs), tp=8, tw=16,
                                 interpret=True, p=p, **kw)
    wt = torch.from_numpy(np.array(wt_j))
    got = tkernels.xt_dots_words_t(wt, torch.from_numpy(rhs), p=p, **kw)
    plain = tdecode.xt_dots_words_t(wt, torch.from_numpy(rhs), p=p, **kw)
    for k, wanted in enumerate((True, want_missing, want_sq)):
        if not wanted:
            assert got[k] is None and plain[k] is None
            continue
        assert got[k].shape == (p, m)
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
        assert _rel_err(got[k], oracle[k]) < TOL
        assert _rel_err(got[k], pallas[k]) < TOL


def test_xt_dots_words_t_keeps_pad_columns_without_p():
    rng = np.random.default_rng(44)
    codes = _codes(rng, 70, 6)
    words = torch.from_numpy(jsnp._bytes_to_words(jsnp.pack_codes(codes)))
    wt = tkernels.build_words_t(words, 6)
    rhs = torch.from_numpy(rng.standard_normal((4 * words.shape[1], 2))
                           .astype(np.float32))
    A, M, S = tdecode.xt_dots_words_t(wt, rhs, want_missing=True,
                                      want_sq=True)
    quad = tdecode.xt_dots(words, rhs, want_missing=True, want_sq=True)
    for out, ref in zip((A, M, S), quad):
        assert out.shape == (8, 2)
        assert torch.all(out[6:] == 0)
        assert _rel_err(out, ref) < TOL


def test_xt_dots_words_t_nan_column():
    """A NaN anywhere in an rhs column poisons that column and no other,
    as the Pallas kernel re-poisons it."""
    rng = np.random.default_rng(45)
    codes = _codes(rng, 130, 37)
    g = jsnp.PackedGenotypes.from_codes(codes, sample_major=False)
    wt_j = jpk.build_words_t(g.words, 37)
    rhs = rng.standard_normal((g.n_pad, 5)).astype(np.float32)
    rhs[7, 2] = np.nan
    pallas = jpk.xt_dots_words_t(wt_j, jnp.asarray(rhs), want_missing=True,
                                 want_sq=True, tp=16, tw=16, interpret=True,
                                 p=37)
    got = tkernels.xt_dots_words_t(torch.from_numpy(np.array(wt_j)),
                                   torch.from_numpy(rhs), want_missing=True,
                                   want_sq=True, p=37)
    ok = [0, 1, 3, 4]
    for out, ref in zip(got, pallas):
        arr = out.numpy()
        assert np.all(np.isnan(arr[:, 2]))
        assert np.all(np.isfinite(arr[:, ok]))
        assert _rel_err(arr[:, ok], np.asarray(ref)[:, ok]) < TOL


@pytest.mark.parametrize("bad", ["dtype", "shape", "pad", "device"])
def test_xt_dots_words_t_rejects_bad_inputs(bad):
    wt = torch.zeros((32, 8), dtype=torch.int32)
    rhs = torch.zeros((512, 2))
    if bad == "dtype":
        wt = wt.to(torch.int64)
    elif bad == "shape":
        rhs = rhs[1:]
    elif bad == "pad":
        wt = wt[:, :6]
    else:
        wt, rhs = wt.to("meta"), rhs.to("meta")
    with pytest.raises(ValueError):
        tkernels.xt_dots_words_t(wt, rhs, want_missing=False)


# ---------------------------------------------------------------------------
# (c) the operator's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
def test_xtr_same_with_and_without_dual_layout(missing):
    rng = np.random.default_rng(46)
    g = jsnp.PackedGenotypes.from_codes(_codes(rng, 130, 45, missing),
                                        sample_major=False)
    mask = np.zeros(g.n_pad, np.float32)
    mask[:g.n] = 1.0
    R = torch.from_numpy(rng.standard_normal((3, g.n_pad))
                         .astype(np.float32) * mask)
    quad = tlinalg.PackedOp(_port(g)).xtr(R)
    dual = tlinalg.PackedOp(_port(g).with_dual_layout()).xtr(R)
    assert quad.shape == dual.shape == (3, 45)
    assert _rel_err(dual, quad) < TOL
    dense = R.numpy()[:, :g.n] @ g.to_dense_standardized()
    assert _rel_err(dual, dense) < TOL


def _record_score_calls(monkeypatch):
    calls = []
    for name in ("xt_dots_words", "xt_dots_words_t"):
        real = getattr(tkernels, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tkernels, name, spy)
    return calls


def test_xt_dots_dispatch_follows_layout_and_width(monkeypatch):
    """The card's choice of score kernel, as the JAX package picks its
    Pallas kernel: the transposed words (kernel 2) where ``words_t`` is
    stored and m is at most ``MENDELIHT_VT_MAX_M``, else the quad words."""
    rng = np.random.default_rng(47)
    g = jsnp.PackedGenotypes.from_codes(_codes(rng, 60, 12),
                                        sample_major=False)
    quad, dual = _port(g), _port(g).with_dual_layout()
    picks = [tlinalg.transposed_score(quad, 3),
             tlinalg.transposed_score(dual, 3)]
    monkeypatch.setenv("MENDELIHT_VT_MAX_M", "2")
    picks += [tlinalg.transposed_score(dual, 3),     # m = 3 > 2: quad words
              tlinalg.transposed_score(dual, 2)]
    assert picks == [False, True, False, True]
    monkeypatch.delenv("MENDELIHT_VT_MAX_M")
    assert tlinalg.transposed_score(dual, tlinalg._VT_MAX_M)
    assert not tlinalg.transposed_score(dual, tlinalg._VT_MAX_M + 1)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("missing", [False, True])
def test_cpu_operator_runs_f32_function_whatever_layout(monkeypatch, dual,
                                                        missing):
    """A CPU ``PackedOp``, with or without ``words_t``, calls neither score
    wrapper and equals the f32 function ``decode.xt_dots``, as the JAX
    package's operator runs ``decode.xt_dots`` off the TPU."""
    rng = np.random.default_rng(49)
    g = jsnp.PackedGenotypes.from_codes(_codes(rng, 130, 45, missing),
                                        sample_major=False)
    t = _port(g).with_dual_layout() if dual else _port(g)
    calls = _record_score_calls(monkeypatch)
    RT = torch.from_numpy(rng.standard_normal((g.n_pad, 3))
                          .astype(np.float32))
    op = tlinalg.PackedOp(t)
    for want_sq in (False, True):
        got = op._xt_dots(RT, want_sq=want_sq)
        want = tdecode.xt_dots(t.words, RT, want_missing=missing,
                               want_sq=want_sq, p=45)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    op.xtr(RT.T)
    assert calls == []


@pytest.mark.parametrize("name", ["MENDELIHT_VT_MAX_M",
                                  "MENDELIHT_DUAL_MAX_BYTES"])
def test_malformed_env_override_raises(monkeypatch, name):
    monkeypatch.setenv(name, "3GiB")
    with pytest.raises(ValueError, match=name):
        tlinalg._env_int(name, 1)
    monkeypatch.setenv(name, "7")
    assert tlinalg._env_int(name, 1) == 7
    monkeypatch.delenv(name)
    assert tlinalg._env_int(name, 1) == 1


def test_make_operator_builds_no_dual_layout_on_cpu():
    rng = np.random.default_rng(48)
    t = _port(jsnp.PackedGenotypes.from_codes(_codes(rng, 60, 12),
                                              sample_major=False))
    op = tlinalg.make_operator(t)
    assert op.geno is t and t.words_t is None
    assert tlinalg.make_operator(op) is op          # an operator passes
    # a dense matrix raised NotImplementedError before DenseOp was ported:
    # now a DenseOp on the device asked for; another type raises the JAX
    # package's TypeError (NotImplementedError before the streamed
    # genotypes were ported)
    dense = tlinalg.make_operator(torch.zeros((4, 4), dtype=torch.float64))
    assert isinstance(dense, tlinalg.DenseOp) and dense.n_pad == 4
    assert dense.dtype == torch.float32 and dense.device.type == "cpu"
    with pytest.raises(TypeError, match="unsupported design matrix type"):
        tlinalg.make_operator(object())


# ---------------------------------------------------------------------------
# (d) the read probe's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [0, -7, 2**31 - 1])
def test_read_words_wraps_like_int32(c):
    rng = np.random.default_rng(49)
    words = rng.integers(-2**31, 2**31, size=(37, 512), dtype=np.int64)
    words = words.astype(np.int32)
    want = np.int64(c) + words.astype(np.int64).sum()
    want = np.array([want % 2**32], np.uint64).astype(np.uint32).view(np.int32)
    ct = torch.tensor([c], dtype=torch.int32)
    for fn in (tdecode.read_words, tkernels.read_words):
        got = fn(torch.from_numpy(words), ct)
        assert got.dtype == torch.int32 and got.shape == (1,)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (e) cross-validation against the JAX package
# ---------------------------------------------------------------------------

def test_allocate_fold_and_k_matches_jax():
    for q, path in ((3, [5, 10]), (5, list(range(1, 21))), (1, [4])):
        assert tcv.allocate_fold_and_k(q, path) == jcv.allocate_fold_and_k(
            q, path)


def test_meanloss_matches_jax():
    rng = np.random.default_rng(50)
    for q, npath in ((2, 2), (5, 20), (3, 7)):
        folds = rng.integers(1, q + 1, size=97)
        losses = rng.random(q * npath) * 100
        np.testing.assert_array_equal(tcv.meanloss(losses, q, folds),
                                      jcv.meanloss(losses, q, folds))


@pytest.fixture(scope="module")
def plain_problem():
    """No missing genotypes, intercept only; fixed folds."""
    rng = np.random.default_rng(51)
    x, _ = m.simulate_random_snparray(None, 300, 500, rng=rng)
    y, _, _ = m.simulate_random_response(x, 4, m.Normal(), rng=rng)
    folds = np.tile(np.arange(1, 4), 100)
    return x, y, folds


@pytest.fixture(scope="module")
def missing_cov_problem():
    """Missing genotypes plus an intercept and one covariate."""
    rng = np.random.default_rng(52)
    n, p = 280, 400
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    causal = rng.choice(p, 4, replace=False)
    cov = rng.standard_normal(n)
    y = (g.to_dense_standardized()[:, causal] @ rng.choice([-1.0, 1.0], 4)
         + 0.5 * cov + 1.0 + rng.standard_normal(n))
    return g, y, np.stack([np.ones(n), cov], axis=1)


PLAIN_PATH = list(range(1, 8))


def _run(fn, *args, **kwargs):
    """fn's result, stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*args, **kwargs)
    return res, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def jax_plain_cv(plain_problem):
    x, y, folds = plain_problem
    return _run(m.cv_iht, y, x, path=PLAIN_PATH, q=3, folds=folds,
                verbose=True)


def _assert_mse_agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


_TIMING = re.compile(r"Cross validation took [0-9.]+ seconds")


def test_cv_fixed_folds_matches_jax(plain_problem, jax_plain_cv):
    x, y, folds = plain_problem
    want, want_out, _ = jax_plain_cv
    got, got_out, _ = _run(mt.cv_iht, y, _port(x), path=PLAIN_PATH, q=3,
                           folds=folds, verbose=True)
    _assert_mse_agree(got, want)
    # the printed table carries the mse digits; same lines apart from them
    # and the timing
    assert _TIMING.search(got_out) and _TIMING.search(want_out)
    def cells(out):
        return [ln.split("\t")[:2] for ln in _TIMING.sub("", out).splitlines()]

    assert cells(got_out) == cells(want_out)
    assert "Best k = " in got_out


def test_cv_rng_missing_covariate_matches_jax(missing_cov_problem):
    g, y, z = missing_cov_problem
    assert g.has_missing
    path = [1, 3, 4, 6]
    want = m.cv_iht(y, g, z, path=path, q=4, verbose=False,
                    rng=np.random.default_rng(7))
    got = mt.cv_iht(y, _port(g), z, path=path, q=4, verbose=False,
                    rng=np.random.default_rng(7))
    _assert_mse_agree(got, want)


def test_cv_progress_matches_jax(plain_problem, jax_plain_cv):
    x, y, folds = plain_problem
    want, _, want_err = _run(m.cv_iht, y, x, path=PLAIN_PATH, q=3,
                             folds=folds, verbose=False, show_progress=True)
    got, got_out, got_err = _run(mt.cv_iht, y, _port(x), path=PLAIN_PATH,
                                 q=3, folds=folds, verbose=False,
                                 show_progress=True)
    _assert_mse_agree(got, want)
    _assert_mse_agree(got, jax_plain_cv[0])
    assert got_out == ""
    # one line per segment of 5 iterations, in the JAX package's words; a
    # task whose convergence test sits at the tolerance may stop one
    # iteration apart in the two packages (f32 sums in another order), so
    # a line's converged count may differ by a task or two
    line = re.compile(r"^Cross-validating: iteration +(\d+), (\d+)/21 "
                      r"models converged$")
    got_lines = [line.match(ln).groups() for ln in got_err.splitlines()]
    want_lines = [line.match(ln).groups() for ln in want_err.splitlines()]
    assert [it for it, _ in got_lines] == [it for it, _ in want_lines]
    for (_, a), (_, b) in zip(got_lines, want_lines):
        assert abs(int(a) - int(b)) <= 2
    assert got_lines[-1] == want_lines[-1] and got_lines[-1][1] == "21"


def test_cv_same_with_dual_layout(plain_problem, jax_plain_cv):
    x, y, folds = plain_problem
    got = mt.cv_iht(y, _port(x).with_dual_layout(), path=PLAIN_PATH, q=3,
                    folds=folds, verbose=False)
    _assert_mse_agree(got, jax_plain_cv[0])


def test_cv_path_too_large(plain_problem):
    x, y, folds = plain_problem
    with pytest.raises(ValueError, match="path"):
        mt.cv_iht(y, _port(x), path=[501], q=3, verbose=False)


def test_iht_run_many_models_matches_jax(plain_problem):
    x, y, _ = plain_problem
    want, want_out, _ = _run(m.iht_run_many_models, y, x, path=[1, 3, 5],
                             verbose=True)
    got, got_out, _ = _run(mt.iht_run_many_models, y, _port(x),
                           path=[1, 3, 5], verbose=True)
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert [ln.split("\t")[:2] for ln in got_out.splitlines()] == \
        [ln.split("\t")[:2] for ln in want_out.splitlines()]
    with pytest.warns(UserWarning, match="parallel=False"):
        mt.iht_run_many_models(y, _port(x), path=[2], verbose=False,
                               parallel=False)


@pytest.mark.parametrize("kwargs,item", [
    (dict(group=np.ones(500, int)), "item 9"), (dict(group=[1, 2]), "item 9"),
    (dict(weight=[1.0]), "item 9"), (dict(zkeep=[True]), "item 9"),
    (dict(debias=True), "item 9"), (dict(init_beta=True), "item 9"),
    (dict(checkpoint_dir="ckpt"), "item 12"),
    (dict(checkpoint_dir="ckpt", checkpoint_every=5), "item 12"),
    (dict(weight=np.ones(500)), "item 9")])
def test_cv_unported_arguments_raise(plain_problem, kwargs, item, tmp_path):
    """Arguments that raised NotImplementedError naming their ROADMAP item.
    Since ported, each gives the JAX package's call: a ``checkpoint_dir``
    (item 12; here under the test's own directory) the JAX package's
    checkpointed mse within this file's tolerance and the same best k,
    with a checkpoint written; the options of item 9 its ValueError for a
    group or weight of the wrong length, else its mse within this file's
    tolerance and the same best k.  With ``debias`` a task's best iterate is chosen by
    the loglikelihood of the iterate before its refit (the reference's
    quirk), and a refit leaves the next iterates' loglikelihoods a few f32
    roundings apart, so the two packages may keep different iterates of a
    task: its holdout deviance is held to the JAX package's where both keep
    the same iterate, and where they do not, the two iterates'
    loglikelihoods must tie within the packages' agreement
    (``_debiased_tasks``)."""
    x, y, folds = plain_problem
    kw = dict(path=[1, 2], q=3, folds=folds, verbose=False, **kwargs)
    if item == "item 12":
        want = m.cv_iht(y, x, **dict(
            kw, checkpoint_dir=str(tmp_path / "jax")))
        got = mt.cv_iht(y, _port(x), **dict(
            kw, checkpoint_dir=str(tmp_path / kwargs["checkpoint_dir"])))
        _assert_mse_agree(got, want)
        assert os.listdir(tmp_path / kwargs["checkpoint_dir"])
        return
    try:
        want = m.cv_iht(y, x, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            mt.cv_iht(y, _port(x), **kw)
        assert str(got.value) == str(err)
        return
    got = mt.cv_iht(y, _port(x), **kw)
    if "debias" not in kwargs:
        _assert_mse_agree(got, want)
        return
    dev_j, dev_t, same = _debiased_tasks(x, y, folds, [1, 2], 3)
    np.testing.assert_allclose(want, jcv.meanloss(dev_j, 3, folds),
                               rtol=1e-4)
    np.testing.assert_allclose(got, tcv.meanloss(dev_t, 3, folds),
                               rtol=1e-6)
    np.testing.assert_allclose(dev_t[same], dev_j[same], rtol=1e-4)
    ks = np.array([k for _, k in tcv.allocate_fold_and_k(3, [1, 2])])
    for i, k in enumerate([1, 2]):
        if same[ks == k].all():
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))


LOGL_ULPS = 4


def _debiased_tasks(x, y, folds, path, q):
    """Each (fold, k) task of a debiased cv, stepped from the host in both
    packages: its holdout deviance in each, and whether both keep the same
    iterate.  Every iterate's loglikelihood agrees within ``LOGL_ULPS`` f32
    roundings (the sums of the two packages differ by up to two); where the
    kept iterates differ, each package's loglikelihoods of the two lie as
    close, so the choice is made below the packages' agreement."""
    combos = jcv.allocate_fold_and_k(q, path)
    ks = np.array([k for _, k in combos], np.int32)
    n = len(y)
    jop, jdata, jcfg, _ = jfit.build_fit(y, x, None, k=max(path),
                                         debias=True, max_iter=100)
    op, data, cfg, _ = tfit.build_fit(y, _port(x), None, k=max(path),
                                      debias=True, max_iter=100)
    train = np.zeros((len(ks), op.n_pad), np.float32)
    test = np.zeros_like(train)
    for i, (fold, _) in enumerate(combos):
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold
    runs = {
        "jax": (jinit_state(jop, jdata, jcfg, jnp.asarray(ks),
                            jnp.asarray(train)),
                lambda st: jstreamed._iteration_host(jop, jdata, jcfg, st),
                lambda st: juni.predict_deviance.__wrapped__(
                    jop, jdata, jcfg,
                    juni.finalize_iht.__wrapped__(jop, jdata, jcfg, st),
                    jnp.asarray(test))),
        "port": (tinit_state(op, data, cfg, torch.from_numpy(ks),
                             torch.from_numpy(train)),
                 lambda st: tuni._iteration(op, data, cfg, st),
                 lambda st: tuni.predict_deviance(
                     op, data, cfg, tuni.finalize_iht(op, data, cfg, st),
                     torch.from_numpy(test)))}
    logls, devs = {}, {}
    for name, (st, step, deviance) in runs.items():
        # the iterates each task's best is chosen from: the first (its
        # loglikelihood -inf), then every one it reaches while active
        seq = [[v] for v in np.asarray(st.logl)]
        while np.asarray(st.active).any() and int(st.iteration) < 99:
            was = np.asarray(st.active)
            st = step(st)
            for b in np.flatnonzero(was):
                seq[b].append(np.asarray(st.logl)[b])
        logls[name] = [np.array(s, np.float32) for s in seq]
        devs[name] = np.asarray(deviance(st), np.float64)
    same = np.zeros(len(ks), bool)
    for b, (lj, lt) in enumerate(zip(logls["jax"], logls["port"])):
        ulps = LOGL_ULPS * np.spacing(np.abs(lj[np.isfinite(lj)]).max())
        assert lt.shape == lj.shape and np.array_equal(np.isinf(lt),
                                                       np.isinf(lj))
        assert np.all(np.abs(lt - lj)[np.isfinite(lj)] <= ulps)
        ij, it = int(np.argmax(lj)), int(np.argmax(lt))
        same[b] = ij == it
        for seq_ in (lj, lt):
            assert abs(seq_[ij] - seq_[it]) <= ulps
    return devs["jax"], devs["port"], same


@pytest.mark.parametrize("kwargs", [
    dict(d="bernoulli"),
    dict(d="negativebinomial", l="log", est_r="MM")])
def test_cv_family_arguments_match_jax(plain_problem, kwargs):
    """The family and est_r arguments, which raised NotImplementedError
    before the families were ported: the cv runs on a response of the
    family and agrees with the JAX package's within the Gaussian cv's
    tolerance, with the same best k."""
    x, _, folds = plain_problem
    y, _, _ = m.simulate_random_response(x, 4, kwargs["d"], kwargs.get("l"),
                                         r=2, rng=np.random.default_rng(56))
    kw = dict(path=[2, 4, 6], q=3, folds=folds, verbose=False, **kwargs)
    _assert_mse_agree(mt.cv_iht(y, _port(x), **kw), m.cv_iht(y, x, **kw))


@pytest.mark.parametrize("kwargs", [
    dict(memory_efficient=False), dict(dtype=torch.float32),
    dict(dtype=np.float32), dict(dtype="float32"), dict(checkpoint_every=10)])
def test_cv_jax_api_arguments_accepted(plain_problem, tmp_path, monkeypatch,
                                       kwargs):
    """cv_iht arguments the JAX package accepts and ignores here (or, for
    ``checkpoint_every`` without a ``checkpoint_dir``, ignores too): the
    mse equals the same call without them, and nothing is written."""
    x, y, folds = plain_problem
    monkeypatch.chdir(tmp_path)
    kw = dict(path=[1, 2, 3], q=3, folds=folds, verbose=False)
    want = mt.cv_iht(y, _port(x), **kw)
    got = mt.cv_iht(y, _port(x), **kw, **kwargs)
    np.testing.assert_array_equal(got, want)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32"])
def test_iht_run_many_models_accepts_float32_dtype(plain_problem, dtype):
    x, y, _ = plain_problem
    want = mt.iht_run_many_models(y, _port(x), path=[1, 3], verbose=False)
    got = mt.iht_run_many_models(y, _port(x), path=[1, 3], verbose=False,
                                 dtype=dtype)
    np.testing.assert_array_equal(got, want)


def test_float64_dtype_raises_in_cv_and_path(plain_problem):
    """A float64 dtype raised NotImplementedError before float64 fits were
    ported: now the cv and the path run in float64, with the float32 runs'
    best k; bfloat16 and None still raise."""
    x, y, folds = plain_problem
    kw = dict(path=[1, 3], q=3, folds=folds, verbose=False)
    mse = mt.cv_iht(y, _port(x), dtype=np.float64, **kw)
    want = mt.cv_iht(y, _port(x), **kw)
    assert np.argmin(mse) == np.argmin(want)
    np.testing.assert_allclose(mse, want, rtol=1e-4)
    logl = mt.iht_run_many_models(y, _port(x), path=[1, 3], verbose=False,
                                  dtype=torch.float64)
    assert np.isfinite(logl).all()
    for bad in (jnp.bfloat16, None):
        with pytest.raises(NotImplementedError,
                           match="float32 or float64 only"):
            mt.cv_iht(y, _port(x), dtype=bad, **kw)
        with pytest.raises(NotImplementedError,
                           match="float32 or float64 only"):
            mt.iht_run_many_models(y, _port(x), path=[1], verbose=False,
                                   dtype=bad)


def test_cv_unported_inputs_raise(plain_problem):
    x, y, _ = plain_problem
    # a design matrix of another type raised NotImplementedError naming
    # item 13 before HostStreamedGenotypes was ported: now the JAX
    # package's TypeError
    with pytest.raises(TypeError, match="unsupported design matrix type"):
        mt.cv_iht(y, object(), path=[1], q=2, verbose=False)
    # use_maf raised NotImplementedError before it was accepted; as in the
    # JAX package it is ignored
    np.testing.assert_array_equal(
        mt.iht_run_many_models(y, _port(x), path=[1], use_maf=True,
                               verbose=False),
        mt.iht_run_many_models(y, _port(x), path=[1], verbose=False))
    with pytest.raises(TypeError, match="unexpected keyword"):
        mt.cv_iht(y, _port(x), path=[1], q=2, no_such_argument=1)


def test_fit_multivariate_y_raises(plain_problem):
    """A y of shape (r, n), r > 1, which raised NotImplementedError before
    the multivariate solver was ported: fit_iht and cv_iht route it to
    ``fit_mv_iht`` / ``cv_mv_iht``, as the JAX package does, with the
    arguments the JAX package passes on, and give their results exactly."""
    from mendeliht_tpu_torch.models import mv as tmv
    x, y, folds = plain_problem
    Y = np.stack([y, 0.5 * y + np.random.default_rng(57).standard_normal(
        len(y))])
    kw = dict(verbose=False, min_iter=3, max_iter=40)
    got = mt.fit_iht(Y, _port(x), k=3, d=mt.MvNormal(), init_beta=True,
                     zkeep=[True], **kw)
    want = tmv.fit_mv_iht(Y, _port(x), k=3, init_beta=True, zkeep=[True],
                          **kw)
    assert isinstance(got, mt.MIHTResult) and got.traits == 2
    np.testing.assert_array_equal(got.beta, want.beta)
    np.testing.assert_array_equal(got.Sigma, want.Sigma)
    assert (got.iter, got.logl) == (want.iter, want.logl)
    kw.update(path=[1, 2], q=3, folds=folds)
    np.testing.assert_array_equal(
        mt.cv_iht(Y, _port(x), init_beta=True, **kw),
        tmv.cv_mv_iht(Y, _port(x), init_beta=True, **kw))
