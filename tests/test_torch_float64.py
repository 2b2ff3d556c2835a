"""Float64 fits in the port, held to the JAX package's float64 path.

The JAX package runs a float64 fit only with ``jax_enable_x64``, which is
process-global, while every other JAX test runs in f32.  So its side runs
once, in a subprocess (this file run as a script under ``JAX_ENABLE_X64=1
JAX_PLATFORMS=cpu``), which computes every case and writes one ``.npz``;
a module-scoped fixture starts it, and this module imports neither jax
nor the JAX package.  Both sides take the same inputs, made from seeds
with numpy here and passed as files.

Tolerances.
- The plain float64 digit score (``decode.xt_dots_words`` /
  ``xt_dots_words_t`` on a float64 R) within ``1e-13 * n_pad * max|R_col|``
  a column of the unquantised float64 ``decode.xt_dots`` (the function of
  the JAX package's XLA ``decode.xt_dots``); the same bound for M and S.
- Whole fits and cvs: the same support and iterations, beta and c within
  1e-9 of max|beta|, logl within 1e-9 relative, mse within 1e-9 relative.
- Packed against dense in the port (the JAX package's ``x64_worker.py``
  check): beta and c within 1e-10.
- The streamed fit equals the resident one; a float64 checkpoint restores
  as float64, bit for bit.
- On a card (marker ``cuda``): kernels 1 and 2's float64 entries equal the
  plain digit sums and the plain float64 score bit for bit, and a float64
  fit on the card the CPU's.

Torch runs on one thread in this module (as in ``test_torch_mv.py``): the
fits are small and a loaded host's thread pool only slows them.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.genotype.snparray import _bytes_to_words, pack_codes
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.ops.linalg import PackedOp, make_operator

BOUND = 1e-13                 # digit score vs unquantised, x n_pad max|R|
FIT_TOL = 1e-9                # beta / c of max|beta|, logl and mse relative
DENSE_TOL = 1e-10             # packed vs dense, as x64_worker.py
N, P, K = 300, 600, 5         # the fits' genotypes
N_CV, P_CV = 200, 1000        # the cv's
CV_PATH, CV_Q = list(range(1, 9)), 3
M_SCORE = 6                   # the digit score's width against the JAX one
ORACLE_TIMEOUT = 900


def _codes(seed, n, p, missing=True):
    rng = np.random.default_rng(seed)
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    return rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)


def _words(codes):
    return torch.from_numpy(_bytes_to_words(pack_codes(codes)))


def _rhs(seed, n_pad, n, m, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.standard_normal((n_pad, m))).to(dtype)
    r[n:] = 0.0
    return r


# ---------------------------------------------------------------------------
# the float64 digit score, on the CPU
# ---------------------------------------------------------------------------

def test_digits_reconstruct_r_exactly():
    """Eight base-128 digits in [-64, 64], most significant first, whose
    sum is r = round(R / scale) exactly; scale = max|R_col| / 2^55, 2^-55
    for an all-zero column, and a non-finite column's digits are zero."""
    R = _rhs(1, 256, 250, 6)
    R[:, 2] = 0.0
    R[:, 3] *= 1e-300
    R[:, 4] *= 1e300
    R[9, 5] = float("inf")
    planes, scale = decode.quantize_rhs_planes64(R)
    assert planes.dtype == torch.int8 and planes.shape == (48, 256)
    assert int(planes.abs().max()) <= 64
    d = planes.to(torch.int64).view(8, 6, 256)
    rec = sum(d[k] * 128 ** (7 - k) for k in range(8))
    finite = R.t().clone()
    finite[5] = 0.0
    mx = finite.abs().amax(dim=1)
    assert torch.equal(scale, torch.where(mx > 0, mx, torch.ones_like(mx))
                       * 2.0 ** -55)
    r = torch.round(finite / scale[:, None]).to(torch.int64)
    assert torch.equal(rec, r)
    assert int(r.abs().max()) == 2 ** 55
    assert not d[:, 2].any() and not d[:, 5].any()


@pytest.mark.parametrize("case", ["plain", "odd_n", "missing", "zero", "nan"])
def test_digit_score_within_bound_of_unquantised(case):
    """The plain float64 digit score on both layouts (equal to each other
    bit for bit) within 1e-13 * n_pad * max|R_col| of the unquantised
    float64 ``decode.xt_dots``, for A, M and S; odd n, missing calls, an
    all-zero column and a NaN column (NaN there in every output, finite
    elsewhere)."""
    n = 301 if case == "odd_n" else 300
    p, m = 203, 7
    codes = _codes(7, n, p, missing=case != "plain")
    words = _words(codes)
    n_pad = 4 * words.shape[1]
    R = _rhs(8, n_pad, n, m)
    if case == "zero":
        R[:, 3] = 0.0
    if case == "nan":
        R[17, 3] = float("nan")
    words_t = kernels.build_words_t(words, p)
    kw = dict(want_missing=True, want_sq=True, p=p)
    got = decode.xt_dots_words(words, R, **kw)
    dual = decode.xt_dots_words_t(words_t, R, **kw)
    ref = decode.xt_dots(words, R, **kw)
    bound = BOUND * n_pad * R.abs().amax(dim=0)
    for g, t, r in zip(got, dual, ref):
        assert g.dtype == torch.float64 and g.shape == (p, m)
        assert torch.equal(g.isnan(), t.isnan())
        assert torch.equal(g.nan_to_num(), t.nan_to_num())
        if case == "nan":
            assert g[:, 3].isnan().all()
            keep = [0, 1, 2, 4, 5, 6]
            g, r, b = g[:, keep], r[:, keep], bound[keep]
        else:
            b = bound
        assert g.isfinite().all()
        assert ((g - r).abs() <= b[None, :]).all()


def test_raw_sum_layout_is_the_plain_score():
    """The card's float64 path read back on the CPU: the pseudo-column
    digit image (``pseudo_planes64``) run through the f32 kernels' digit
    sums, laid out as the raw-sum entry stores them (row 3c' + d), then
    ``raw_view64`` and ``digit_outputs64``, equals the plain float64
    score bit for bit; and the kernel's plan at m' = 3m."""
    n, p, m = 300, 203, 5
    words = _words(_codes(9, n, p))
    words_t = kernels.build_words_t(words, p)
    R = _rhs(10, 4 * words.shape[1], n, m)
    planes, scale = decode.quantize_rhs_planes64(R)
    pseudo = kernels.pseudo_planes64(planes)
    assert pseudo.shape == (9 * m, planes.shape[1])
    sums = decode.digit_sums_t(words_t, pseudo, want_missing=True,
                               want_sq=True)
    mp = 3 * m

    def stored(x):           # (p_all, 3m') column d*m' + c' -> row 3c' + d
        return x.view(-1, 3, mp).permute(2, 1, 0).reshape(3 * mp, -1).to(
            torch.int32)

    raw = [kernels.raw_view64(stored(x), m) for x in sums]
    want, _ = decode.digit_sums64(decode.t_rows(words_t), words_t.shape[1], R,
                                  want_missing=True, want_sq=True)
    for r, w in zip(raw, want):
        assert torch.equal(r.to(torch.float64), w)
    got = decode.digit_outputs64(*raw, scale, decode.nan_guard64(R), p)
    ref = decode.xt_dots_words_t(words_t, R, want_missing=True, want_sq=True,
                                 p=p)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert kernels.score_plan_t(3 * 100, 1) == (13, False, 3)
    assert kernels.score_plan_t(3 * 100, 2) == (7, False, 6)


def test_cpu_wrappers_take_the_plain_float64_score(monkeypatch):
    """A float64 rhs on the CPU: the wrappers of kernels 1 and 2 and the
    score image return the plain float64 digit score, build nothing and
    count no launch."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(kernels, "build_library", no_build)
    n, p = 130, 37
    words = _words(_codes(11, n, p))
    words_t = kernels.build_words_t(words, p)
    R = _rhs(12, 4 * words.shape[1], n, 3)
    before = dict(kernels.LAUNCHES)
    kw = dict(want_missing=True, want_sq=True, p=p)
    want = decode.xt_dots_words(words, R, **kw)
    image = kernels.score_image(R, want_missing=True, want_sq=True)
    for got in (kernels.xt_dots_words(words, R, **kw),
                kernels.xt_dots_words_t(words_t, R, **kw),
                kernels.xt_dots_words_image(words, image, p=p)):
        assert all(g.dtype == torch.float64 and torch.equal(g, w)
                   for g, w in zip(got, want))
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# the float64 entries on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 37, 100, 300])
def test_float64_entries_match_plain_on_card(cuda_device, m):
    """Kernels 1 and 2's float64 entries (the raw-sum entries of
    ``xt_dots_t.cu``) on the same card tensors: their digit sums equal the
    plain ones and each other bit for bit, and so do the float64 scores,
    for every output combination, p not a multiple of 4 and a NaN column;
    one launch a call, counted under the float64 names."""
    n, p = 1000, 4099
    words = _words(_codes(3, n, p)).to(cuda_device)
    words_t = kernels.build_words_t(words, p)
    R = _rhs(4, 4 * words.shape[1], n, m).to(cuda_device)
    R[5, m - 1] = float("nan")
    before = dict(kernels.LAUNCHES)
    for want_missing in (False, True):
        for want_sq in (False, True):
            kw = dict(want_missing=want_missing, want_sq=want_sq)
            plain, _ = decode.digit_sums64(decode.quad_rows(words),
                                           4 * words.shape[0], R, **kw)
            for transposed, arr in ((True, words_t), (False, words)):
                raw = kernels.raw_sums64(arr, R, transposed=transposed, **kw)
                for r, w in zip(raw, plain):
                    assert (r is None) == (w is None)
                    if r is not None:
                        assert torch.equal(r.to(torch.float64), w)
            got = kernels.xt_dots_words(words, R, p=p, **kw)
            dual = kernels.xt_dots_words_t(words_t, R, p=p, **kw)
            ref = decode.xt_dots_words(words, R, p=p, **kw)
            torch.cuda.synchronize()
            for g, t, r in zip(got, dual, ref):
                assert (g is None) == (r is None) == (t is None)
                if g is None:
                    continue
                assert g.dtype == torch.float64 and g.shape == (p, m)
                assert torch.isnan(g[:, m - 1]).all()
                assert _same(g, r) and _same(g, t)
    assert (kernels.LAUNCHES["xt_dots_words_f64"]
            == before["xt_dots_words_f64"] + 8)
    assert (kernels.LAUNCHES["xt_dots_words_t_f64"]
            == before["xt_dots_words_t_f64"] + 8)
    assert kernels.LAUNCHES["xt_dots_words"] == before["xt_dots_words"]
    assert kernels.LAUNCHES["xt_dots_words_t"] == before["xt_dots_words_t"]


@pytest.mark.cuda
def test_float64_fit_on_card_equals_cpu(cuda_device):
    """A float64 fit on the card (kernel 2's float64 entry, and kernel 1's
    through ``PackedOp`` of the genotypes without ``words_t``) and on the
    CPU (the unquantised float64 ``decode.xt_dots``): the same support and
    iterations, beta within 1e-9 of max|beta|."""
    rng = np.random.default_rng(5)
    n, p = 600, 2000
    codes = _codes(6, n, p, missing=False).T
    g_cpu = mt.PackedGenotypes.from_codes(codes, device="cpu",
                                          dtype=torch.float64)
    g = mt.PackedGenotypes.from_codes(codes, device=cuda_device,
                                      dtype=torch.float64)
    X = g_cpu.to_dense_standardized()
    beta = np.zeros(p)
    beta[rng.choice(p, 5, replace=False)] = rng.standard_normal(5)
    y = X @ beta + 0.5 * rng.standard_normal(n)
    before = dict(kernels.LAUNCHES)
    ref = mt.fit_iht(y, g_cpu, k=5, verbose=False, dtype=torch.float64)
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    for x, name in ((g, "xt_dots_words_t_f64"), (quad, "xt_dots_words_f64")):
        got = mt.fit_iht(y, x, k=5, verbose=False, dtype=torch.float64)
        assert got.beta.dtype == np.float64
        assert set(np.flatnonzero(got.beta)) == set(np.flatnonzero(ref.beta))
        assert got.iter == ref.iter
        scale = np.abs(ref.beta).max()
        assert np.abs(got.beta - ref.beta).max() <= FIT_TOL * scale
        assert kernels.LAUNCHES[name] > before[name]


# ---------------------------------------------------------------------------
# the port against the JAX package's float64 path
# ---------------------------------------------------------------------------

def _make_inputs(path):
    """Every oracle case's inputs, from seeds, written to ``path``: codes
    (n, p) of the fits' genotypes (missing calls) and the cv's, a Gaussian
    and a Bernoulli response, a 2-trait response, the cv's response and
    folds, and the R of the digit score's case."""
    rng = np.random.default_rng(2026)
    codes = _codes(21, N, P).T.copy()
    g = mt.PackedGenotypes.from_codes(codes, device="cpu",
                                      dtype=torch.float64)
    X = g.to_dense_standardized()
    beta = np.zeros(P)
    causal = rng.choice(P, K, replace=False)
    beta[causal] = rng.choice([-1.0, 1.0], K) * rng.uniform(0.4, 1.0, K)
    xb = X @ beta
    y = xb + 1.0 + 0.5 * rng.standard_normal(N)
    yb = (rng.random(N) < 1.0 / (1.0 + np.exp(-xb))).astype(np.float64)
    Y2 = np.stack([xb + 0.5 * rng.standard_normal(N),
                   0.5 * xb + 0.5 * rng.standard_normal(N)])
    codes_cv = _codes(22, N_CV, P_CV).T.copy()
    g_cv = mt.PackedGenotypes.from_codes(codes_cv, device="cpu",
                                         dtype=torch.float64)
    b_cv = np.zeros(P_CV)
    b_cv[rng.choice(P_CV, 4, replace=False)] = rng.uniform(0.5, 1.0, 4)
    y_cv = g_cv.to_dense_standardized() @ b_cv + rng.standard_normal(N_CV)
    folds = rng.integers(1, CV_Q + 1, size=N_CV)
    R = _rhs(23, g.n_pad, N, M_SCORE).numpy()
    np.savez(path, codes=codes, y=y, yb=yb, Y2=Y2, codes_cv=codes_cv,
             y_cv=y_cv, folds=folds, R=R)
    return dict(np.load(path))


def _jax_oracle(inp_path, out_path):
    """The JAX package's float64 results of every case (run under
    ``JAX_ENABLE_X64=1`` by ``oracle``), written to ``out_path``."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import mendeliht_tpu as m
    from mendeliht_tpu.ops import decode as jdecode
    from mendeliht_tpu.ops.linalg import set_kernel_backend

    assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"
    set_kernel_backend("xla")
    f64 = jnp.float64
    inp = dict(np.load(inp_path))
    g = m.PackedGenotypes.from_codes(inp["codes"], dtype=f64)
    g_cv = m.PackedGenotypes.from_codes(inp["codes_cv"], dtype=f64)
    out = {}

    def fit(name, y, x, **kw):
        r = m.fit_iht(y, x, verbose=False, dtype=f64, **kw)
        out.update({f"{name}_beta": np.asarray(r.beta),
                    f"{name}_c": np.asarray(r.c),
                    f"{name}_logl": np.float64(r.logl),
                    f"{name}_iter": np.int64(r.iter)})
        if hasattr(r, "Sigma"):
            out[f"{name}_Sigma"] = np.asarray(r.Sigma)

    fit("gauss", inp["y"], g, k=K)
    fit("bern", inp["yb"], g, k=K, d=m.Bernoulli())
    fit("initb", inp["y"], g, k=K, init_beta=True)
    fit("debias", inp["y"], g, k=K, debias=True)
    fit("mv", inp["Y2"], g, k=K)
    fit("dense", inp["y"], g.to_dense_standardized(dtype=np.float64), k=K)
    out["cv_mse"] = np.asarray(m.cv_iht(
        inp["y_cv"], g_cv, path=CV_PATH, q=CV_Q, folds=inp["folds"],
        verbose=False, dtype=f64))
    out["many_logl"] = np.asarray(m.iht_run_many_models(
        inp["y_cv"], g_cv, path=CV_PATH, verbose=False, dtype=f64))
    b, c = m.initialize_beta(inp["y"], g, dtype=f64)
    out.update(initb_b=np.asarray(b), initb_c=np.asarray(c))
    out["fold_mse"] = np.asarray(m.cv_iht_distribute_fold(
        m.Normal(), None, g_cv, None, inp["y_cv"], 1, CV_PATH, CV_Q,
        destin=str(Path(out_path).parent / "jax_folds"), folds=inp["folds"],
        dtype=f64))
    A, M, S = jdecode.xt_dots(jnp.asarray(g.packed_np()),
                              jnp.asarray(inp["R"]), want_missing=True,
                              want_sq=True)
    out.update(xt_A=np.asarray(A), xt_M=np.asarray(M), xt_S=np.asarray(S))
    assert all(v.dtype in (np.float64, np.int64) for v in out.values())
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """(inputs, the JAX package's float64 results): this file run once as
    a script with JAX_ENABLE_X64=1 on the CPU, every case in one process."""
    d = tmp_path_factory.mktemp("x64")
    inp = _make_inputs(d / "inputs.npz")
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), str(d / "inputs.npz"),
         str(d / "jax.npz")], env=env, capture_output=True, text=True,
        timeout=ORACLE_TIMEOUT, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, dict(np.load(d / "jax.npz"))


def _genotypes(codes):
    return mt.PackedGenotypes.from_codes(codes, device="cpu",
                                         dtype=torch.float64)


def _support(beta):
    return set(zip(*np.nonzero(np.atleast_2d(beta))))


def _assert_fit_matches(r, want, name):
    beta = want[f"{name}_beta"]
    assert r.beta.dtype == np.float64 and np.asarray(r.c).dtype == np.float64
    assert _support(r.beta) == _support(beta)
    assert r.iter == int(want[f"{name}_iter"])
    scale = np.abs(beta).max()
    assert np.abs(r.beta - beta).max() <= FIT_TOL * scale
    assert np.abs(np.asarray(r.c) - want[f"{name}_c"]).max() <= FIT_TOL * scale
    logl = float(want[f"{name}_logl"])
    assert abs(r.logl - logl) <= FIT_TOL * abs(logl)


def test_unquantised_score_matches_jax(oracle):
    """The port's float64 ``decode.xt_dots`` equals the JAX package's XLA
    ``decode.xt_dots`` in float64 to rounding (the CPU operator's score),
    and the plain float64 digit score is within 1e-13 * n_pad * max|R_col|
    of it."""
    inp, want = oracle
    g = _genotypes(inp["codes"])
    R = torch.from_numpy(inp["R"])
    kw = dict(want_missing=True, want_sq=True, p=P)
    bound = BOUND * g.n_pad * np.abs(inp["R"]).max(axis=0)
    for ours, digit, key in zip(decode.xt_dots(g.words, R, **kw),
                                decode.xt_dots_words(g.words, R, **kw),
                                ("xt_A", "xt_M", "xt_S")):
        np.testing.assert_allclose(ours.numpy(), want[key], rtol=0,
                                   atol=1e-12)
        assert (np.abs(digit.numpy() - want[key]) <= bound[None, :]).all()


@pytest.mark.parametrize("name", ["gauss", "bern", "initb", "debias",
                                  "dense"])
def test_fit_matches_jax(oracle, name):
    """The port's float64 fits against the JAX package's: Gaussian,
    Bernoulli, init_beta, debiased and on the dense standardized matrix
    (``DenseOp`` in float64)."""
    inp, want = oracle
    g = _genotypes(inp["codes"])
    x = (torch.from_numpy(g.to_dense_standardized()) if name == "dense"
         else g)
    kw = dict(gauss={}, dense={}, bern=dict(d=mt.Bernoulli()),
              initb=dict(init_beta=True), debias=dict(debias=True))[name]
    y = inp["yb"] if name == "bern" else inp["y"]
    r = mt.fit_iht(y, x, k=K, verbose=False, dtype=torch.float64, **kw)
    _assert_fit_matches(r, want, name)


def test_mv_fit_matches_jax(oracle):
    """The 2-trait float64 fit against the JAX package's: the same
    (trait, SNP) support and iterations, B, C and Sigma within 1e-9 of
    max|B|."""
    inp, want = oracle
    r = mt.fit_iht(inp["Y2"], _genotypes(inp["codes"]), k=K, verbose=False,
                   dtype=torch.float64)
    _assert_fit_matches(r, want, "mv")
    assert r.Sigma.dtype == np.float64
    np.testing.assert_allclose(r.Sigma, want["mv_Sigma"], rtol=0,
                               atol=FIT_TOL * np.abs(want["mv_beta"]).max())


def test_cv_and_path_match_jax(oracle):
    """``cv_iht`` and ``iht_run_many_models`` in float64 against the JAX
    package's: mse and loglikelihoods within 1e-9 relative, the same best
    k."""
    inp, want = oracle
    g = _genotypes(inp["codes_cv"])
    mse = mt.cv_iht(inp["y_cv"], g, path=CV_PATH, q=CV_Q, folds=inp["folds"],
                    verbose=False, dtype=torch.float64)
    assert mse.dtype == np.float64
    np.testing.assert_allclose(mse, want["cv_mse"], rtol=FIT_TOL, atol=0)
    assert np.argmin(mse) == np.argmin(want["cv_mse"])
    logl = mt.iht_run_many_models(inp["y_cv"], g, path=CV_PATH,
                                  verbose=False, dtype=torch.float64)
    np.testing.assert_allclose(logl, want["many_logl"], rtol=FIT_TOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, np.float64,
                                   np.dtype("float64"), "float64"])
def test_make_operator_takes_any_float64_spelling(dtype):
    """``make_operator(x, dtype)`` with float64 as a torch, numpy (class or
    dtype instance) or named dtype: packed and dense operators in float64,
    none rounded to f32; bfloat16 raises."""
    g = _genotypes(_codes(5, 40, 30).T.copy())
    op = make_operator(PackedOp(g, torch.float32), dtype)
    dense = make_operator(torch.zeros((4, 3)), dtype)
    assert op.dtype == op.mu.dtype == op.inv_sd.dtype == torch.float64
    assert torch.equal(op.mu, g.mu) and torch.equal(op.inv_sd, g.inv_sd)
    assert dense.dtype == dense.x.dtype == torch.float64
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        make_operator(g, torch.bfloat16)


def test_packed_equals_dense(oracle):
    """``tests/x64_worker.py``'s check in the port: the float64 fit on the
    packed genotypes and on their dense standardized matrix agree to 1e-10
    in beta and c."""
    inp, _ = oracle
    g = _genotypes(inp["codes"])
    r1 = mt.fit_iht(inp["y"], g, k=K, verbose=False, dtype=np.float64)
    X = torch.from_numpy(g.to_dense_standardized(dtype=np.float64))
    r2 = mt.fit_iht(inp["y"], X, k=K, verbose=False, dtype=np.float64)
    np.testing.assert_allclose(r1.beta, r2.beta, rtol=0, atol=DENSE_TOL)
    np.testing.assert_allclose(r1.c, r2.c, rtol=0, atol=DENSE_TOL)
    assert np.isfinite(r1.logl) and abs(r1.logl - r2.logl) < 1e-6


def test_streamed_fit_equals_resident(oracle):
    """Out of core in float64: ``HostStreamedGenotypes`` of the fits'
    genotypes (tiny blocks, nothing resident), the fit equal to the
    resident float64 fit: the same support and iterations, and on the CPU
    beta, c and logl within 1e-13 relative, since each block's float64
    ``decode.xt_dots`` sums in the BLAS's blocking of that block (on the
    card kernel 1's float64 entry sums exactly, and ``chip_smoke.py``
    holds the streamed fit to the resident one bit for bit)."""
    inp, _ = oracle
    g = _genotypes(inp["codes"])
    s = mt.HostStreamedGenotypes.from_snparray(g, block_bytes=2048,
                                               resident_bytes=0)
    assert s.dtype == torch.float64
    a = mt.fit_iht(inp["y"], s, k=K, verbose=False, dtype=torch.float64)
    b = mt.fit_iht(inp["y"], g, k=K, verbose=False, dtype=torch.float64)
    assert _support(a.beta) == _support(b.beta) and a.iter == b.iter
    scale = np.abs(b.beta).max()
    np.testing.assert_allclose(a.beta, b.beta, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(a.c, b.c, rtol=0, atol=1e-13 * scale)
    assert abs(a.logl - b.logl) <= 1e-13 * abs(b.logl)


def test_streamed_cv_matches_resident(oracle):
    """The streamed float64 cv (tiny blocks, nothing resident) returns
    float64 mse within 1e-12 relative of the resident float64 cv's."""
    inp, _ = oracle
    g = _genotypes(inp["codes_cv"])
    s = mt.HostStreamedGenotypes.from_snparray(g, block_bytes=4096,
                                               resident_bytes=0)
    kw = dict(path=[2, 4], q=CV_Q, folds=inp["folds"], verbose=False,
              dtype=torch.float64)
    got = mt.cv_iht(inp["y_cv"], s, **kw)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, mt.cv_iht(inp["y_cv"], g, **kw),
                               rtol=1e-12, atol=0)


def test_plink_readers_take_float64(oracle, tmp_path):
    """``read_plink`` and ``HostStreamedGenotypes.from_plink`` with a
    float64 ``dtype`` (a torch, numpy or named dtype): float64 mu and 1/sd
    equal to ``from_codes``'; bfloat16 raises."""
    inp, _ = oracle
    g = _genotypes(inp["codes"])
    prefix = str(tmp_path / "x")
    mt.write_plink_bed(prefix + ".bed", inp["codes"])
    mt.make_bim_fam_files(inp["codes"], inp["y"], prefix)
    for dtype in (torch.float64, np.float64, np.dtype("float64"),
                  "float64"):
        snp = mt.read_plink(prefix, dtype=dtype, device="cpu")
        s = mt.HostStreamedGenotypes.from_plink(prefix, dtype=dtype,
                                                device="cpu")
        for mu, inv in ((snp.snparray.mu, snp.snparray.inv_sd),
                        (s.mu, s.inv_sd)):
            assert mu.dtype == inv.dtype == torch.float64
            assert torch.equal(mu, g.mu) and torch.equal(inv, g.inv_sd)
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        mt.read_plink(prefix, dtype=torch.bfloat16, device="cpu")


def test_float64_checkpoint_restores_float64(oracle, tmp_path):
    """A float64 cv checkpointed and killed by a small ``max_iter``
    resumes to the uninterrupted float64 cv bit for bit, and its saved
    state restores as float64."""
    from mendeliht_tpu_torch.utils import checkpoint as ckpt
    inp, _ = oracle
    g = _genotypes(inp["codes_cv"])
    kw = dict(path=[2, 4], q=CV_Q, folds=inp["folds"], verbose=False,
              dtype=torch.float64)
    plain = mt.cv_iht(inp["y_cv"], g, **kw)
    d = str(tmp_path / "ck")
    mt.cv_iht(inp["y_cv"], g, checkpoint_dir=d, checkpoint_every=2,
              max_iter=3, **kw)
    step = ckpt.latest_step(d)
    assert step is not None
    payload = torch.load(os.path.join(d, f"step_{step}"), weights_only=True)
    assert payload["b"].dtype == payload["logl"].dtype == torch.float64
    np.testing.assert_array_equal(
        mt.cv_iht(inp["y_cv"], g, checkpoint_dir=d, **kw), plain)


def test_initialize_beta_takes_float64(oracle):
    """``compat.initialize_beta`` with a float64 dtype: float64 b and c,
    within 1e-9 of max|b| of the JAX package's float64 warm start; the f32
    call still returns f32."""
    inp, want = oracle
    g = _genotypes(inp["codes"])
    b, c = mt.initialize_beta(inp["y"], g, dtype=torch.float64)
    b32, _ = mt.initialize_beta(inp["y"], g)
    assert b.dtype == c.dtype == np.float64 and b32.dtype == np.float32
    scale = np.abs(want["initb_b"]).max()
    np.testing.assert_allclose(b, want["initb_b"], rtol=0,
                               atol=FIT_TOL * scale)
    np.testing.assert_allclose(c, want["initb_c"], rtol=0,
                               atol=FIT_TOL * scale)


def test_cv_iht_distribute_fold_takes_float64(oracle, tmp_path):
    """``compat.cv_iht_distribute_fold`` with a float64 dtype: its mean
    loss within 1e-9 relative of the JAX package's float64 one, and equal
    to the port's float64 ``cv_iht`` on the same folds."""
    inp, want = oracle
    g = _genotypes(inp["codes_cv"])
    got = mt.cv_iht_distribute_fold(
        mt.Normal(), None, g, None, inp["y_cv"], 1, CV_PATH, CV_Q,
        destin=str(tmp_path), folds=inp["folds"], dtype=torch.float64)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want["fold_mse"], rtol=FIT_TOL, atol=0)
    np.testing.assert_allclose(got, mt.cv_iht(
        inp["y_cv"], g, path=CV_PATH, q=CV_Q, folds=inp["folds"],
        verbose=False, dtype=torch.float64), rtol=FIT_TOL, atol=0)


if __name__ == "__main__":
    _jax_oracle(sys.argv[1], sys.argv[2])
