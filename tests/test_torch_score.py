"""The port's transposed-layout score (kernel 2) against the JAX package's
``pallas_kernels.xt_dots_words_t``, on the CPU.

The plain version ``decode.xt_dots_words_t`` is the function the CUDA kernel
``csrc/xt_dots_t.cu`` computes bit for bit: R split into three int8 digit
planes, exact integer sums of the decoded value, missing and hi-bit planes,
an f32 combine, ``S = 3A - 2H`` and the NaN guard.  The JAX side runs its
Pallas kernel in interpret mode, as tests/test_pallas.py runs it.

Tolerances: the digit sums are exact integers on both sides and the combine
runs in the same f32 order, so A and M match bit for bit, at every Pallas
tiling.  S matches to one f32 rounding of 3A: XLA may contract ``3A - 2H``
into one fused multiply-add, which skips the rounding of ``3A`` that the
plain version (and the kernel) make.

The wrapper's digit layout for the kernel (``kernels._digit_rows_t``) is
checked here by reading it back the way the kernel combines it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mendeliht_tpu.genotype import snparray as jsnp
from mendeliht_tpu.ops import pallas_kernels as jpk

from mendeliht_tpu_torch.ops import decode, kernels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n, p, m, missing):
    """JAX-package genotypes and their transposed words; an rhs whose pad
    samples are zero; for m >= 4 column 1 all zero (scale 2^-20), column 2
    with a NaN and column 3 with an Inf."""
    rng = np.random.default_rng(seed)
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)
    g = jsnp.PackedGenotypes.from_codes(codes, sample_major=False)
    assert g.has_missing == missing
    wt = jpk.build_words_t(g.words, p)
    rhs = rng.standard_normal((g.n_pad, m)).astype(np.float32)
    rhs[n:] = 0.0
    if m >= 4:
        rhs[:, 1] = 0.0
        rhs[7, 2] = np.nan
        rhs[11, 3] = np.inf
    return wt, rhs


def _plain(wt, rhs, **kw):
    return decode.xt_dots_words_t(torch.from_numpy(np.array(wt)),
                                  torch.from_numpy(rhs), **kw)


def _assert_s_close(s_port, s_jax, a_port):
    """S within one f32 rounding of 3A (and of S itself) of the JAX one."""
    s_port, s_jax = np.asarray(s_port), np.asarray(s_jax)
    a3 = np.abs(3.0 * np.asarray(a_port, np.float64)).astype(np.float32)
    tol = np.maximum(np.spacing(a3), np.spacing(np.abs(s_jax)))
    finite = np.isfinite(s_jax)
    np.testing.assert_array_equal(np.isfinite(s_port), finite)
    np.testing.assert_array_equal(np.isnan(s_port), np.isnan(s_jax))
    assert np.all(np.abs(s_port - s_jax)[finite] <= tol[finite])


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("want_sq", [False, True])
@pytest.mark.parametrize("m,tp,tw", [(1, 8, 16), (5, 16, 32), (37, 8, 64),
                                     (100, 32, 128)])
def test_plain_matches_pallas(missing, want_sq, m, tp, tw):
    """p = 37 (not a multiple of 4); the JAX tiling differs per case, and
    the exact sums do not depend on it."""
    wt, rhs = _problem(m, 300, 37, m, missing)
    kw = dict(want_missing=missing, want_sq=want_sq, p=37)
    want = jpk.xt_dots_words_t(wt, jnp.asarray(rhs), tp=tp, tw=tw,
                               interpret=True, **kw)
    got = _plain(wt, rhs, **kw)
    for k in range(3):
        assert (got[k] is None) == (want[k] is None)
    for k in (0, 1):
        if got[k] is not None:
            assert got[k].shape == (37, m) and got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if want_sq:
        _assert_s_close(got[2].numpy(), want[2], got[0].numpy())
    if m >= 4:
        for out in got:
            if out is not None:
                col = out.numpy()
                assert np.all(np.isnan(col[:, 2:4]))
                assert np.all(col[:, 1] == 0.0)
                assert np.all(np.isfinite(np.delete(col, [2, 3], axis=1)))


@pytest.mark.parametrize("tiling", [(8, 8), (16, 32), (40, 64)])
def test_pallas_tilings_agree_with_plain(tiling):
    """Every JAX (tp, tw) gives the plain version's A and M exactly."""
    tp, tw = tiling
    wt, rhs = _problem(5, 700, 45, 6, True)
    kw = dict(want_missing=True, want_sq=False, p=45)
    want = jpk.xt_dots_words_t(wt, jnp.asarray(rhs), tp=tp, tw=tw,
                               interpret=True, **kw)
    got = _plain(wt, rhs, **kw)
    for k in (0, 1):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("special", ["zero", "nan", "inf"])
def test_single_column_specials(special):
    """m = 1: an all-zero column is exactly zero (scale 2^-20, zero
    digits); a NaN or Inf anywhere makes every output NaN."""
    wt, rhs = _problem(9, 130, 21, 1, True)
    rhs[:, 0] = 0.0 if special == "zero" else rhs[:, 0]
    if special != "zero":
        rhs[3, 0] = np.nan if special == "nan" else np.inf
    kw = dict(want_missing=True, want_sq=True, p=21)
    want = jpk.xt_dots_words_t(wt, jnp.asarray(rhs), tp=8, tw=16,
                               interpret=True, **kw)
    got = _plain(wt, rhs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if special == "zero":
            assert np.all(g.numpy() == 0.0)
        else:
            assert np.all(np.isnan(g.numpy()))


def test_pad_columns_zero_without_p():
    wt, rhs = _problem(10, 70, 6, 2, True)
    got = _plain(wt, rhs, want_missing=True, want_sq=True)
    for out in got:
        assert out.shape == (8, 2)
        assert torch.all(out[6:] == 0)


def test_value_dots_equal_lab_score():
    """A equals the kernel lab's digit-plane score (kernel 6's function) on
    finite columns."""
    wt, rhs = _problem(12, 500, 33, 7, True)
    rhs[~np.isfinite(rhs)] = 0.0
    wt_t = torch.from_numpy(np.array(wt))
    a = _plain(wt, rhs, want_missing=False)[0]
    assert torch.equal(a, decode.xt_dots_T(wt_t, torch.from_numpy(rhs)))


def test_wrapper_raises_past_exact_range_before_work(monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("worked past the exact-sum range")

    monkeypatch.setattr(decode, "xt_dots_words_t", no_work)
    monkeypatch.setattr(decode, "quantize_rhs_planes", no_work)
    nw = 2**20                                   # 128 * 16*nw = 2^31
    wt = torch.zeros((1, 4), dtype=torch.int32).expand(nw, 4)
    rhs = torch.zeros((1, 1)).expand(16 * nw, 1)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="exact"):
        kernels.xt_dots_words_t(wt, rhs, want_missing=True)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("m,planes,plan", [
    (1, 1, (0, False, 1)), (2, 3, (0, False, 1)), (3, 1, (1, False, 1)),
    (8, 2, (1, False, 1)), (13, 1, (2, False, 1)), (37, 1, (7, False, 1)),
    (100, 1, (13, False, 1)), (100, 2, (7, True, 1)), (100, 3, (4, False, 4)),
    (300, 1, (13, False, 3)), (4096, 1, (13, False, 40))])
def test_score_plan(m, planes, plan):
    ng, split, passes = kernels.score_plan_t(m, planes)
    assert (ng, split, passes) == plan
    assert ng * planes <= kernels._NG_PLANES_T
    cols = 2 if ng == 0 else 8 * ng * (2 if split else 1)
    assert passes * cols >= m > (passes - 1) * cols


def _combine_kernel_order(wt, rhs, digits, ng, split, want_missing):
    """Read the kernel's digit rows back as the kernel combines them: row
    24b + 8d + r of a pass is digit d of its column 8b + r (ng = 0: row
    2d + c)."""
    nw = wt.shape[0]
    m = rhs.shape[1]
    rows = digits.shape[0]
    assert torch.all(digits[:, :, 4 * nw:] == 0)
    flat = digits[:, :, :4 * nw].reshape(rows, 16 * nw)
    a, mm, _ = decode.digit_sums_t(wt, flat, want_missing=want_missing)
    cols = 2 if ng == 0 else 8 * ng * (2 if split else 1)
    per = 8 if ng == 0 else 3 * cols
    idx = []
    for d in range(3):
        for c in range(m):
            ps, cc = divmod(c, cols)
            row = 2 * d + cc if ng == 0 else 24 * (cc // 8) + 8 * d + cc % 8
            idx.append(ps * per + row)
    _, scale = decode.quantize_rhs_planes(rhs)
    guard = decode.nan_guard(rhs)[None, :]
    out = [decode.combine_digits(x[:, idx], scale) + guard
           for x in (a, mm) if x is not None]
    return out


@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 37, 100, 300])
@pytest.mark.parametrize("want_missing", [False, True])
def test_digit_rows_in_kernel_order(m, want_missing):
    """The wrapper's layout, read back as the kernel reads it, gives the
    plain version's A and M exactly: every digit row of every column is in
    its place, every other row is zero."""
    wt, rhs = _problem(m + 20, 260, 29, m, want_missing)
    wt_t, rhs_t = torch.from_numpy(np.array(wt)), torch.from_numpy(rhs)
    planes, _ = decode.quantize_rhs_planes(rhs_t)
    ng, split, passes = kernels.score_plan_t(m, 1 + want_missing)
    digits = kernels._digit_rows_t(planes, wt.shape[0], ng, split, passes)
    assert digits.dtype == torch.int8 and digits.shape[1] == 4
    assert digits.shape[2] % 128 == 0
    got = _combine_kernel_order(wt_t, rhs_t, digits, ng, split, want_missing)
    want = decode.xt_dots_words_t(wt_t, rhs_t, want_missing=want_missing)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert int((digits != 0).any(dim=(1, 2)).sum()) <= 3 * m
    # the kernel's image of a K step: core matrices of 8 rows x 16 bytes
    st = kernels._digit_stages_t(digits, passes)
    rows = digits.shape[0] // passes
    assert st.shape == (passes, digits.shape[2] // 32, 4, 2, rows // 8, 8, 16)
    rng = np.random.default_rng(m)
    for idx in rng.integers(0, st.shape, size=(200, 7)):
        ps, kt, q, kc, rg, r8, j = (int(i) for i in idx)
        assert st[ps, kt, q, kc, rg, r8, j] == digits[
            ps * rows + 8 * rg + r8, q, 32 * kt + 16 * kc + j]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plane_decode_equals_bit_formula(dtype):
    """``decode._plane_val_miss`` (the value and missing planes of every
    plain score, forward and gather) and the planes ``xt_dots`` and
    ``digit_sums`` derive from its value (S's square, the hi bit) equal the
    bit formula they are written against: hi = c >> 1, hl = hi & c & 1,
    value hi + hl, missing (c & 1) - hl, square hi + 3 hl.  All four crumb
    codes, at every shift of a byte."""
    by = torch.arange(256, dtype=torch.uint8).reshape(4, 64)
    for s in range(4):
        c = (by >> (2 * s)) & 3
        hi, hl = c >> 1, (c >> 1) & c & 1
        val, miss = decode._plane_val_miss(c, dtype, True)
        assert val.dtype == miss.dtype == dtype
        assert torch.equal(val, (hi + hl).to(dtype))
        assert torch.equal(miss, ((c & 1) - hl).to(dtype))
        assert torch.equal(val * val, (hi + 3 * hl).to(dtype))
        assert torch.equal((val > 0.0).to(dtype), hi.to(dtype))
        val2, none = decode._plane_val_miss(c, dtype, False)
        assert none is None and torch.equal(val2, val)
    assert sorted(set(((by >> 2) & 3).flatten().tolist())) == [0, 1, 2, 3]
