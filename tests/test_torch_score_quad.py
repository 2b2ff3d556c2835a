"""The port's quad-word score (kernel 1) against the JAX package's
``pallas_kernels.xt_dots_words``, on the CPU.

The plain version ``decode.xt_dots_words`` is the function the CUDA kernel
(``csrc/xt_dots_t.cu`` with its quad-word loader) computes bit for bit: R
split into three int8 digit planes, exact integer sums of the decoded value,
missing and hi-bit planes, an f32 combine, ``S = 3A - 2H`` and the NaN
guard; on the same genotypes it equals the transposed score
``decode.xt_dots_words_t`` bit for bit.  The JAX side runs its Pallas kernel
in interpret mode, as tests/test_pallas.py runs it.

Tolerances, as in tests/test_torch_score.py: A and M bit for bit at every
Pallas tiling and m-chunk; S within one f32 rounding of 3A, since XLA may
contract ``3A - 2H`` into one fused multiply-add.

The kernel's own layout work is checked here by models: the digit image
(shared with kernel 2) read back in the quad kernel's order, and the quad
kernel's fragment gather (its MMA row permutation and byte permutes) in
numpy against the transposed words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mendeliht_tpu.genotype import snparray as jsnp
from mendeliht_tpu.ops import pallas_kernels as jpk

from mendeliht_tpu_torch.ops import decode, kernels

from test_torch_score import _assert_s_close, _combine_kernel_order


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
    """JAX-package quad words and packed bytes; an rhs whose pad samples are
    zero; for m >= 4 column 1 all zero (scale 2^-20), column 2 with a NaN
    and column 3 with an Inf."""
    rng = np.random.default_rng(seed)
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)
    g = jsnp.PackedGenotypes.from_codes(codes, sample_major=False)
    assert g.has_missing == missing
    rhs = rng.standard_normal((g.n_pad, m)).astype(np.float32)
    rhs[n:] = 0.0
    if m >= 4:
        rhs[:, 1] = 0.0
        rhs[7, 2] = np.nan
        rhs[11, 3] = np.inf
    return g, rhs


def _words(g):
    return torch.from_numpy(np.array(g.words))


def _check_against_jax(got, want, m, p):
    for k in range(3):
        assert (got[k] is None) == (want[k] is None)
    for k in (0, 1):
        if got[k] is not None:
            assert got[k].shape == (p, m) and got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if got[2] is not None:
        _assert_s_close(got[2].numpy(), want[2], got[0].numpy())


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("want_sq", [False, True])
@pytest.mark.parametrize("m,tp,tw", [(1, 8, 128), (5, 16, 256),
                                     (37, 8, 512), (100, 32, 128)])
def test_plain_matches_pallas(missing, want_sq, m, tp, tw):
    """p = 37 (not a multiple of 4); the JAX tiling differs per case, and
    the exact sums do not depend on it."""
    g, rhs = _problem(m, 300, 37, m, missing)
    kw = dict(want_missing=missing, want_sq=want_sq, p=37)
    want = jpk.xt_dots_words(g.words, jnp.asarray(rhs), tp=tp, tw=tw,
                             interpret=True, **kw)
    got = decode.xt_dots_words(_words(g), torch.from_numpy(rhs), **kw)
    _check_against_jax(got, want, m, 37)
    if m >= 4:
        for out in got:
            if out is not None:
                col = out.numpy()
                assert np.all(np.isnan(col[:, 2:4]))
                assert np.all(col[:, 1] == 0.0)
                assert np.all(np.isfinite(np.delete(col, [2, 3], axis=1)))


@pytest.mark.parametrize("tiling", [(8, 128), (16, 256), (40, 512)])
def test_pallas_tilings_agree_with_plain(tiling):
    """Every JAX (tp, tw) gives the plain version's A and M exactly."""
    tp, tw = tiling
    g, rhs = _problem(5, 700, 45, 6, True)
    kw = dict(want_missing=True, want_sq=False, p=45)
    want = jpk.xt_dots_words(g.words, jnp.asarray(rhs), tp=tp, tw=tw,
                             interpret=True, **kw)
    got = decode.xt_dots_words(_words(g), torch.from_numpy(rhs), **kw)
    _check_against_jax(got, want, 6, 45)


def test_forced_m_chunks_agree_with_plain(monkeypatch):
    """The JAX driver split into m-chunks of 3 (``_FORCE_M_CHUNK``) gives
    the plain version's A and M exactly: the chunks' columns are combined
    independently on both sides."""
    monkeypatch.setattr(jpk, "_FORCE_M_CHUNK", 3)
    g, rhs = _problem(6, 300, 37, 7, True)
    kw = dict(want_missing=True, want_sq=True, p=37)
    want = jpk.xt_dots_words(g.words, jnp.asarray(rhs), tp=16, tw=256,
                             interpret=True, **kw)
    got = decode.xt_dots_words(_words(g), torch.from_numpy(rhs), **kw)
    _check_against_jax(got, want, 7, 37)


def test_packed_bytes_entry_agrees_with_plain():
    """``pallas_kernels.xt_dots`` (the byte-row entry that quad-packs on the
    device) gives the plain version's A and M exactly."""
    g, rhs = _problem(8, 130, 37, 5, True)
    packed = jsnp._words_to_bytes(np.asarray(g.words), 37)
    want = jpk.xt_dots(jnp.asarray(packed), jnp.asarray(rhs),
                       want_missing=True, want_sq=True, tp=8, tw=128,
                       interpret=True)
    got = decode.xt_dots_words(_words(g), torch.from_numpy(rhs),
                               want_missing=True, want_sq=True, p=37)
    _check_against_jax(got, want, 5, 37)


@pytest.mark.parametrize("special", ["zero", "nan", "inf"])
def test_single_column_specials(special):
    """m = 1: an all-zero column is exactly zero (scale 2^-20, zero
    digits); a NaN or Inf anywhere makes every output NaN."""
    g, rhs = _problem(9, 130, 21, 1, True)
    rhs[:, 0] = 0.0 if special == "zero" else rhs[:, 0]
    if special != "zero":
        rhs[3, 0] = np.nan if special == "nan" else np.inf
    kw = dict(want_missing=True, want_sq=True, p=21)
    want = jpk.xt_dots_words(g.words, jnp.asarray(rhs), tp=8, tw=128,
                             interpret=True, **kw)
    got = decode.xt_dots_words(_words(g), torch.from_numpy(rhs), **kw)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
        if special == "zero":
            assert np.all(gt.numpy() == 0.0)
        else:
            assert np.all(np.isnan(gt.numpy()))


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("m", [1, 6, 37])
@pytest.mark.parametrize("missing", [False, True])
def test_plain_quad_equals_plain_transposed(m, missing):
    """On the same genotypes the quad-word and transposed plain versions
    are one function, bit for bit at every plane, NaN and Inf columns and
    the quad-padding SNPs included."""
    g, rhs = _problem(m + 30, 260, 29, m, missing)
    words, r = _words(g), torch.from_numpy(rhs)
    words_t = kernels.build_words_t(words, 29)
    for p in (None, 29):
        kw = dict(want_missing=True, want_sq=True, p=p)
        quad = decode.xt_dots_words(words, r, **kw)
        dual = decode.xt_dots_words_t(words_t, r, **kw)
        for a, b in zip(quad, dual):
            assert a.shape == (32 if p is None else 29, m)
            assert _same(a, b)


def test_cpu_wrapper_is_the_plain_version():
    """The wrapper on CPU tensors is the plain version, and its A is the
    kernel lab's digit-plane score (kernel 6's function) on finite
    columns."""
    g, rhs = _problem(12, 500, 33, 7, True)
    words = _words(g)
    got = kernels.xt_dots_words(words, torch.from_numpy(rhs),
                                want_missing=True, want_sq=True, p=33)
    want = decode.xt_dots_words(words, torch.from_numpy(rhs),
                                want_missing=True, want_sq=True, p=33)
    assert all(_same(a, b) for a, b in zip(got, want))
    rhs[~np.isfinite(rhs)] = 0.0
    a = kernels.xt_dots_words(words, torch.from_numpy(rhs),
                              want_missing=False)[0]
    wt = kernels.build_words_t(words, 33)
    assert torch.equal(a, decode.xt_dots_T(wt, torch.from_numpy(rhs)))


def test_wrapper_raises_past_exact_range_before_work(monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("worked past the exact-sum range")

    monkeypatch.setattr(decode, "xt_dots_words", no_work)
    monkeypatch.setattr(decode, "quantize_rhs_planes", no_work)
    n4 = 2**22                                   # 128 * 4*n4 = 2^31
    words = torch.zeros((1, 1), dtype=torch.int32).expand(1, n4)
    rhs = torch.zeros((1, 1)).expand(4 * n4, 1)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="exact"):
        kernels.xt_dots_words(words, rhs, want_missing=True)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 37, 100, 300])
@pytest.mark.parametrize("want_missing", [False, True])
def test_digit_rows_in_quad_kernel_order(m, want_missing):
    """The digit image the wrapper lays out for both kernels, with nw =
    n4/4, read back as the quad kernel combines it over the quad words'
    byte rows, gives the plain quad version's A and M exactly."""
    g, rhs = _problem(m + 20, 260, 29, m, want_missing)
    words, r = _words(g), torch.from_numpy(rhs)
    nw = words.shape[1] // 4
    planes, _ = decode.quantize_rhs_planes(r)
    ng, split, passes = kernels.score_plan_t(m, 1 + want_missing)
    digits = kernels._digit_rows_t(planes, nw, ng, split, passes)
    wt = kernels.build_words_t(words, 29)
    got = _combine_kernel_order(wt, r, digits, ng, split, want_missing)
    want = decode.xt_dots_words(words, r, want_missing=want_missing)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), w.numpy())
    # the same sums over the quad words' byte rows
    flat = digits[:, :, :4 * nw].reshape(digits.shape[0], 16 * nw)
    quad = decode.digit_sums(decode.quad_rows(words), 4 * words.shape[0],
                             flat, want_missing=want_missing)
    for a, b in zip(quad, decode.digit_sums_t(wt, flat,
                                              want_missing=want_missing)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the eight bytes of x (0-3) and y (4-7)."""
    xy = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    sel = np.asarray(sel, dtype=np.uint64)
    out = np.zeros(np.broadcast(xy, sel).shape, dtype=np.uint64)
    for i in range(4):
        shift = ((sel >> np.uint64(4 * i)) & np.uint64(7)) * np.uint64(8)
        out |= ((xy >> shift) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


@pytest.mark.parametrize("split", [False, True])
def test_quad_fragment_gather_model(split):
    """A numpy model of the quad kernel's A fragments: thread (warpgroup,
    warp, g, t) reads its quad row (snp_off/4 + 4*warp + g/2) at K words t
    and 4+t of each K step as two 16-byte runs and gathers them with byte
    permutes (``gather`` in xt_dots_t.cu); its registers must hold the
    transposed words of SNPs 2g and 2g+1 of the warp's 16 (MMA rows g and
    g+8), the words kernel 2 reads for those rows."""
    rng = np.random.default_rng(3 + split)
    p4, n4 = 40, 512                  # one 128-SNP (or two 64-SNP) tiles
    words = rng.integers(0, 2**32, size=(p4, n4), dtype=np.uint64)
    words = words.astype(np.uint32)
    wt = kernels.build_words_t(torch.from_numpy(words.view(np.int32)),
                               4 * p4).numpy().view(np.uint32)
    snps = 64 if split else 128
    for tile in range(4 * p4 // snps):
        for wg in range(2):
            snp_off = 0 if split else 64 * wg
            for warp in range(4):
                g = np.arange(8)[:, None]
                t = np.arange(4)[None, :]
                qrow = tile * snps // 4 + snp_off // 4 + 4 * warp + g // 2
                sel = np.where(g % 2 == 1, 0x7362, 0x5140)
                for s in range(n4 // 32):
                    x = []
                    for run in (0, 16):        # K words t, then 4 + t
                        col = 32 * s + run + 4 * t
                        u = [words[qrow, col + j] for j in range(4)]
                        a = _byte_perm(u[0], u[1], sel)
                        b = _byte_perm(u[2], u[3], sel)
                        x += [_byte_perm(a, b, 0x5410),
                              _byte_perm(a, b, 0x7632)]
                    snp = tile * snps + snp_off + 16 * warp + 2 * g
                    for r, (kw, dsnp) in enumerate(((0, 0), (0, 1), (4, 0),
                                                    (4, 1))):
                        np.testing.assert_array_equal(
                            x[r], wt[8 * s + kw + t, snp + dsnp])
