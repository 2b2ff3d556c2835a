"""Parity of the port's kernel lab (``mendeliht_tpu_torch.tools.kernel_lab5``
and the plain versions of its kernels) with the JAX package's
``tools/kernel_lab5.py``, on the CPU.

The JAX lab runs its Pallas kernels in interpret mode.  Its import points
the JAX compile cache elsewhere, so the three cache settings are restored
right after it.  Tolerances: the digit-plane sums are exact integers in
both, so quantization and unpacking must agree bit for bit; the scores may
differ by the last bit of XLA's f32 combine, hence 1e-6 of the largest
score.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import mendeliht_tpu as m
from mendeliht_tpu.ops import pallas_kernels as pk
from mendeliht_tpu.utils import profiling as jprofiling

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.tools import kernel_lab5 as tlab
from mendeliht_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LAB = Path(__file__).resolve().parent.parent / "tools" / "kernel_lab5.py"
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jlab():
    """The JAX lab module, imported by path with the cache settings kept."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("jax_kernel_lab5", LAB)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# ---------------------------------------------------------------------------
# digit planes and the transposed int8 score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rhs_planes_bit_identical(seed):
    rng = np.random.default_rng(seed)
    mags = 10.0 ** np.array([-30, -7, 0, 3, 12, 30, 0])
    rhs = (rng.standard_normal((1024, len(mags))) * mags).astype(np.float32)
    rhs[:, -1] = 0.0                                       # an all-zero column
    rhs[5, 2] = 0.5 * 2.0 ** -20 * np.abs(rhs[:, 2]).max()  # a rounding tie
    want_planes, want_scale = pk._quantize_rhs_planes(jnp.asarray(rhs))
    planes, scale = decode.quantize_rhs_planes(torch.from_numpy(rhs))
    assert planes.dtype == torch.int8 and planes.shape == (3 * len(mags), 1024)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want_planes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(want_scale).view(np.int32))
    assert np.abs(planes.numpy()).max() <= 64


def _words_t(n, p, seed):
    """JAX-package genotypes with missing calls; their transposed words."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p),
                       p=[0.4, 0.1, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    assert g.has_missing
    return kernels.build_words_t(torch.from_numpy(np.array(g.words)), p)


@pytest.mark.parametrize("n,p,m_,tw", [
    (512, 64, 3, None),
    (2000, 157, 1, 48),      # 128 sample words: a ragged last tile of 32
    (5000, 300, 8, 80),      # 384 sample words: a ragged last tile of 64
])
def test_xt_dots_T_matches_jax_lab(jlab, interpret, n, p, m_, tw):
    wt = _words_t(n, p, seed=n + p)
    rng = np.random.default_rng(p)
    rhs = rng.standard_normal((16 * wt.shape[0], m_)).astype(np.float32)
    rhs[n:] = 0.0
    want = np.asarray(jlab.xt_dots_T(jnp.asarray(wt.numpy()),
                                     jnp.asarray(rhs), tp=128, tw=tw))
    got = kernels.xt_dots_T(wt, torch.from_numpy(rhs))
    assert got.shape == want.shape == (wt.shape[1], m_)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_xt_dots_T_equals_exact_scores():
    """The plain score is the exact dot of decoded values (missing -> 0)
    with the dequantized digits, rounded once per digit sum."""
    n, p, m_ = 700, 45, 4
    wt = _words_t(n, p, seed=11)
    rng = np.random.default_rng(12)
    rhs = torch.from_numpy(
        rng.standard_normal((16 * wt.shape[0], m_)).astype(np.float32))
    planes, scale = decode.quantize_rhs_planes(rhs)
    vals = torch.cat([((decode.t_rows_bytes(wt) >> (2 * q)) & 3)
                      for q in range(4)], dim=1).long()
    vals = (vals >> 1) + ((vals >> 1) & vals & 1)            # (p_all, n_pad)
    exact = vals @ planes.long().T                           # int64 sums
    np.testing.assert_array_equal(decode.digit_dots_t(wt, planes).numpy(),
                                  exact.double().numpy())
    got = decode.xt_dots_T(wt, rhs)
    ref = (decode.xt_dots_words_t(wt, rhs, want_missing=False)[0])
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# narrow-integer probes
# ---------------------------------------------------------------------------

def _pallas_bitcast(x, dtype):
    def k(x_ref, o_ref):
        o_ref[:] = pltpu.bitcast(x_ref[:], dtype).astype(jnp.int32)
    f = 32 // jnp.iinfo(dtype).bits
    return np.asarray(pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((f * x.shape[0], x.shape[1]),
                                          jnp.int32),
        interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("bits,dtype", [(4, jnp.int4), (8, jnp.int8)])
@pytest.mark.parametrize("shape", [(32, 256), (16, 128)])
def test_unpack_words_matches_pltpu_bitcast(bits, dtype, shape):
    rng = np.random.default_rng(bits + shape[0])
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    x[0, :4] = [-1, 0x7FFFFFFF, -2**31, 0x19F9F9F9]          # full range
    got = kernels.unpack_words(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(got, _pallas_bitcast(x, dtype))
    assert got.min() == -(1 << (bits - 1)) and got.max() == (1 << (bits - 1)) - 1


def test_unpack_words_is_word_major():
    x = torch.tensor([[0x12345678], [0x0000009F]], dtype=torch.int32)
    assert decode.unpack_words(x, 8)[:, 0].tolist() == [
        0x78, 0x56, 0x34, 0x12, -0x61, 0, 0, 0]
    assert decode.unpack_words(x, 4)[:, 0].tolist() == [
        -8, 7, 6, 5, 4, 3, 2, 1, -1, -7, 0, 0, 0, 0, 0, 0]


def test_probe_int4_matches_jax_lab(jlab, interpret):
    want = jlab.probe_int4()
    got = tlab.probe_int4(device="cpu")
    assert got == want
    assert sorted(v for v in got.values() if v != "ok") == [
        "FAIL: TypeError: dot_general requires contracting dimensions to "
        "have the same shape, got (256,) and (128,)."]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lhs_packed", [True, False])
def test_int_dot_packed_matches_numpy(bits, lhs_packed):
    """Kernel 5's plain version at reduced (M, K), every field value."""
    rng = np.random.default_rng(bits)
    x = rng.integers(-2**31, 2**31, size=(24, 64), dtype=np.int64
                     ).astype(np.int32)
    xs = decode.unpack_words(torch.from_numpy(x), bits).numpy().astype(np.int64)
    if lhs_packed:
        y = rng.integers(-128, 128, size=(64, 24), dtype=np.int64)
        want = xs @ y
    else:
        y = rng.integers(-128, 128, size=(40, xs.shape[0]), dtype=np.int64)
        want = y @ xs
    got = kernels.int_dot_packed(torch.from_numpy(x),
                                 torch.from_numpy(y.astype(np.int32)), bits,
                                 lhs_packed=lhs_packed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [4, 8])
def test_ingestion_dot_at_lab_shape(bits):
    x, y = tlab.ingestion_operands(bits, "cpu")
    assert x.shape == (8192 * bits // 32, 2048)
    out = kernels.int_dot_packed(x, y, bits)
    want = torch.zeros((8192, 8), dtype=torch.int32)
    want[::32 // bits] = 2048
    assert torch.equal(out, want)


def test_int_dot_packed_wraps_y_to_int8():
    x = torch.ones((1, 32), dtype=torch.int32)               # field 0 = 1
    y = torch.full((32, 8), 257, dtype=torch.int32)          # int8 1
    assert int(kernels.int_dot_packed(x, y, 8)[0, 0]) == 32


def test_int_dot_packed_general_selects_a_packed_rhs_instantiation():
    """``general`` picks the guarded packed-rhs kernel: the same function
    (on the CPU, the plain version), and refused for a packed lhs."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(32, 512),
                                      dtype=np.int64).astype(np.int32))
    y = torch.from_numpy(rng.integers(-128, 128, size=(8, 256),
                                      dtype=np.int64).astype(np.int8))
    assert torch.equal(
        kernels.int_dot_packed(x, y, 4, lhs_packed=False, general=True),
        kernels.int_dot_packed(x, y, 4, lhs_packed=False))
    with pytest.raises(ValueError, match="lhs_packed=False"):
        kernels.int_dot_packed(x, y.T.contiguous(), 4, general=True)


# ---------------------------------------------------------------------------
# a numpy model of kernel 5's packed-lhs dot (csrc/int_probe.cu,
# ingest_dot_kernel): the copies each thread makes, its fragment registers,
# the m16n8k32 MMA's fragment layout, the int4 offset and its correction, and
# the reduction's output map
# ---------------------------------------------------------------------------

WARPS, STEPS = 8, 8             # kIngestWarps, kIngestSteps
ROW_U4, COL_U4 = 8 * STEPS + 4, 2 * STEPS + 1   # kRowU4, kColU4 (uint4)
Y_COPIES = kernels._Y_COPIES


def _red_row(bits):
    """kRedRow: ints of a word row's output rows in the sums' tile."""
    return 8 * (32 // bits) + 8
RANGE = 32 * STEPS              # samples of a warp's range: 1 KB a word row
BANKS = 32
RAGGED = [(8, 256, 512), (40, 96, 24), (256, 256, 128)]   # (M, K, N)


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the
    result is byte ``(sel >> 4i) & 7`` of the eight bytes ``y:x``."""
    xy = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(xy.shape, np.uint32)
    for i in range(4):
        b = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((xy >> b) & np.uint64(0xFF)).astype(np.uint32) << np.uint32(
            8 * i)
    return out


def _transpose_bytes(w):
    """``transpose_bytes``: w (..., 4) uint32 -> (..., 4), the kernel's
    eight byte permutes."""
    t0 = _byte_perm(w[..., 0], w[..., 1], 0x5140)
    t1 = _byte_perm(w[..., 0], w[..., 1], 0x7362)
    t2 = _byte_perm(w[..., 2], w[..., 3], 0x5140)
    t3 = _byte_perm(w[..., 2], w[..., 3], 0x7362)
    return np.stack([_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                     _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)],
                    axis=-1)


def _decode_run(w, bits):
    """``decode_run``: four words (..., 4) uint32 -> the (..., 32/bits)
    fragment registers; int4: the transposed bytes' low nibble ^ 8 is field
    2b, the high nibble ^ 8 field 2b + 1."""
    r = _transpose_bytes(w)
    if bits == 8:
        return r
    lo = (r & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    hi = ((r >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    return np.stack([lo, hi], axis=-1).reshape(*r.shape[:-1], 8)


def _x_reads(g, t):
    """uint4 slots of a warp's word tile that thread (g, t) reads for its two
    runs of K step i (0..STEPS-1): (STEPS, 2)."""
    i = np.arange(STEPS)[:, None]
    return g * ROW_U4 + 8 * i + 4 * np.arange(2)[None, :] + t


def _y_reads(g, t):
    """uint32 words of a warp's y tile that thread (g, t) reads as b0, b1 of
    K step i: (STEPS, 2)."""
    i = np.arange(STEPS)[:, None]
    return g * 4 * COL_U4 + 8 * i + 4 * np.arange(2)[None, :] + t


def _warp_tiles(xw, yt):
    """The shared tiles a warp's copies build, for every block and range of
    RANGE samples: x (bx, range, 8 * ROW_U4, 4) uint32 from one 16-byte copy
    a lane of word row r, half h (samples 128h + 4 lane); y (by, range,
    8 * COL_U4 * 16) int8, column 2j + lane // 16, samples 16 (lane % 16).
    Padding holds junk."""
    nbx, nby, nr = xw.shape[0] // 8, yt.shape[0] // 8, xw.shape[1] // RANGE
    tx = np.full((nbx, nr, 8 * ROW_U4, 4), 0xDEADBEEF, np.uint32)
    src = xw.reshape(nbx, 8, nr, 2, 32, 4)                   # bx r rg h lane w
    for r in range(8):
        for h in range(2):
            tx[:, :, r * ROW_U4 + 32 * h:r * ROW_U4 + 32 * h + 32] = \
                src[:, r, :, h]
    ty = np.full((nby, nr, 8 * COL_U4 * 16), -99, np.int8)
    src = yt.reshape(nby, 8, nr, 16, 16)                     # by c rg piece b
    for j in range(4):
        for lane in range(32):
            c, piece = 2 * j + lane // 16, lane % 16
            o = (c * COL_U4 + piece) * 16
            ty[:, :, o:o + 16] = src[:, c, :, piece]
    return tx, ty


def _ingest_model(x, y, bits):
    """Kernel 5's packed-lhs path, unpack(x) (M, K) . y (K, N), as the
    kernel computes it: x (M*bits/32, K) int32, y (K, N) -> (M, N) int64."""
    kf, tiles = 32 // bits, 16 // bits
    R, K = x.shape
    N = y.shape[1]
    nbx, nby = -(-R // 8), -(-N // 8)
    kpad = -(-K // (WARPS * RANGE)) * WARPS * RANGE          # whole chunks
    steps = kpad // 32
    # absent word rows, columns and samples are copied as zeros; y is staged
    # as the wrapper stages it, Y_COPIES copies of y' (N, K), and block bx
    # reads copy bx % Y_COPIES
    xw = np.zeros((nbx * 8, kpad), np.uint32)
    xw[:R, :K] = x.view(np.uint32)
    staged = torch.from_numpy(y).to(torch.int8).t().expand(
        Y_COPIES, N, K).contiguous().numpy()
    yt = np.zeros((Y_COPIES, nby * 8, kpad), np.int8)
    yt[:, :N, :K] = staged
    tx = _warp_tiles(xw, yt[0])[0]
    # thread (g, t)'s runs of every K step, read from the tiles
    runs = np.stack([np.stack([tx[:, :, _x_reads(g, t)] for t in range(4)],
                              axis=3) for g in range(8)], axis=1)
    runs = runs.reshape(nbx, 8, steps, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5)
    f = _decode_run(runs, bits)                              # bx g s h t j
    # MMA tile q: A row g + 8e, column 16h + 4t + i <- byte i of the
    # fragment register of field 2q + e (u8 for int4, s8 for int8)
    fb = np.ascontiguousarray(f).view(np.uint8 if bits == 4 else np.int8)
    fb = fb.reshape(nbx, 8, steps, 2, 4, tiles, 2, 4)       # bx g s h t q e i
    a = fb.transpose(0, 5, 6, 1, 2, 3, 4, 7).reshape(
        nbx, tiles * 16, steps * 32).astype(np.int64)
    d = np.zeros((nbx, tiles * 16, nby * 8), np.int64)
    for copy in range(Y_COPIES):
        ty = _warp_tiles(xw[:8], yt[copy])[1]
        yw = ty.view(np.uint32)
        bw = np.stack([np.stack([yw[:, :, _y_reads(g, t)] for t in range(4)],
                                axis=3) for g in range(8)], axis=1)
        bw = bw.reshape(nby, 8, steps, 4, 2).transpose(0, 1, 2, 4, 3)
        # B column g, row 16h + 4t + i <- byte i of thread (g, t)'s b_h
        b = np.ascontiguousarray(bw).view(np.int8).reshape(nby, 8,
                                                           steps * 32)
        b = b.transpose(2, 0, 1).reshape(steps * 32, nby * 8).astype(np.int64)
        mine = np.arange(nbx) % Y_COPIES == copy
        d[mine] = a[mine] @ b
        if bits == 4:                  # the correction MMA, A = -8
            d[mine] -= 8 * b.sum(axis=0)
    d = d.reshape(nbx, tiles, 16, nby, 8)
    # thread (g, t)'s accumulator c of tile q (D row g + 8(c >> 1), column
    # 2t + (c & 1)) goes to int g * RedRow + 8(2q + c // 2) + 2t + c % 2 of
    # the sums' tile, where the warps' sums add
    rr = _red_row(bits)
    red = np.zeros((nbx, nby, 8 * rr), np.int64)
    for q in range(tiles):
        for c in range(4):
            for g in range(8):
                for t in range(4):
                    red[:, :, g * rr + 8 * (2 * q + c // 2) + 2 * t + c % 2] = \
                        d[:, q, g + 8 * (c >> 1), :, 2 * t + c % 2]
    # thread i stores block output row i // 4, columns 2(i % 4) and + 1
    out = np.zeros((nbx * 8 * kf, nby * 8), np.int64)
    for i in range(2 * tiles * 32):
        rl, tt = divmod(i, 4)
        off = (rl // kf) * rr + 8 * (rl % kf) + 2 * tt
        rows = 8 * kf * np.arange(nbx) + rl
        for c in range(2):
            cols = 8 * np.arange(nby) + 2 * tt + c
            out[np.ix_(rows, cols)] = red[:, :, off + c]
    return out[:R * kf, :N]


def test_ingest_tile_reads_are_conflict_free():
    """A warp's 16-byte reads of one run fall in 32 banks each quarter warp
    (eight lanes), and its 4-byte y reads in 32 banks; no read touches the
    padding.  The 8-byte writes and reads of the sums' tile fall in 32
    banks each half warp."""
    for i in range(STEPS):
        for h in range(2):
            slots = np.array([_x_reads(g, t)[i, h]
                              for g in range(8) for t in range(4)])
            assert (slots % ROW_U4 < 8 * STEPS).all()
            for quarter in slots.reshape(4, 8):
                banks = (4 * quarter[:, None] + np.arange(4)) % BANKS
                assert len(set(banks.ravel())) == BANKS
            words = np.array([_y_reads(g, t)[i, h]
                              for g in range(8) for t in range(4)])
            assert (words % (4 * COL_U4) < 8 * STEPS).all()
            assert len(set(words % BANKS)) == BANKS
    for bits in (4, 8):
        rr, kf = _red_row(bits), 32 // bits
        for q in range(16 // bits):    # the sums' 8-byte writes, 16 lanes a
            for e in range(2):         # phase
                w = np.array([g * rr + 8 * (2 * q + e) + 2 * t
                              for g in range(8) for t in range(4)])
                for half in w.reshape(2, 16):
                    banks = (half[:, None] + np.arange(2)) % BANKS
                    assert len(set(banks.ravel())) == BANKS
        for i0 in range(0, 2 * (16 // bits) * 32, 32):   # and their reads
            w = np.array([(rl // kf) * rr + 8 * (rl % kf) + 2 * (i % 4)
                          for i in range(i0, i0 + 32) for rl in [i // 4]])
            for half in w.reshape(2, 16):
                banks = (half[:, None] + np.arange(2)) % BANKS
                assert len(set(banks.ravel())) == BANKS


def test_transpose_bytes_selectors():
    """The kernel's permute selectors transpose a 4 x 4 byte block."""
    w = np.random.default_rng(5).integers(0, 2**32, size=(64, 4),
                                          dtype=np.uint64).astype(np.uint32)
    want = w.view(np.uint8).reshape(64, 4, 4).transpose(0, 2, 1)
    np.testing.assert_array_equal(
        _transpose_bytes(w).view(np.uint8).reshape(64, 4, 4), want)


@pytest.mark.parametrize("bits", [4, 8])
def test_fragment_registers_are_unpacked_fields(bits):
    """Byte i of fragment register j of four words is field j of word i
    (``decode.unpack_words``), + 8 as u8 for int4, as s8 for int8."""
    x = _full_words(bits, (256, 4))
    f = _decode_run(x.view(np.uint32), bits)                 # (256, 32/bits)
    fields = decode.unpack_words(torch.from_numpy(x), bits).numpy().reshape(
        256, 32 // bits, 4)                                  # word row, j, i
    got = f.view(np.uint8 if bits == 4 else np.int8).reshape(
        256, 32 // bits, 4).astype(np.int64)
    np.testing.assert_array_equal(got, fields + (8 if bits == 4 else 0))
    if bits == 4:
        assert got.min() == 0 and got.max() == 15            # u8, offset 8


def _full_words(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = [-1, 0x7FFFFFFF, -2**31, 0x08080808]
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [tlab.INGEST_SHAPE] + RAGGED)
def test_ingest_model_equals_int_dot_packed(bits, shape):
    """The model of kernel 5 equals the plain version on full-range words and
    int8 y, at the lab's ingestion shape, the probe's dot and the card
    tests' ragged shapes (absent word rows, columns and K steps)."""
    M, K, N = shape
    x = _full_words(M + bits, (M * bits // 32, K))
    y = np.random.default_rng(N).integers(-128, 128, size=(K, N),
                                          dtype=np.int64).astype(np.int32)
    want = decode.int_dot_packed(torch.from_numpy(x), torch.from_numpy(y),
                                 bits).numpy()
    np.testing.assert_array_equal(_ingest_model(x, y, bits), want)


# ---------------------------------------------------------------------------
# a numpy model of kernel 4's packed-rhs dot (csrc/int_probe.cu,
# rhs_dot_kernel): each thread's loads of a chunk, its fragment registers
# (the K order within a step that A and B share), the m16n8k32 MMA's
# fragment layout and the stores
# ---------------------------------------------------------------------------

RHS_STEPS = 8                   # kRhsSteps: K steps of a chunk
RHS_SHAPES = [(8, 256, 512), (8, 512, 24), (40, 96, 20), (16, 512, 8),
              (3, 32, 9)]


def _nibbles_to_bytes(w, half):
    """``nibbles_to_bytes``: fields 4*half .. 4*half + 3 of int4 words w
    (uint32) as four int8 in a uint32, field 4*half + i in byte i."""
    p = _byte_perm(w, np.zeros_like(w), 0x3322 if half else 0x1100)
    n = (p & np.uint32(0x000F000F)) | ((p >> np.uint32(4))
                                        & np.uint32(0x0F000F00))
    return n | ((n & np.uint32(0x08080808)) * np.uint32(0x1E))


def _rhs_fragments(x, y, bits):
    """Every thread's registers a K step, for the K steps of whole chunks:
    A (bx, g, t, step, 4) uint32 (a0..a3) and B (by, g, t, step, 2) uint32
    (b0, b1), loads of absent rows, columns and samples as zeros."""
    M, K = y.shape
    N = x.shape[1]
    nbx, nby = -(-M // 16), -(-N // 8)
    steps = -(-K // (32 * RHS_STEPS)) * RHS_STEPS
    yb = np.zeros((nbx * 16 + 16, steps * 32), np.int8)
    yb[:M, :K] = y
    xw = np.zeros((steps * 32 * bits // 32 + 2, nby * 8), np.uint32)
    xw[:x.shape[0], :N] = x.view(np.uint32)
    g, t, s = np.ix_(np.arange(8), np.arange(4), np.arange(steps))
    k = 32 * s
    A = np.zeros((nbx, 8, 4, steps, 4), np.uint32)
    for bx in range(nbx):
        for h in range(2):                     # rows g and g + 8
            row = 16 * bx + g + 8 * h
            run = yb[row[..., None], (k + 8 * t)[..., None] + np.arange(8)]
            words = np.ascontiguousarray(run).view(np.uint32)   # lo, hi
            A[bx, ..., h] = words[..., 0]      # a0 / a1: samples 8t..8t+3
            A[bx, ..., 2 + h] = words[..., 1]  # a2 / a3: 8t+4..8t+7
    B = np.zeros((nby, 8, 4, steps, 2), np.uint32)
    for by in range(nby):
        col = 8 * by + g
        if bits == 4:
            w = xw[k // 8 + t, col]
            B[by, ..., 0] = _nibbles_to_bytes(w, 0)
            B[by, ..., 1] = _nibbles_to_bytes(w, 1)
        else:
            B[by, ..., 0] = xw[k // 4 + 2 * t, col]
            B[by, ..., 1] = xw[k // 4 + 2 * t + 1, col]
    return A, B


def _rhs_model(x, y, bits):
    """Kernel 4's packed-rhs path, y (M, K) int8 . unpack(x) (K, N), as the
    kernel computes it -> (M, N) int64."""
    M, N = y.shape[0], x.shape[1]
    A, B = _rhs_fragments(x, y, bits)
    nbx, nby, steps = A.shape[0], B.shape[0], A.shape[3]
    # MMA A row g + 8(j & 1), column 16(j >> 1) + 4t + i <- byte i of a_j;
    # B row 16j + 4t + i, column g <- byte i of b_j
    ab = np.ascontiguousarray(A).view(np.int8).reshape(nbx, 8, 4, steps, 2,
                                                       2, 4)  # bx g t s hi r i
    a = ab.transpose(0, 3, 5, 1, 4, 2, 6).reshape(nbx, steps, 16, 32)
    bb = np.ascontiguousarray(B).view(np.int8).reshape(nby, 8, 4, steps, 2, 4)
    b = bb.transpose(0, 3, 4, 2, 5, 1).reshape(nby, steps, 32, 8)
    d = np.einsum("xsmk,ysko->xymo", a.astype(np.int64), b.astype(np.int64))
    # thread (g, t)'s c0, c1 (row g, columns 2t, 2t + 1) and c2, c3 (row
    # g + 8) go to output row 16bx + g (+ 8), columns 8by + 2t, + 1
    out = np.zeros((nbx * 16, nby * 8), np.int64)
    for gg in range(8):
        for tt in range(4):
            for c in range(4):
                r, cc = gg + 8 * (c >> 1), 2 * tt + (c & 1)
                for bx in range(nbx):
                    out[16 * bx + r, cc::8] = d[bx, :, r, cc]
    return out[:M, :N]


def test_nibbles_to_bytes_sign_extends_every_field():
    """Byte i of ``nibbles_to_bytes(w, h)`` is field 4h + i of w as int8,
    for every nibble value in every position."""
    w = _full_words(9, (512,)).view(np.uint32)
    w[:16] = np.uint32(0x11111111) * np.arange(16, dtype=np.uint32)
    fields = decode.unpack_words(torch.from_numpy(w.view(np.int32))[None],
                                 4).numpy().reshape(8, 512).T
    for h in range(2):
        got = _nibbles_to_bytes(w, h).view(np.int8).reshape(512, 4)
        np.testing.assert_array_equal(got, fields[:, 4 * h:4 * h + 4])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", RHS_SHAPES)
def test_rhs_model_equals_int_dot_packed(bits, shape):
    """The model of kernel 4's packed-rhs dot equals the plain version on
    full-range words and int8 y, at the lab's probe shape (8, 256) x (256,
    512) and at ragged ones (absent rows, columns and K steps)."""
    M, K, N = shape
    x = _full_words(M + K + bits, (K * bits // 32, N))
    y = np.random.default_rng(N).integers(-128, 128, size=(M, K),
                                          dtype=np.int64).astype(np.int8)
    want = decode.int_dot_packed(torch.from_numpy(x), torch.from_numpy(y),
                                 bits, lhs_packed=False).numpy()
    np.testing.assert_array_equal(_rhs_model(x, y, bits), want)


# ---------------------------------------------------------------------------
# timing entry points and profiling
# ---------------------------------------------------------------------------

def _small_port_genotypes():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(300, 40), dtype=np.uint8)
    return mt.PackedGenotypes.from_codes(codes, device="cpu")


def test_timing_entry_points_raise_on_cpu():
    g = _small_port_genotypes()
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.stream_bandwidth_rw(g, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlab.time_kernel(kernels.xt_dots_T, g.with_dual_layout().words_t,
                         g.n_pad, 2, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlab.bench_int4_ingestion(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlab.attrib(g)


def test_lab_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlab.probe_int4()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlab.main(["--quick"])


def test_lab_main_writes_nothing_when_cpu_timing_raises(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlab.main(["--quick"], g=_small_port_genotypes(), device="cpu")
    assert not (tmp_path / tlab.RESULTS).exists()


def test_fit_report_phases_and_iterations(small_sim):
    x, y, _, _ = small_sim
    jt, _ = jprofiling.fit_report(y, x, k=5)
    g = mt.PackedGenotypes.from_numpy(
        np.asarray(x.words), np.asarray(x.mu), np.asarray(x.inv_sd), n=x.n,
        p=x.p, has_missing=x.has_missing, device="cpu")
    t, st = profiling.fit_report(y, g, k=5)
    assert set(t) == set(jt)
    assert all(t[k] >= 0 for k in ("build", "init", "solve", "finalize"))
    res = mt.fit_iht(y, g, k=5, verbose=False)
    assert t["iterations"] == res.iter == jt["iterations"]
    assert int(st.iters[0]) == res.iter
