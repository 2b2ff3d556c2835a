"""Parity of the port's round-3 kernel probe
(``mendeliht_tpu_torch.tools.kernel_probe`` and the plain versions of its
three kernels) with the JAX package's ``tools/kernel_probe.py``, on the CPU.

The JAX probe runs its Pallas kernels in interpret mode.  Its import points
the JAX compile cache elsewhere, so the three cache settings are restored
right after it.  Tolerances: digit planes, round order and the integer
probes agree bit for bit; the score may differ by the last bit of XLA's f32
combine, hence 1e-6 of the largest score.  The JAX probe leaves the rows of
a ragged last tile undefined, so it is compared only where the tiles divide
the words; the port's rule for a ragged tile (absent rows and columns add
nothing) is pinned against a numpy model.
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

import mendeliht_tpu as m
from mendeliht_tpu.genotype.snparray import _words_to_bytes

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.tools import kernel_probe as tprobe

PROBE = Path(__file__).resolve().parent.parent / "tools" / "kernel_probe.py"
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jprobe():
    """The JAX probe module, imported by path with the cache settings kept."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("jax_kernel_probe", PROBE)
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


def _genotypes(n, p, seed):
    """JAX-package genotypes with missing calls."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p),
                       p=[0.4, 0.1, 0.3, 0.2])
    g = m.PackedGenotypes.from_codes(codes)
    assert g.has_missing
    return g


def _round3(g, p):
    """The reference's round-3 words of JAX genotypes: (p, nw) int32."""
    return np.ascontiguousarray(
        _words_to_bytes(np.asarray(g.words), p).view("<i4"))


def _port(g):
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd), n=g.n,
        p=g.p, has_missing=g.has_missing, device="cpu")


def _int32(rng, shape):
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = [-1, 0x7FFFFFFF, -2**31, 0x55555555]
    return x


# ---------------------------------------------------------------------------
# digit planes, round order and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw,tw", [(8, None), (32, 16), (24, 16), (128, 48)])
def test_quantize_and_rounds_restride_bit_identical(jprobe, nw, tw):
    rng = np.random.default_rng(nw)
    rhs = (rng.standard_normal((16 * nw, 5))
           * 10.0 ** np.array([-20, 0, 3, 9, 0])).astype(np.float32)
    rhs[:, 4] = 0.0                                          # a zero column
    want_planes, want_scale = jprobe.quantize_rhs_planes(jnp.asarray(rhs))
    planes, scale = tprobe.quantize_rhs_planes(torch.from_numpy(rhs))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want_planes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(want_scale).view(np.int32))
    want = np.asarray(jprobe.rounds_restride(want_planes, nw, tw or nw))
    got = tprobe.rounds_restride(planes, nw, tw)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_rounds_restride_sample_order():
    """Round r = 4b + s at word w holds sample s*4nw + 4w + b."""
    nw = 6
    samples = torch.arange(16 * nw, dtype=torch.int32)[None, :]
    rr = decode.rounds_restride(samples, nw)
    for r in range(16):
        s, b = r % 4, r // 4
        assert rr[r, 0].tolist() == [s * 4 * nw + 4 * w + b for w in range(nw)]


@pytest.mark.parametrize("n,p", [(1000, 37), (2600, 130), (500, 3)])
def test_round3_words_match_reference_layout(n, p):
    g = _genotypes(n, p, seed=n + p)
    got = tprobe.round3_words(_port(g))
    want = _round3(g, p)
    assert got.shape == (4 * -(-p // 4), want.shape[1])
    np.testing.assert_array_equal(got[:p].numpy(), want)
    assert not got[p:].any()
    wt = kernels.build_words_t(torch.from_numpy(np.array(g.words)), p)
    assert torch.equal(got, wt.T)


# ---------------------------------------------------------------------------
# kernel 7: the 16-round int8 score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p,m_,tp,tw", [
    (1000, 256, 1, 128, None),
    (1000, 384, 3, 128, 64),
    (2100, 256, 8, 256, 128),    # nw = 256: two word tiles
    (2100, 512, 13, 512, None),  # two digit-row chunks on the card
])
def test_xt_i8_rounds_matches_jax_probe(jprobe, interpret, n, p, m_, tp, tw):
    g = _genotypes(n, p, seed=n + m_)
    w3 = _round3(g, p)
    rng = np.random.default_rng(p + m_)
    rhs = rng.standard_normal((16 * w3.shape[1], m_)).astype(np.float32)
    rhs[n:] = 0.0
    want = np.asarray(jprobe.xt_i8_rounds(jnp.asarray(w3), jnp.asarray(rhs),
                                          tp=tp, tw=tw))
    got = kernels.xt_i8_rounds(torch.from_numpy(w3), torch.from_numpy(rhs),
                               tp=tp)
    assert got.shape == want.shape == (p, m_)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("m_", [1, 4, 21])
def test_xt_i8_rounds_equals_xt_dots_T_on_the_transpose(m_):
    g = _genotypes(1500, 90, seed=m_)
    w3 = torch.from_numpy(_round3(g, 90))
    rng = np.random.default_rng(m_)
    rhs = torch.from_numpy(rng.standard_normal((16 * w3.shape[1], m_))
                           .astype(np.float32))
    got = decode.xt_i8_rounds(w3, rhs)
    assert torch.equal(got, decode.xt_dots_T(w3.T.contiguous(), rhs))
    assert torch.equal(kernels.xt_i8_rounds(w3, rhs, tp=512, tw=w3.shape[1]),
                       got)


def test_quad_words_rejected_before_any_work(jprobe):
    """The reference's main feeds the quad words to kernel 7: an (n_pad, m)
    rhs for 4*n4 samples where the round-3 layout needs 16*n4."""
    g = _genotypes(1000, 64, seed=5)
    words = np.array(g.words)
    rhs = np.ones((4 * words.shape[1], 2), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jprobe.xt_i8_rounds(jnp.asarray(words), jnp.asarray(rhs))
    with pytest.raises(ValueError, match="16\\*nw"):
        kernels.xt_i8_rounds(torch.from_numpy(words), torch.from_numpy(rhs))


# ---------------------------------------------------------------------------
# kernels 8 and 9: the streaming-read and decode-only probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,nw,tp", [(256, 40, 64), (96, 128, 32),
                                     (64, 8, 64)])
@pytest.mark.parametrize("seed", [0, -7, 2**31 - 3])
def test_stream_xor_matches_jax_probe(jprobe, interpret, p, nw, tp, seed):
    x = _int32(np.random.default_rng(p + nw), (p, nw))
    s = np.array([[seed]], np.int32)
    want = np.asarray(jprobe.stream_xor(jnp.asarray(x), jnp.asarray(s), tp=tp))
    got = kernels.stream_xor(torch.from_numpy(x), torch.from_numpy(s), tp=tp)
    assert got.dtype == torch.int32 and got.shape == (tp, nw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,nw,tp,tw", [(256, 40, 64, None), (96, 128, 32, 32),
                                        (64, 24, 16, 8)])
@pytest.mark.parametrize("seed", [0, 2**31 - 3])
def test_decode_only_matches_jax_probe(jprobe, interpret, p, nw, tp, tw, seed):
    x = _int32(np.random.default_rng(p * nw), (p, nw))
    s = np.array([[seed]], np.int32)
    want = np.asarray(jprobe.decode_only(jnp.asarray(x), jnp.asarray(s),
                                         tp=tp, tw=tw))
    got = kernels.decode_only(torch.from_numpy(x), torch.from_numpy(s), tp=tp,
                              tw=tw)
    assert got.shape == (tp, tw or nw)
    np.testing.assert_array_equal(got.numpy(), want)


def _numpy_xor_tiles(x, seed, tp, tw, decode_words):
    """Element by element: out[r % tp, c % tw] ^= f(x[r, c] + seed)."""
    t = (x.view(np.uint32).astype(np.uint64) + np.uint64(seed % 2**32)) % 2**32
    t = t.astype(np.uint32)
    if decode_words:
        h = (t >> 1) & 0x55555555
        w = (h + (h & t)) & 0xFFFFFFFF
        t = sum((w >> np.uint32(2 * k)) & 3 for k in range(16)).astype(np.uint32)
    out = np.zeros((tp, tw), np.uint32)
    for r in range(x.shape[0]):
        for c in range(x.shape[1]):
            out[r % tp, c % tw] ^= t[r, c]
    return out.view(np.int32)


@pytest.mark.parametrize("p,nw,tp,tw", [(100, 12, 32, 12), (50, 20, 64, 7),
                                        (7, 5, 3, 2)])
def test_ragged_tiles_follow_numpy_model(p, nw, tp, tw):
    x = _int32(np.random.default_rng(p), (p, nw))
    seed = 2**31 - 1
    s = torch.tensor([[seed]], dtype=torch.int32)
    got = kernels.decode_only(torch.from_numpy(x), s, tp=tp, tw=tw)
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_xor_tiles(x, seed, tp, tw, True))
    got = kernels.stream_xor(torch.from_numpy(x), s, tp=tp)
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_xor_tiles(x, seed, tp, nw, False))


def test_decode_sums_count_crumb_values():
    codes = np.random.default_rng(1).integers(0, 4, size=(64, 16))
    word = (codes << (2 * np.arange(16))).sum(axis=1).astype(np.uint32)
    value = np.array([0, 0, 1, 2])[codes].sum(axis=1)         # missing -> 0
    got = decode.decode_sums(torch.from_numpy(word.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), value)


def _popcount_crumb_sums(t):
    """Kernel 9's crumb sum (``csrc/kernel_probe.cu::crumb_sum``) in numpy
    uint32: popc(h) + popc(h & t), h = (t >> 1) & 0x55555555."""
    h = (t >> np.uint32(1)) & np.uint32(0x55555555)
    return np.bitwise_count(h).astype(np.int32) + np.bitwise_count(h & t)


@pytest.mark.parametrize("seed", [0, -7, 2**31 - 3])
def test_popcount_crumb_sum_equals_decode_sums(seed):
    """The popcount form equals the plain version's 16 rounds on full-range
    words, ``words + seed`` wrapping, every crumb code in every position."""
    x = _int32(np.random.default_rng(seed % 97), (64, 1024))
    x.reshape(-1)[:6] = [-1, 0, 0x7FFFFFFF, -2**31, 0x55555555, -0x55555556]
    t = ((x.view(np.uint32).astype(np.uint64) + seed % 2**32) % 2**32
         ).astype(np.uint32)                       # the kernel's uint32 add
    want = decode.decode_sums(torch.from_numpy(x) + torch.tensor(
        seed, dtype=torch.int32)).numpy()          # wrapping int32
    np.testing.assert_array_equal(_popcount_crumb_sums(t), want)
    assert want.min() >= 0 and want.max() <= 32


def test_popcount_crumb_sum_of_every_byte():
    """Each byte's four crumbs on their own: the popcount sum of a word is
    the sum of its bytes' values, for all 256 bytes in every position."""
    b = np.arange(256, dtype=np.uint32)
    value = sum(np.array([0, 0, 1, 2])[(b >> (2 * k)) & 3] for k in range(4))
    for pos in range(4):
        np.testing.assert_array_equal(
            _popcount_crumb_sums(b << np.uint32(8 * pos)), value)


# ---------------------------------------------------------------------------
# the wrappers' checks, the timers and the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda w, r, s: kernels.xt_i8_rounds(w, r, tw=3),
    lambda w, r, s: kernels.xt_i8_rounds(w, r, tp=0),
    lambda w, r, s: kernels.xt_i8_rounds(w.long(), r),
    lambda w, r, s: kernels.stream_xor(w, s[0]),
    lambda w, r, s: kernels.stream_xor(w, s, tp=-1),
    lambda w, r, s: kernels.decode_only(w, s.long()),
    lambda w, r, s: kernels.decode_only(w, s, tw=0),
    lambda w, r, s: kernels.decode_only(w.to("meta"), s.to("meta")),
], ids=["tw", "tp", "dtype", "seed-shape", "stream-tp", "seed-dtype",
        "decode-tw", "device"])
def test_probe_wrappers_reject_bad_inputs(call):
    w = torch.zeros((8, 4), dtype=torch.int32)
    r = torch.zeros((64, 2))
    s = torch.zeros((1, 1), dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        call(w, r, s)
    assert kernels.LAUNCHES == before


def test_timers_raise_on_cpu():
    w = torch.zeros((8, 4), dtype=torch.int32)
    r = torch.zeros((64, 1))
    for tmr in (tprobe.timeit, tprobe.timeit_roofline_style):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmr(kernels.xt_i8_rounds, w, r, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprobe.timeit_seeded(kernels.stream_xor, w, iters=2)


def test_main_refuses_the_cpu(monkeypatch):
    g = _port(_genotypes(300, 20, seed=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tprobe.main(["1"], g=g, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprobe.main(["1"], g=g)


def test_main_drives_every_kernel_on_cpu_tensors(monkeypatch, capsys):
    """The probe's control flow with its device guard and CUDA-event timer
    replaced (a CPU run measures nothing): each wrapper is called, the spot
    check agrees with kernel 1, and nothing is written."""
    g = _port(_genotypes(1000, 40, seed=2))
    monkeypatch.setattr(tprobe, "_device", torch.device)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    calls = []

    def fake(step, state, iters, device):
        calls.append(iters)
        step(step(state))
        return 1e-3

    monkeypatch.setattr(tprobe.profiling, "_seconds_per_call", fake)
    res = tprobe.main(["1", "3"], g=g, device="cpu")
    assert res["words_shape"] == list(g.words.shape)
    assert res["i8_rounds_rel_err"] == 0.0     # two exact functions
    assert len(res["stream_xor_ms"]) == len(res["decode_only_ms"]) == 2
    assert set(res["variants"]) == {1, 3}
    for v in res["variants"].values():
        assert list(v) == ["v0", "v0-roofl", "v1", "v1-roofl", "v1tp512",
                           "v1tp2048"]
        assert all(t == [1.0, 1.0] for t in v.values())
    assert len(calls) == 4 + 2 * 12
    assert "i8-rounds max rel err vs v0" in capsys.readouterr().out
