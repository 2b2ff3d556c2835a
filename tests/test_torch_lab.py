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
