"""The port stands alone, and its wrappers dispatch by tensor device.

- No module of ``mendeliht_tpu_torch`` imports jax or the JAX package (an
  AST scan: jax may already sit in ``sys.modules`` of any process here).
- A CPU tensor takes the plain PyTorch version and builds nothing.
- On a CUDA card (marker ``cuda``), each hand-written kernel agrees with its
  plain version, and the score kernels with each other.  The int8
  digit-plane scores (kernels 1, 2, 6 and 7: one body, ``csrc/xt_dots_t.cu``),
  the narrow-integer probes and the round-3 probes sum integers exactly, so
  they equal their plain versions bit for bit; kernels 1 and 2 equal each
  other on the same genotypes, kernel 2's A equals kernel 6's, and kernel
  7's equals kernel 6's on the transposed words.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mendeliht_tpu_torch
from mendeliht_tpu_torch.genotype.snparray import _bytes_to_words, pack_codes
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

PKG = Path(mendeliht_tpu_torch.__file__).resolve().parent
MODULES = sorted(PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "mendeliht_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_package_has_modules():
    names = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert not (PKG / "csrc" / "xt_dots.cu").exists()     # kernel 1's f32
    assert not (PKG / "csrc" / "xt_dots_i8.cu").exists()  # kernel 6's mma.sync
    assert {"ops/kernels.py", "ops/decode.py", "ops/glm.py", "ops/negbin.py",
            "models/fit.py", "models/cv.py", "models/mv.py", "compat.py",
            "utils/profiling.py",
            "utils/simulate.py",
            "genotype/plink.py", "genotype/vcf.py", "genotype/bgen.py",
            "utils/wrapper.py", "utils/standardize.py", "utils/device.py",
            "tools/kernel_lab5.py", "tools/kernel_probe.py",
            "ops/streaming.py", "utils/checkpoint.py", "models/streamed.py",
            "models/mv_streamed.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/sharded_ops.py",
            "parallel/multihost.py", "parallel/dryrun.py"} <= names
    for src in ("xt_dots_t.cu", "read_probe.cu", "int_probe.cu",
                "kernel_probe.cu", "i8_mma.cuh"):
        assert (PKG / "csrc" / src).is_file()


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_leaves_jax_out():
    """A fresh interpreter that imports the package and every module of it
    has no jax in ``sys.modules`` (the scan above reads the imports; this
    runs them, transitive ones included)."""
    mods = [".".join(("mendeliht_tpu_torch",) + p.relative_to(PKG).with_suffix(
        "").parts).removesuffix(".__init__") for p in MODULES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules), bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _case(seed, n=130, p=37, m=3):
    rng = np.random.default_rng(seed)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(p, n),
                       p=[0.45, 0.05, 0.3, 0.2])
    words = torch.from_numpy(_bytes_to_words(pack_codes(codes)))
    rhs = torch.from_numpy(
        rng.standard_normal((4 * words.shape[1], m)).astype(np.float32))
    return words, rhs


def test_cpu_tensor_takes_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(kernels, "build_library", no_build)
    words, rhs = _case(1)
    words_t = kernels.build_words_t(words, 37)
    before = dict(kernels.LAUNCHES)
    kw = dict(want_missing=True, want_sq=True, p=37)
    got = kernels.xt_dots_words(words, rhs, **kw)
    want = decode.xt_dots_words(words, rhs, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(got, decode.xt_dots_words_t(words_t, rhs, **kw)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)     # kernel 2's
    got = kernels.xt_dots_words_t(words_t, rhs, **kw)
    want = decode.xt_dots_words_t(words_t, rhs, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    c = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(kernels.read_words(words, c),
                       decode.read_words(words, c))
    wt = kernels.build_words_t(words, 37)
    assert torch.equal(kernels.xt_dots_T(wt, rhs), decode.xt_dots_T(wt, rhs))
    for bits in (4, 8):
        assert torch.equal(kernels.unpack_words(words, bits),
                           decode.unpack_words(words, bits))
        y = torch.arange(words.shape[1] * 5, dtype=torch.int32).reshape(-1, 5)
        assert torch.equal(kernels.int_dot_packed(words, y, bits),
                           decode.int_dot_packed(words, y, bits))
    w3 = wt.T.contiguous()
    assert torch.equal(kernels.xt_i8_rounds(w3, rhs),
                       decode.xt_i8_rounds(w3, rhs))
    s = torch.tensor([[-9]], dtype=torch.int32)
    assert torch.equal(kernels.stream_xor(words, s, tp=3),
                       decode.stream_xor(words, s, 3))
    assert torch.equal(kernels.decode_only(words, s, tp=3, tw=5),
                       decode.decode_only(words, s, 3, 5))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    words, rhs = _case(2)
    if bad == "dtype":
        words = words.to(torch.int64)
    elif bad == "shape":
        rhs = rhs[1:]
    else:
        words, rhs = words.to("meta"), rhs.to("meta")
    with pytest.raises(ValueError):
        kernels.xt_dots_words(words, rhs, want_missing=True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_probe_wrappers_reject_bad_inputs(bad):
    words, rhs = _case(2)
    w3 = kernels.build_words_t(words, 37).T.contiguous()
    seed = torch.zeros((1, 1), dtype=torch.int32)
    if bad == "dtype":
        words, w3, seed = words.to(torch.int64), w3.to(torch.int64), seed.long()
    elif bad == "shape":
        rhs, seed = rhs[1:], seed[0]
    else:
        words, w3, seed, rhs = (t.to("meta") for t in (words, w3, seed, rhs))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        kernels.xt_i8_rounds(w3, rhs)
    with pytest.raises(ValueError):
        kernels.stream_xor(words, seed)
    with pytest.raises(ValueError):
        kernels.decode_only(words, seed)
    assert kernels.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 13, 37, 100, 300, 1000, 4100])
def test_kernel_matches_plain_on_card(cuda_device, m):
    """Kernel 1 (quad words) vs its plain version and vs kernel 2 on the
    transposed words, bit for bit, on the same card tensors: every output
    plane, p not a multiple of 4, a NaN column, and widths that run every
    digit-row grouping (one or two column groups of 8, 7 and 13 a
    warpgroup, split rows, several passes, past ``_VT_MAX_M``) and a ragged
    last group; one launch a call."""
    words, rhs = _case(3, n=1000, p=4099, m=m)
    rhs[5, m - 1] = float("nan")
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    words_t = kernels.build_words_t(words, 4099)
    before = dict(kernels.LAUNCHES)
    for want_missing in (False, True):
        for want_sq in (False, True):
            kw = dict(want_missing=want_missing, want_sq=want_sq, p=4099)
            got = kernels.xt_dots_words(words, rhs, **kw)
            ref = decode.xt_dots_words(words, rhs, **kw)
            k2 = kernels.xt_dots_words_t(words_t, rhs, **kw)
            torch.cuda.synchronize()
            for g, r, t in zip(got, ref, k2):
                assert (g is None) == (r is None) == (t is None)
                if g is None:
                    continue
                assert g.shape == (4099, m)
                assert torch.isnan(g[:, m - 1]).all()
                assert _same(g, r) and _same(g, t)
    assert kernels.LAUNCHES["xt_dots_words"] == before["xt_dots_words"] + 4
    assert kernels.LAUNCHES["xt_dots_words_t"] == before["xt_dots_words_t"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 13, 37, 100, 300, 1000])
def test_transposed_kernel_matches_plain_and_quad_on_card(cuda_device, m):
    """Transposed-layout kernel (int8 digit planes) vs its plain version bit
    for bit, its A vs kernel 6 bit for bit and all three outputs vs the
    quad-word kernel bit for bit, on the same card tensors: every output
    plane, p not a multiple of 4, a NaN column, and widths that run every
    digit-row grouping (one or two column groups of 8, 7 and 13 a
    warpgroup, split rows, several passes) and a ragged last group; one
    launch a call."""
    words, rhs = _case(4, n=1000, p=4099, m=m)
    rhs[5, m - 1] = float("nan")
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    words_t = kernels.build_words_t(words, 4099)
    before = dict(kernels.LAUNCHES)
    for want_missing in (False, True):
        for want_sq in (False, True):
            kw = dict(want_missing=want_missing, want_sq=want_sq, p=4099)
            got = kernels.xt_dots_words_t(words_t, rhs, **kw)
            ref = decode.xt_dots_words_t(words_t, rhs, **kw)
            quad = kernels.xt_dots_words(words, rhs, **kw)
            torch.cuda.synchronize()
            for g, r, q in zip(got, ref, quad):
                assert (g is None) == (r is None) == (q is None)
                if g is None:
                    continue
                assert g.shape == (4099, m)
                assert torch.isnan(g[:, m - 1]).all()
                assert _same(g, r) and _same(g, q)
    assert kernels.LAUNCHES["xt_dots_words_t"] == before["xt_dots_words_t"] + 4
    assert kernels.LAUNCHES["xt_dots_words"] == before["xt_dots_words"] + 4
    a = kernels.xt_dots_words_t(words_t, rhs, want_missing=False, p=4099)[0]
    assert _same(a[:, :m - 1], kernels.xt_dots_T(words_t, rhs)[:4099, :m - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 100])
def test_score_kernels_hold_bound_at_large_n(cuda_device, m):
    """Both score kernels where each SNP sums 200,000 samples, for every
    output plane: each equal to its plain version bit for bit (exact integer
    sums), and to each other."""
    n, p = 200_000, 67
    words, rhs = _case(7, n=n, p=p, m=m)
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    words_t = kernels.build_words_t(words, p)
    for want_missing in (False, True):
        for want_sq in (False, True):
            kw = dict(want_missing=want_missing, want_sq=want_sq, p=p)
            got = kernels.xt_dots_words(words, rhs, **kw)
            ref = decode.xt_dots_words(words, rhs, **kw)
            got_t = kernels.xt_dots_words_t(words_t, rhs, **kw)
            ref_t = decode.xt_dots_words_t(words_t, rhs, **kw)
            torch.cuda.synchronize()
            for g, r, gt, rt in zip(got, ref, got_t, ref_t):
                assert (g is None) == (r is None) == (gt is None)
                assert g is None or (_same(g, r) and _same(gt, rt)
                                     and _same(g, gt))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 200])
def test_score_kernels_squared_plane_at_moment_widths_on_card(cuda_device,
                                                              m):
    """The widths of ``PackedOp.col_moments`` (the init_beta warm start's
    score pass, m = 2B: 2 for a fit, 200 for the default cv), with the
    squared plane S and the missing plane M: kernels 1 and 2 bit for bit
    against their plain versions and each other, the R of col_moments (a
    0/1 W over WY) included."""
    words, rhs = _case(11, n=1000, p=4099, m=m)
    w = (rhs[:, : m // 2] > 0).to(torch.float32)
    rhs[:, : m // 2] = w
    rhs[:, m // 2:] = w * rhs[:, m // 2:]
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    words_t = kernels.build_words_t(words, 4099)
    for want_missing in (False, True):
        kw = dict(want_missing=want_missing, want_sq=True, p=4099)
        quad = kernels.xt_dots_words(words, rhs, **kw)
        dual = kernels.xt_dots_words_t(words_t, rhs, **kw)
        ref = decode.xt_dots_words_t(words_t, rhs, **kw)
        ref_q = decode.xt_dots_words(words, rhs, **kw)
        torch.cuda.synchronize()
        for q, d, r, rq in zip(quad, dual, ref, ref_q):
            assert (q is None) == (r is None)
            if q is not None:
                assert q.shape == (4099, m)
                assert _same(q, r) and _same(d, r) and _same(rq, r)


@pytest.mark.cuda
def test_build_words_t_on_card_matches_cpu(cuda_device):
    words, _ = _case(5, n=700, p=45)
    want = kernels.build_words_t(words, 45, chunk_q=4)
    got = kernels.build_words_t(words.to(cuda_device), 45, chunk_q=4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [37, 4099])
def test_read_probe_equals_plain_on_card(cuda_device, p):
    words, _ = _case(6, n=1000, p=p)
    words = words.to(cuda_device)
    tail = words.reshape(-1)[:-3]           # a count that is not 4-aligned
    before = kernels.LAUNCHES["read_words"]
    for w in (words, tail):
        for c in (0, -123, 2**31 - 1):
            ct = torch.tensor([c], dtype=torch.int32, device=cuda_device)
            got = kernels.read_words(w, ct)
            assert torch.equal(got, decode.read_words(w, ct))
    assert kernels.LAUNCHES["read_words"] == before + 6


def _lab_words_t(seed, n, p, device):
    words, _ = _case(seed, n=n, p=p)
    return kernels.build_words_t(words.to(device), p)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 8, 64, 100, 128])
@pytest.mark.parametrize("p_all", [4096, 4099])
def test_int8_score_kernel_equals_plain_on_card(cuda_device, m, p_all):
    """Kernel 6 (kernel 2's A with a zero guard) vs its plain version and
    kernel 2's A, bit for bit, on the same card tensors: every plan of the
    digit rows (m <= 2, one or two groups, 13 groups, two passes), missing
    calls, a tiny and a zero column, nw = 163 (not a multiple of 32 or 4)
    and p_all = 4099 (not a multiple of 4: the wrapper pads a copy)."""
    wt = _lab_words_t(9, 2600, 4100, cuda_device)[:163, :p_all].contiguous()
    rhs = torch.randn((16 * wt.shape[0], m), device=cuda_device)
    rhs[:, 0] *= 1e-20
    if m > 2:
        rhs[:, 2] = 0.0                                      # a zero column
    before = kernels.LAUNCHES["xt_dots_T"]
    got = kernels.xt_dots_T(wt, rhs)
    assert kernels.LAUNCHES["xt_dots_T"] == before + 1
    ref = decode.xt_dots_T(wt, rhs)
    wt4 = torch.cat([wt, wt.new_zeros((wt.shape[0], -p_all % 4))], dim=1)
    k2 = kernels.xt_dots_words_t(wt4, rhs, want_missing=False, p=p_all)[0]
    torch.cuda.synchronize()
    assert got.shape == ref.shape == k2.shape == (p_all, m)
    assert torch.equal(got, ref) and torch.equal(got, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_unpack_kernel_equals_plain_on_card(cuda_device, bits):
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(33, 257),
                                      dtype=np.int64).astype(np.int32))
    x = x.to(cuda_device)
    before = kernels.LAUNCHES["unpack_words"]
    assert torch.equal(kernels.unpack_words(x, bits),
                       decode.unpack_words(x, bits))
    assert kernels.LAUNCHES["unpack_words"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lhs_packed", [True, False])
@pytest.mark.parametrize("shape", [(8, 256, 512), (40, 96, 24)])
def test_int_dot_kernel_equals_plain_on_card(cuda_device, bits, lhs_packed,
                                             shape):
    """Packed-operand dots, every field value and ragged M and N tiles:
    (M, K, N) with the packed operand on either side."""
    M, K, N = shape
    f = 32 // bits
    rng = np.random.default_rng(M + bits)
    if lhs_packed:
        xs, ys = (M // f, K), (K, N)
    else:
        xs, ys = (K // f, N), (M, K)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=xs, dtype=np.int64)
                         .astype(np.int32)).to(cuda_device)
    y = torch.from_numpy(rng.integers(-128, 128, size=ys, dtype=np.int64)
                         .astype(np.int32)).to(cuda_device)
    before = kernels.LAUNCHES["int_dot_packed"]
    got = kernels.int_dot_packed(x, y, bits, lhs_packed=lhs_packed)
    assert torch.equal(got, decode.int_dot_packed(x, y, bits, lhs_packed))
    assert kernels.LAUNCHES["int_dot_packed"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_ingestion_kernel_at_lab_shape_on_card(cuda_device, bits):
    from mendeliht_tpu_torch.tools.kernel_lab5 import ingestion_operands

    x, y = ingestion_operands(bits, cuda_device)
    got = kernels.int_dot_packed(x, y, bits)
    want = torch.zeros((8192, 8), dtype=torch.int32, device=cuda_device)
    want[::32 // bits] = 2048
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_ingestion_kernel_on_full_range_operands_on_card(cuda_device, bits):
    """Kernel 5 at the lab's ingestion shape on random words (every field
    value, both signs, in every position) and random int8 y: a wrong field
    order or sign changes the product."""
    from mendeliht_tpu_torch.tools.kernel_lab5 import INGEST_SHAPE

    M, K, N = INGEST_SHAPE
    rng = np.random.default_rng(bits + 5)
    x = torch.from_numpy(_full_range(bits, (M * bits // 32, K))).to(
        cuda_device)
    y = torch.from_numpy(rng.integers(-128, 128, size=(K, N), dtype=np.int64)
                         .astype(np.int8)).to(cuda_device)
    before = kernels.LAUNCHES["int_dot_packed"]
    got = kernels.int_dot_packed(x, y, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, decode.int_dot_packed(x, y, bits))
    assert kernels.LAUNCHES["int_dot_packed"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(8, 256, 512), (8, 256, 24), (8, 512, 24),
                                   (40, 96, 20), (16, 512, 8), (3, 32, 9)])
def test_rhs_dot_kernel_equals_plain_on_card(cuda_device, bits, shape):
    """Kernel 4's packed-rhs dot (``rhs_dot_kernel``, one warp a 16 x 8
    tile over all of K) on full-range words and int8 y: the lab's probe
    shape and another of its unguarded instantiation (8 rows, one K chunk,
    whole column tiles), ragged rows, columns and K chunks, and K past one
    chunk; with ``general`` the guarded instantiation at every shape; one
    launch a call."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + bits)
    x = torch.from_numpy(_full_range(bits + 7, (K * bits // 32, N))).to(
        cuda_device)
    y = torch.from_numpy(rng.integers(-128, 128, size=(M, K), dtype=np.int64)
                         .astype(np.int8)).to(cuda_device)
    want = decode.int_dot_packed(x, y, bits, False)
    for general in (False, True):
        before = kernels.LAUNCHES["int_dot_packed"]
        got = kernels.int_dot_packed(x, y, bits, lhs_packed=False,
                                     general=general)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert kernels.LAUNCHES["int_dot_packed"] == before + 1


@pytest.mark.cuda
def test_int_dot_kernel_shape_error_before_launch(cuda_device):
    x = torch.zeros((32, 256), dtype=torch.int32, device=cuda_device)
    y = torch.zeros((128, 128), dtype=torch.int32, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError, match=r"got \(256,\) and \(128,\)"):
        kernels.int_dot_packed(x, y, 4)
    assert kernels.LAUNCHES == before


def _full_range(seed, shape):
    """int32 words over the whole range: every crumb code, words + seed
    wrapping."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = [-1, 0x7FFFFFFF, -2**31, 0x55555555]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m_", [1, 3, 8, 64, 100])
def test_xt_i8_rounds_kernel_equals_plain_on_card(cuda_device, m_):
    """Kernel 7 (the ROW layout of the score body) against its plain
    version and kernel 6 on the transpose, bit for bit, at every tp of the
    probe (a no-op: the same result for each): every crumb code, p = 4099
    (not a multiple of the tile or of 4) and nw = 164 (a ragged last K
    step)."""
    w3 = torch.from_numpy(_full_range(m_, (4099, 164))).to(cuda_device)
    rhs = torch.randn((16 * w3.shape[1], m_), device=cuda_device)
    rhs[:, 0] *= 1e-20
    ref = decode.xt_i8_rounds(w3, rhs)
    k6 = kernels.xt_dots_T(w3.T.contiguous(), rhs)
    before = kernels.LAUNCHES["xt_i8_rounds"]
    for tp in (128, 512, 1024, 2048):
        got = kernels.xt_i8_rounds(w3, rhs, tp=tp)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (4099, m_)
        assert torch.equal(got, ref) and torch.equal(got, k6), tp
    assert kernels.LAUNCHES["xt_i8_rounds"] == before + 4


@pytest.mark.cuda
def test_row_layout_refuses_other_planes_and_ragged_rows(cuda_device):
    """The ROW entry is built for A alone and 16-byte row runs: asking it
    for M, or for nw not a multiple of 4, is refused before any launch."""
    w3 = torch.zeros((256, 8), dtype=torch.int32, device=cuda_device)
    rhs = torch.randn((128, 3), device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels._digit_score("xt_i8_rounds", w3, rhs, 8, 256, True, False,
                             None)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.xt_i8_rounds(w3[:, :6].contiguous(), rhs[:96])


@pytest.mark.cuda
@pytest.mark.parametrize("p,nw,tp,tw", [(1000, 2560, 64, None),
                                        (4099, 40, 1024, 7),
                                        (3, 5, 8, 16)])
@pytest.mark.parametrize("seed", [0, 2**31 - 3])
def test_xor_kernels_equal_plain_on_card(cuda_device, p, nw, tp, tw, seed):
    x = torch.from_numpy(_full_range(p, (p, nw))).to(cuda_device)
    s = torch.tensor([[seed]], dtype=torch.int32, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.stream_xor(x, s, tp=tp),
                       decode.stream_xor(x, s, tp))
    assert torch.equal(kernels.decode_only(x, s, tp=tp, tw=tw),
                       decode.decode_only(x, s, tp, tw or nw))
    assert kernels.LAUNCHES["stream_xor"] == before["stream_xor"] + 1
    assert kernels.LAUNCHES["decode_only"] == before["decode_only"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tw", [None, 1000])
@pytest.mark.parametrize("seed", [0, 2**31 - 3])
def test_decode_only_at_scale_on_card(cuda_device, seed, tw):
    """Kernel 9 on 8.4 M full-range words (every crumb code, words + seed
    wrapping), a ragged last row tile and, at tw = 1000, a ragged column
    tile: equal to plain."""
    x = torch.from_numpy(_full_range(seed % 7, (4099, 2048))).to(cuda_device)
    s = torch.tensor([[seed]], dtype=torch.int32, device=cuda_device)
    got = kernels.decode_only(x, s, tw=tw)
    torch.cuda.synchronize()
    assert torch.equal(got, decode.decode_only(x, s, kernels.TP, tw or 2048))


def _mv_genotypes(device):
    """(card genotypes, CPU genotypes, a 3-trait Y (3, n)) of one simulated
    problem: 1,000 x 3,000 with missing calls, two of nine causal SNPs
    shared by every trait."""
    from mendeliht_tpu_torch.utils.simulate import (
        simulate_packed_problem, simulate_random_multivariate_response)
    words, mu, inv_sd, hm, _, _ = simulate_packed_problem(
        np.random.default_rng(7), 1000, 3000, missing=True)
    card, cpu = (mendeliht_tpu_torch.PackedGenotypes.from_numpy(
        words, mu, inv_sd, n=1000, p=3000, has_missing=hm, device=d)
        for d in (device, "cpu"))
    Y, _, _, _ = simulate_random_multivariate_response(
        cpu, 9, 3, overlap=2, rng=np.random.default_rng(8))
    return card, cpu, np.ascontiguousarray(Y.T)


def _mv_fit_traced(Y, g, **kw):
    """``fit_iht`` of the mv response Y on ``g`` with its line searches
    recorded: (result, one [logl before, the full step's logl, backtracks]
    an iteration)."""
    from mendeliht_tpu_torch.models import mv
    rows, need = [], mv._mv_bt_need

    def recording(act, old_logl, cur, n_bt, max_step):
        out = need(act, old_logl, cur, n_bt, max_step)
        if not bool(n_bt.any()):                 # an iteration's first check
            rows.append([float(old_logl[0]), float(cur["logl"][0]), 0])
        rows[-1][2] += int(out.any())
        return out

    mv._mv_bt_need = recording
    try:
        return mendeliht_tpu_torch.fit_iht(Y, g, **kw), rows
    finally:
        mv._mv_bt_need = need


@pytest.mark.cuda
@pytest.mark.parametrize("init_beta", [False, True])
def test_mv_fit_on_card_matches_cpu(cuda_device, init_beta):
    """The multivariate fit on the card (every score pass at m = 3 through
    kernel 2, R in 21-bit digits) against the CPU's f32 score: the same
    (trait, SNP) support, logl within 4 f32 roundings at the end and before
    every iteration up to the first whose backtracks differ (the split), B
    and Sigma within 1e-3 of their max, iterations within one, or within 6
    where the split is a loglikelihood tie (on both devices the full step's
    logl within 4 roundings of the last: the plateau where an mv fit ends,
    on which f32 roundings decide a backtrack)."""
    card, cpu, Y = _mv_genotypes(cuda_device)
    kw = dict(k=9, d=mendeliht_tpu_torch.MvNormal(), init_beta=init_beta,
              verbose=False)
    before = kernels.LAUNCHES["xt_dots_words_t"]
    a, ra = _mv_fit_traced(Y, card, **kw)
    launches = kernels.LAUNCHES["xt_dots_words_t"] - before
    b, rb = _mv_fit_traced(Y, cpu, **kw)
    ulps = lambda x, y: abs(x - y) / np.spacing(np.float32(abs(y)))  # noqa
    assert set(zip(*np.nonzero(a.beta))) == set(zip(*np.nonzero(b.beta)))
    assert ulps(a.logl, b.logl) <= 4
    for u, v in ((a.beta, b.beta), (a.Sigma, b.Sigma)):
        assert np.abs(u - v).max() <= 1e-3 * np.abs(v).max()
    assert launches >= a.iter + 1
    split = next((i for i, (u, v) in enumerate(zip(ra, rb)) if u[2] != v[2]),
                 min(len(ra), len(rb)))
    assert all(u[0] == v[0] or ulps(u[0], v[0]) <= 4
               for u, v in zip(ra[:split + 1], rb[:split + 1]))
    if abs(a.iter - b.iter) > 1:
        assert abs(a.iter - b.iter) <= 6 and split < min(len(ra), len(rb))
        assert all(ulps(r[split][1], r[split][0]) <= 4 for r in (ra, rb))


@pytest.mark.cuda
def test_mv_cv_on_card_matches_cpu(cuda_device):
    """The multivariate cv on the card against the CPU: mse within 1e-4
    relative, the same best k."""
    card, cpu, Y = _mv_genotypes(cuda_device)
    kw = dict(path=[3, 6, 9, 12], q=3, verbose=False,
              folds=np.random.default_rng(9).integers(1, 4, size=1000))
    a = mendeliht_tpu_torch.cv_iht(Y, card, **kw)
    b = mendeliht_tpu_torch.cv_iht(Y, cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4)
    assert int(np.argmin(a)) == int(np.argmin(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1999, 2000, 2001, 2002])
def test_bed_repack_on_card_matches_cpu(cuda_device, n):
    """``from_bed_bytes`` on the card: the CPU's words bit for bit and its
    stats exactly, n % 4 in {0, 1, 2, 3}, missing calls, p % 4 == 3, two
    chunks; the card's ``.bed`` rows (``bed_rows``) give the payload back."""
    from mendeliht_tpu_torch.genotype import snparray
    p = 4099
    rng = np.random.default_rng(n)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(p, n),
                       p=[0.4, 0.1, 0.3, 0.2])
    bed = snparray.bed_payload_of_codes(codes)
    cpu = snparray.PackedGenotypes.from_bed_bytes(bed, n, p, device="cpu")
    chunk = snparray._CHUNK_P
    try:
        snparray._CHUNK_P = 2048
        card = snparray.PackedGenotypes.from_bed_bytes(bed, n, p,
                                                       device=cuda_device)
    finally:
        snparray._CHUNK_P = chunk
    assert card.words.device.type == "cuda"
    assert torch.equal(card.words.cpu(), cpu.words)
    assert torch.equal(card.mu.cpu(), cpu.mu)
    assert torch.equal(card.inv_sd.cpu(), cpu.inv_sd)
    assert np.array_equal(card.n_missing, cpu.n_missing)
    rows = snparray.bed_rows(card.words, n, p)
    assert rows.device.type == "cuda"
    assert np.array_equal(rows.cpu().numpy(), bed)


@pytest.mark.cuda
def test_dense_op_full_f32_with_tf32_switched_on(cuda_device):
    """With TF32 switched on by the caller, DenseOp's products are the f32
    products it gives with TF32 off, bit for bit, and within 1e-5 of
    float64; a plain ``R @ X`` under the same switch is not (it shows the
    switch took)."""
    from mendeliht_tpu_torch.ops.linalg import DenseOp
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    X = torch.randn((2000, 3000), generator=gen, device=cuda_device)
    R = torch.randn((8, 2000), generator=gen, device=cuda_device)
    W = (torch.rand((2, 2000), generator=gen, device=cuda_device) < 0.8).float()
    op = DenseOp(X)
    ref = (R.double() @ X.double())
    try:
        torch.set_float32_matmul_precision("highest")
        off = op.xtr(R)
        off_m = op.col_moments(W, W * 2.0)
        torch.set_float32_matmul_precision("high")
        on = op.xtr(R)
        on_m = op.col_moments(W, W * 2.0)
        raw = R @ X
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(on, off)
    for a, b in zip(on_m, off_m):
        assert torch.equal(a, b)
    scale = ref.abs().max()
    assert (on.double() - ref).abs().max() <= 1e-5 * scale
    assert (raw.double() - ref).abs().max() > 1e-4 * scale


@pytest.mark.cuda
def test_grm_and_dense_fit_on_card_match_cpu(cuda_device):
    """grm on the card within 1e-4 relative of the CPU's float64 loop; a
    dense fit on the card selects what it selects on the CPU."""
    from mendeliht_tpu_torch.genotype.snparray import PackedGenotypes
    rng = np.random.default_rng(8)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(500, 1200),
                       p=[0.4, 0.1, 0.3, 0.2])
    card = PackedGenotypes.from_codes(codes, device=cuda_device)
    cpu = PackedGenotypes.from_codes(codes, device="cpu")
    want = mendeliht_tpu_torch.grm(cpu)
    got = mendeliht_tpu_torch.grm(card, chunk=500)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    X = cpu.to_dense_standardized()
    y = X[:, [3, 70, 400]] @ np.array([1.0, -1.0, 0.5]) + rng.standard_normal(500)
    a = mendeliht_tpu_torch.fit_iht(y, X, k=3, verbose=False)   # the card
    b = mendeliht_tpu_torch.fit_iht(y, torch.from_numpy(X), k=3,
                                    verbose=False)
    assert set(np.flatnonzero(a.beta)) == set(np.flatnonzero(b.beta))
    assert abs(a.iter - b.iter) <= 1


def _streamed_case(device, resident_q, block_q=40):
    """Genotypes with missing calls on ``device`` (1,000 x 4,099: 25 blocks
    of 160 SNPs past the prefix) and their HostStreamedGenotypes with
    ``resident_q`` quad rows resident."""
    from mendeliht_tpu_torch.genotype.snparray import PackedGenotypes
    from mendeliht_tpu_torch.ops.streaming import HostStreamedGenotypes
    rng = np.random.default_rng(12)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(1000, 4099),
                       p=[0.45, 0.05, 0.3, 0.2])
    g = PackedGenotypes.from_codes(codes, device=device)
    row = g.words.shape[1] * 4
    s = HostStreamedGenotypes.from_snparray(
        g, block_bytes=block_q * row, resident_bytes=resident_q * row)
    return g, s


@pytest.mark.cuda
@pytest.mark.parametrize("resident_q", [0, 37])
def test_streamed_score_equals_kernel_1_on_card(cuda_device, resident_q):
    """The streamed ``xtr`` (m = 1 and 100) and ``col_moments`` (M and S)
    over at least 8 blocks, with no prefix and with a part of the matrix
    resident, equal kernel 1 on the resident words bit for bit: one launch
    a block and one for the prefix each pass, and ``words_t`` on neither
    the prefix nor the blocks."""
    import dataclasses
    from mendeliht_tpu_torch.ops.linalg import PackedOp
    from mendeliht_tpu_torch.ops.streaming import StreamedPackedOp
    g, s = _streamed_case(cuda_device, resident_q)
    sop = StreamedPackedOp(s)
    rop = PackedOp(dataclasses.replace(g, words_t=None))
    blocks = len(sop._blocks())
    assert blocks >= 8 and sop.p_res == 4 * resident_q
    assert sop.prefix is None or sop.prefix.words_t is None
    per_pass = blocks + (resident_q > 0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for m_ in (1, 100):
        R = torch.randn((m_, g.n_pad), generator=gen, device=cuda_device)
        R[:, g.n:] = 0.0
        before = kernels.LAUNCHES["xt_dots_words"]
        got = sop.xtr(R)
        assert kernels.LAUNCHES["xt_dots_words"] == before + per_pass
        want = rop.xtr(R)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        W = (R > 0).to(torch.float32)
        for a, b in zip(sop.col_moments(W, W * R), rop.col_moments(W, W * R)):
            torch.cuda.synchronize()
            assert torch.equal(a, b)
    assert sop.copies == 4 * blocks
    idx = torch.randint(0, g.p, (3, 9), generator=gen, device=cuda_device)
    coef = torch.randn((3, 9), generator=gen, device=cuda_device)
    valid = torch.ones_like(coef)
    assert torch.equal(sop.forward_sel(idx, coef, valid),
                       rop.forward_sel(idx, coef, valid))
    assert sop.syncs == 1


@pytest.mark.cuda
def test_streamed_words_unregistered_when_operator_freed(cuda_device):
    """The host words are page-locked by the first operator and stay so,
    with the resident prefix, while their genotypes live: every later
    operator (two genotypes over one buffer among them) reuses them, and
    the words are unregistered when the operators and the last genotypes
    over them are freed: registering them again then succeeds."""
    import dataclasses
    import gc
    from mendeliht_tpu_torch.ops.streaming import (StreamedPackedOp,
                                                   is_registered)
    _, s = _streamed_case(cuda_device, 37)
    words = s.words
    a = StreamedPackedOp(s)
    assert is_registered(words)
    b = StreamedPackedOp(s)
    assert b.prefix.words is a.prefix.words
    del a, b
    gc.collect()
    assert is_registered(words)
    t = dataclasses.replace(s)
    StreamedPackedOp(t)
    del s
    gc.collect()
    assert is_registered(words)
    del t
    gc.collect()
    assert not is_registered(words)
    cudart = torch.cuda.cudart()
    assert int(cudart.cudaHostRegister(words.ctypes.data, words.nbytes,
                                       0)) == 0
    assert int(cudart.cudaHostUnregister(words.ctypes.data)) == 0
