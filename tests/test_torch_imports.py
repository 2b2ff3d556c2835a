"""The port stands alone, and its wrappers dispatch by tensor device.

- No module of ``mendeliht_tpu_torch`` imports jax or the JAX package (an
  AST scan: jax may already sit in ``sys.modules`` of any process here).
- A CPU tensor takes the plain PyTorch version and builds nothing.
- On a CUDA card (marker ``cuda``), each hand-written kernel agrees with its
  plain version, and the two score kernels with each other.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import mendeliht_tpu_torch
from mendeliht_tpu_torch.genotype.snparray import _bytes_to_words, pack_codes
from mendeliht_tpu_torch.ops import decode, kernels

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
    assert {"ops/kernels.py", "ops/decode.py", "models/fit.py",
            "models/cv.py", "utils/profiling.py"} <= names
    for src in ("xt_dots.cu", "xt_dots_t.cu", "read_probe.cu"):
        assert (PKG / "csrc" / src).is_file()


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


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
    got = kernels.xt_dots_words_t(words_t, rhs, **kw)
    want = decode.xt_dots_words_t(words_t, rhs, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    c = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(kernels.read_words(words, c),
                       decode.read_words(words, c))
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 13])
def test_kernel_matches_plain_on_card(cuda_device, m):
    """CUDA kernel vs the plain version on the same card tensors, for every
    output plane, p not a multiple of 4, and a NaN column."""
    words, rhs = _case(3, n=1000, p=4099, m=m)
    rhs[5, m - 1] = float("nan")
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    before = kernels.LAUNCHES["xt_dots_words"]
    for want_missing in (False, True):
        for want_sq in (False, True):
            got = kernels.xt_dots_words(words, rhs, want_missing=want_missing,
                                        want_sq=want_sq, p=4099)
            ref = decode.xt_dots_words(words, rhs, want_missing=want_missing,
                                       want_sq=want_sq, p=4099)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert (g is None) == (r is None)
                if g is None:
                    continue
                assert torch.isnan(g[:, m - 1]).all()
                g, r = g[:, :m - 1], r[:, :m - 1]
                if m > 1:
                    err = (g - r).abs().max() / r.abs().max().clamp(min=1.0)
                    assert float(err) < 2e-5
    assert kernels.LAUNCHES["xt_dots_words"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 13, 100])
def test_transposed_kernel_matches_plain_and_quad_on_card(cuda_device, m):
    """Transposed-layout kernel vs its plain version and vs the quad-word
    kernel on the same card tensors: every output plane, p not a multiple
    of 4, a NaN column."""
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
                for other in (r, q):
                    a, b = g[:, :m - 1], other[:, :m - 1]
                    if m > 1:
                        scale = b.abs().max().clamp(min=1.0)
                        assert float((a - b).abs().max() / scale) < 2e-5
    assert kernels.LAUNCHES["xt_dots_words_t"] == before["xt_dots_words_t"] + 4
    assert kernels.LAUNCHES["xt_dots_words"] == before["xt_dots_words"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 100])
def test_score_kernels_hold_bound_at_large_n(cuda_device, m):
    """Both score kernels against the plain version where each SNP sums
    200,000 samples, for every output plane: the f32 rounding of a long sum
    stays inside the 2e-5 bound."""
    n, p = 200_000, 67
    words, rhs = _case(7, n=n, p=p, m=m)
    words, rhs = words.to(cuda_device), rhs.to(cuda_device)
    words_t = kernels.build_words_t(words, p)
    for want_missing in (False, True):
        for want_sq in (False, True):
            kw = dict(want_missing=want_missing, want_sq=want_sq, p=p)
            ref = decode.xt_dots_words(words, rhs, **kw)
            for got in (kernels.xt_dots_words(words, rhs, **kw),
                        kernels.xt_dots_words_t(words_t, rhs, **kw)):
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    if r is None:
                        continue
                    err = (g - r).abs().max() / r.abs().max().clamp(min=1.0)
                    assert float(err) < 2e-5


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
