"""Wrappers of the hand-written CUDA kernels, dispatched by tensor device.

A CPU tensor takes the kernel's plain PyTorch version (``ops/decode.py``).
A CUDA tensor launches the kernel, built at first use from ``csrc/`` with
``nvcc`` into ``_build/`` (keyed by a hash of the source and flags) and
loaded with ctypes; a failed build or launch raises.  There is no fallback
from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import decode

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"xt_dots_words": 0, "xt_dots_words_t": 0, "read_words": 0}

# words, rhs, A, M, S pointers; three sizes and two flags; the stream
_SCORE_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.is_file() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                           "kernels are built from csrc/ at first use")
    return nvcc


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/<name>-<hash>.so`` unless that
    file exists; the compiler's report (registers, spills) is kept beside it
    as ``.log``.  Raises if nvcc is missing or fails."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"{name}-{digest}.so"
    if out.is_file():
        return out
    _BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _entry(source: str, name: str, argtypes: tuple):
    """The C entry point ``name`` of ``csrc/<source>.cu``, built at first
    use."""
    fn = getattr(ctypes.CDLL(str(build_library(source))), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_card_tensor(name: str, t: torch.Tensor, dtype: torch.dtype):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on CUDA, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def _launch(name: str, fn, device, *args):
    """Call a C entry on ``device``'s current stream; raise on a CUDA error
    and count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def xt_dots_words(words: torch.Tensor, rhs: torch.Tensor, *,
                  want_missing: bool, want_sq: bool = False,
                  p: int | None = None):
    """Fused decode + multi-RHS dots over the quad-word storage.

    words (p4, n4) int32; rhs (4*n4, m) float32.  Returns (A, M, S), each
    (p, m) float32 or None (M without ``want_missing``, S without
    ``want_sq``); ``p`` slices off the quad-padding rows (default 4*p4).
    The contract of ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words``."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be 2-D int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if rhs.dim() != 2 or rhs.shape[0] != 4 * words.shape[1]:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match words "
                         f"{tuple(words.shape)}: need (4*n4, m)")
    if rhs.device != words.device:
        raise ValueError(f"words on {words.device}, rhs on {rhs.device}")
    if words.device.type == "cpu":
        return decode.xt_dots_words(words, rhs, want_missing=want_missing,
                                    want_sq=want_sq, p=p)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    _check_card_tensor("words", words, torch.int32)
    p4, n4 = words.shape
    m = rhs.shape[1]
    if max(p4, n4, m) >= 2**31:                 # the C entry takes int sizes
        raise ValueError(f"shape out of range: words {tuple(words.shape)}, m={m}")
    rhs_t = rhs.t().contiguous()                             # (m, n_pad)
    _check_card_tensor("rhs", rhs_t, torch.float32)
    A, M, S = _outputs(m, 4 * p4, want_missing, want_sq, words.device)
    fn = _entry("xt_dots", "xt_dots_words", _SCORE_ARGS)
    _launch("xt_dots_words", fn, words.device, words.data_ptr(),
            rhs_t.data_ptr(), *_ptrs(A, M, S), p4, n4, m, int(want_missing),
            int(want_sq))
    return _cut(A, M, S, p)


def _outputs(m: int, p_all: int, want_missing: bool, want_sq: bool, device):
    """Kernel outputs A, M, S as (m, p_all) float32, M / S None unless
    wanted."""
    kw = dict(dtype=torch.float32, device=device)
    return (torch.empty((m, p_all), **kw),
            torch.empty((m, p_all), **kw) if want_missing else None,
            torch.empty((m, p_all), **kw) if want_sq else None)


def _ptrs(*outs):
    return tuple(None if o is None else o.data_ptr() for o in outs)


def _cut(A, M, S, p: int | None):
    """(m, p_all) kernel outputs -> (p, m) views; ``p`` slices off the
    quad-padding SNPs (default: keep all p_all)."""
    p_out = A.shape[1] if p is None else p
    return tuple(None if o is None else o.t()[:p_out] for o in (A, M, S))


def build_words_t(words: torch.Tensor, p: int,
                  chunk_q: int = 32768) -> torch.Tensor:
    """The transposed per-SNP word view ``words_t (n4/4, 4*p4)`` int32 of the
    quad words ``words (p4, n4)``, on their device: word (w, j) holds bytes
    4w..4w+3 of SNP j's crumb-transposed row, so its crumb q of byte b is
    sample ``q*n4 + 4w + b``.  The pad columns past ``p`` are zero.

    Plain torch ops (byte views and a transpose), as the JAX package does
    this relayout in XLA (``pallas_kernels.build_words_t``), chunked over
    ``chunk_q`` quad rows so the transient stays O(chunk) beyond input and
    output."""
    p4, n4 = words.shape
    if words.dtype != torch.int32 or n4 % 4:
        raise ValueError(f"words must be (p4, n4) int32 with n4 % 4 == 0, "
                         f"got {words.dtype} {tuple(words.shape)}")
    if not 4 * (p4 - 1) < p <= 4 * p4:
        raise ValueError(f"p={p} does not fit {p4} quad rows")
    nw = n4 // 4
    out = torch.empty((nw, 4 * p4), dtype=torch.int32, device=words.device)
    for lo in range(0, p4, chunk_q):
        hi = min(lo + chunk_q, p4)
        rows = decode.quad_rows_bytes(words[lo:hi])          # (4c, n4) u8
        out[:, 4 * lo:4 * hi] = rows.contiguous().view(torch.int32).T
    return out


def xt_dots_words_t(words_t: torch.Tensor, rhs: torch.Tensor, *,
                    want_missing: bool, want_sq: bool = False,
                    p: int | None = None):
    """Fused decode + multi-RHS dots over the transposed per-SNP words.

    words_t (nw = n4/4, 4*p4) int32 (``build_words_t``); rhs (16*nw, m)
    float32.  Returns (A, M, S) like ``xt_dots_words``.  The contract of
    ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words_t``."""
    if words_t.dtype != torch.int32 or words_t.dim() != 2:
        raise ValueError(f"words_t must be 2-D int32, got {words_t.dtype} "
                         f"{tuple(words_t.shape)}")
    if words_t.shape[1] % 4:
        raise ValueError(f"words_t {tuple(words_t.shape)}: the SNP columns "
                         "must be quad-padded (a multiple of 4)")
    if rhs.dim() != 2 or rhs.shape[0] != 16 * words_t.shape[0]:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match words_t "
                         f"{tuple(words_t.shape)}: need (16*nw, m)")
    if rhs.device != words_t.device:
        raise ValueError(f"words_t on {words_t.device}, rhs on {rhs.device}")
    if words_t.device.type == "cpu":
        return decode.xt_dots_words_t(words_t, rhs, want_missing=want_missing,
                                      want_sq=want_sq, p=p)
    if words_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {words_t.device}")
    _check_card_tensor("words_t", words_t, torch.int32)
    nw, p_all = words_t.shape
    m = rhs.shape[1]
    if max(nw, p_all, m) >= 2**31:
        raise ValueError(f"shape out of range: words_t "
                         f"{tuple(words_t.shape)}, m={m}")
    rhs_t = rhs.t().contiguous()                             # (m, n_pad)
    _check_card_tensor("rhs", rhs_t, torch.float32)
    A, M, S = _outputs(m, p_all, want_missing, want_sq, words_t.device)
    fn = _entry("xt_dots_t", "xt_dots_words_t", _SCORE_ARGS)
    _launch("xt_dots_words_t", fn, words_t.device, words_t.data_ptr(),
            rhs_t.data_ptr(), *_ptrs(A, M, S), nw, p_all, m,
            int(want_missing), int(want_sq))
    return _cut(A, M, S, p)


def read_words(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Read every word once: ``c + sum(words)`` in wrapping int32, as a (1,)
    int32 tensor on the words' device; ``c`` is a (1,) int32 tensor there.
    The read-bandwidth probe (``mendeliht_tpu.utils.profiling.
    _pallas_reader``)."""
    if words.dtype != torch.int32:
        raise ValueError(f"words must be int32, got {words.dtype}")
    if c.shape != (1,) or c.dtype != torch.int32:
        raise ValueError(f"c must be a (1,) int32 tensor, got {c.dtype} "
                         f"{tuple(c.shape)}")
    if c.device != words.device:
        raise ValueError(f"words on {words.device}, c on {c.device}")
    if words.device.type == "cpu":
        return decode.read_words(words, c)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    _check_card_tensor("words", words, torch.int32)
    out = c.clone()
    fn = _entry("read_probe", "read_words",
                (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p))
    _launch("read_words", fn, words.device, words.data_ptr(), words.numel(),
            out.data_ptr())
    return out
