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

LAUNCHES = {"xt_dots_words": 0}


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
def _xt_dots_fn():
    fn = ctypes.CDLL(str(build_library("xt_dots"))).xt_dots_words
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if rhs.dtype != torch.float32:
        raise ValueError(f"rhs must be float32 on CUDA, got {rhs.dtype}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    p4, n4 = words.shape
    m = rhs.shape[1]
    if max(p4, n4, m) >= 2**31:                 # the C entry takes int sizes
        raise ValueError(f"shape out of range: words {tuple(words.shape)}, m={m}")
    rhs_t = rhs.t().contiguous()                             # (m, n_pad)
    p_all = 4 * p4
    kw = dict(dtype=torch.float32, device=words.device)
    A = torch.empty((m, p_all), **kw)
    M = torch.empty((m, p_all), **kw) if want_missing else None
    S = torch.empty((m, p_all), **kw) if want_sq else None
    fn = _xt_dots_fn()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), rhs_t.data_ptr(), A.data_ptr(),
                 M.data_ptr() if M is not None else None,
                 S.data_ptr() if S is not None else None,
                 p4, n4, m, int(want_missing), int(want_sq), stream)
    if err != 0:
        raise RuntimeError(f"xt_dots_words kernel launch failed: CUDA error {err}")
    LAUNCHES["xt_dots_words"] += 1
    p_out = p_all if p is None else p

    def cut(out):
        return None if out is None else out.t()[:p_out]

    return cut(A), cut(M), cut(S)
