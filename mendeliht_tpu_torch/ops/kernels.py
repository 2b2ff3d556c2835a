"""Wrappers of the hand-written CUDA kernels, dispatched by tensor device.

A CPU tensor takes the kernel's plain PyTorch version (``ops/decode.py``).
A CUDA tensor launches the kernel, built at first use from ``csrc/`` with
``nvcc`` into ``_build/`` (keyed by a hash of the source and flags) and
loaded with ctypes; a failed build or launch raises.  There is no fallback
from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels; the float64 score's launches of kernels
1 and 2 count under their own names (``xt_dots_words_f64``,
``xt_dots_words_t_f64``).
"""

from __future__ import annotations

import ctypes
import dataclasses
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

LAUNCHES = {"xt_dots_words": 0, "xt_dots_words_t": 0, "read_words": 0,
            "xt_dots_T": 0, "unpack_words": 0, "int_dot_packed": 0,
            "xt_i8_rounds": 0, "stream_xor": 0, "decode_only": 0,
            "xt_dots_words_f64": 0, "xt_dots_words_t_f64": 0}

# the float64 launches: their raw-sum entry of csrc/xt_dots_t.cu
_RAW_ENTRIES = {"xt_dots_words_f64": "xt_dots_words_raw",
                "xt_dots_words_t_f64": "xt_dots_words_t_raw"}

TP = 1024          # the round-3 probe's row tile (tools/kernel_probe.py)
# copies of the small operand that the packed-lhs dot stages, so that its
# blocks spread their reads of it over that many times the L2 lines
_Y_COPIES = 8

# the score kernels' entries (csrc/xt_dots_t.cu): words, digits, scale,
# guard, A, M, S pointers; nw, p_all, m, two flags and the plan; the stream
_SCORE_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


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
    file exists (the hash covers the source, the shared ``csrc/*.cuh``
    headers and the flags); the compiler's report (registers, spills) is kept
    beside it as ``.log``.  Raises if nvcc is missing or fails."""
    src = _CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
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
    """Fused decode + multi-RHS dots over the quad-word storage through int8
    digit planes of R.

    words (p4, n4) int32; rhs (4*n4, m) float.  Returns (A, M, S), each
    (p, m) float32 or None (M without ``want_missing``, S without
    ``want_sq``); ``p`` slices off the quad-padding rows (default 4*p4).
    The function of ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words``, as
    ``xt_dots_words_t`` is of its transposed kernel: the kernel equals its
    plain version (``decode.xt_dots_words``) and kernel 2 on the same
    genotypes bit for bit; past the exact range the wrapper raises before
    any work, on either device.  A float64 rhs takes the float64 digit
    score (float64 outputs; on the card the raw-sum entry, counted as
    ``xt_dots_words_f64``)."""
    _score_dims(words, rhs, transposed=False)
    return xt_dots_words_image(
        words, score_image(rhs, want_missing=want_missing, want_sq=want_sq),
        p=p)


@dataclasses.dataclass(frozen=True)
class ScoreImage:
    """What kernel 1 takes of an RHS besides the words: on the card the
    digit image, per-column scale, guard and plan of ``_digit_operands``
    (``_digit_operands64`` for a float64 RHS), made once and read by any
    number of launches (a streamed pass runs kernel 1 on each block of the
    words against one image); on the CPU nothing but the RHS, which the
    plain version reads."""
    rhs: torch.Tensor            # (n_pad, m) float
    want_missing: bool
    want_sq: bool
    operands: tuple | None       # (digits, scale, guard, plan), or None

    @property
    def m(self) -> int:
        return self.rhs.shape[1]

    @property
    def f64(self) -> bool:
        """Whether the image is of the float64 digit score."""
        return self.rhs.dtype == torch.float64


def score_image(rhs: torch.Tensor, *, want_missing: bool,
                want_sq: bool = False) -> ScoreImage:
    """The :class:`ScoreImage` of ``rhs`` (n_pad, m) on its device: a
    CUDA RHS (n_pad a multiple of 16, the quad words' n4 a multiple of 4)
    is quantised and laid out here, once.  The per-column scale depends on
    R alone, so every launch on the image gives the whole-matrix launch's
    columns of its SNPs bit for bit."""
    if rhs.dim() != 2:
        raise ValueError(f"rhs must be 2-D, got {tuple(rhs.shape)}")
    if rhs.device.type == "cpu":
        return ScoreImage(rhs, want_missing, want_sq, None)
    if rhs.device.type != "cuda":
        raise ValueError(f"no kernel for device {rhs.device}")
    if rhs.shape[0] % 16:
        raise ValueError(f"rhs {tuple(rhs.shape)}: n_pad must be a multiple "
                         "of 16 (16-byte loads, the digit image's K steps)")
    make = (_digit_operands64 if rhs.dtype == torch.float64
            else _digit_operands)
    return ScoreImage(rhs, want_missing, want_sq, make(
        rhs, rhs.shape[0] // 16, want_missing, want_sq))


def xt_dots_words_image(words: torch.Tensor, image: ScoreImage,
                        p: int | None = None):
    """Kernel 1 (``xt_dots_words``) on the quad words ``words`` (p4, n4)
    against a :class:`ScoreImage` of an RHS (4*n4, m): (A, M, S) as
    ``xt_dots_words`` returns them, one launch counted as
    ``xt_dots_words`` (``xt_dots_words_f64`` for a float64 image).  On a
    CPU tensor the plain version ``decode.xt_dots_words`` of the image's
    RHS."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be 2-D int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    rhs = image.rhs
    p4, n4 = words.shape
    if rhs.shape[0] != 4 * n4:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match words "
                         f"{tuple(words.shape)}: need (4*n4, m)")
    if rhs.device != words.device:
        raise ValueError(f"words on {words.device}, rhs on {rhs.device}")
    _check_exact_range("words", words, 4 * n4, 4 * p4, image.m)
    if words.device.type == "cpu":
        return decode.xt_dots_words(words, rhs,
                                    want_missing=image.want_missing,
                                    want_sq=image.want_sq, p=p)
    launch = _launch_score64 if image.f64 else _launch_score
    return launch("xt_dots_words_f64" if image.f64 else "xt_dots_words",
                  words, image.operands, n4 // 4, 4 * p4, image.m,
                  image.want_missing, image.want_sq, p)


def _score_dims(arr: torch.Tensor, rhs: torch.Tensor, *, transposed: bool):
    """Check the words of a score (``words_t`` (nw, p_all) when
    ``transposed``, else the quad words (p4, n4)) against its RHS (n_pad,
    m) and the exact range, on a device with a kernel or its plain
    version; returns (nw, p_all)."""
    name = "words_t" if transposed else "words"
    if arr.dtype != torch.int32 or arr.dim() != 2:
        raise ValueError(f"{name} must be 2-D int32, got {arr.dtype} "
                         f"{tuple(arr.shape)}")
    if transposed and arr.shape[1] % 4:
        raise ValueError(f"words_t {tuple(arr.shape)}: the SNP columns "
                         "must be quad-padded (a multiple of 4)")
    if transposed:
        (nw, p_all), n_pad, need = arr.shape, 16 * arr.shape[0], "16*nw"
    else:
        nw, p_all = arr.shape[1] // 4, 4 * arr.shape[0]
        n_pad, need = 4 * arr.shape[1], "4*n4"
    if rhs.dim() != 2 or rhs.shape[0] != n_pad:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match {name} "
                         f"{tuple(arr.shape)}: need ({need}, m)")
    _check_exact_range(name, arr, n_pad, p_all, rhs.shape[1])
    if rhs.device != arr.device:
        raise ValueError(f"{name} on {arr.device}, rhs on {rhs.device}")
    if arr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {arr.device}")
    return nw, p_all


def _check_exact_range(name: str, arr: torch.Tensor, n_pad: int, p_all: int,
                       m: int):
    """Raise before any work where the int32 digit sums of the score
    kernels would not be exact (128 * n_pad >= 2^31) or a size exceeds the
    C entry's ints."""
    if 128 * n_pad >= 2**31 or max(p_all, m) >= 2**31:
        raise ValueError(f"shape out of range: {name} {tuple(arr.shape)}, "
                         f"m={m} (the int32 digit sums are exact only below "
                         "2^31)")


def _digit_operands(rhs: torch.Tensor, nw: int, want_missing: bool,
                    want_sq: bool, guarded: bool = True):
    """What the score kernels take besides the words, made by torch ops
    as XLA makes them around the Pallas call: the digit image
    (``_digit_stages_t``), the per-column scale, the guard and the plan
    (ng, split, passes) of ``score_plan_t``.  The guard is the NaN guard
    where the JAX kernel re-poisons a non-finite column (``guarded``), else
    zeros: adding +0.0 leaves every score bit as it is."""
    planes, scale = decode.quantize_rhs_planes(rhs)
    guard = (decode.nan_guard(rhs) if guarded
             else torch.zeros_like(scale))
    ng, split, passes = score_plan_t(rhs.shape[1],
                                     1 + want_missing + want_sq)
    digits = _digit_stages_t(_digit_rows_t(planes, nw, ng, split, passes),
                             passes)
    for name, t, dtype in (("digits", digits, torch.int8),
                           ("scale", scale, torch.float32),
                           ("guard", guard, torch.float32)):
        _check_card_tensor(name, t, dtype)
    return digits, scale, guard, (ng, int(split), passes)


def pseudo_planes64(planes: torch.Tensor) -> torch.Tensor:
    """(8m, n_pad) int8 digit planes (``decode.quantize_rhs_planes64``,
    row d*m + c) -> (9m, n_pad) int8 planes of 3m pseudo-columns in the
    [hi|mid|lo] order of ``decode.quantize_rhs_planes``: pseudo-column 3c +
    j holds digits 3j, 3j+1, 3j+2 of column c as its hi, mid and lo rows
    (digit 8 is a zero row), so the kernel's digit layout
    (``_digit_rows_t``) and loop run unchanged at m' = 3m."""
    m8, n_pad = planes.shape
    m = m8 // 8
    v9 = torch.cat([planes.view(8, m, n_pad),
                    planes.new_zeros((1, m, n_pad))])         # digit k: v9[k]
    return v9.view(3, 3, m, n_pad).permute(1, 2, 0, 3).reshape(9 * m, n_pad)


def _digit_operands64(rhs: torch.Tensor, nw: int, want_missing: bool,
                      want_sq: bool):
    """``_digit_operands`` of the float64 score: the digit image of the
    pseudo-columns (``pseudo_planes64``) laid out for m' = 3m, the (m,)
    float64 scale and guard, and the plan of ``score_plan_t`` at m'."""
    planes, scale = decode.quantize_rhs_planes64(rhs)
    guard = decode.nan_guard64(rhs)
    ng, split, passes = score_plan_t(3 * rhs.shape[1],
                                     1 + want_missing + want_sq)
    digits = _digit_stages_t(_digit_rows_t(pseudo_planes64(planes), nw, ng,
                                           split, passes), passes)
    _check_card_tensor("digits", digits, torch.int8)
    return digits, scale, guard, (ng, int(split), passes)


def _raw_sums64(name: str, words: torch.Tensor, digits: torch.Tensor,
                plan: tuple, nw: int, p_all: int, m: int, want_missing: bool,
                want_sq: bool):
    """Launch the float64 score ``name`` (kernel 1 or 2's raw-sum entry,
    ``_RAW_ENTRIES``) on ``words`` with ``_digit_operands64``'s digits and
    plan at m' = 3m and count it: the exact int32 sums of the value,
    missing and hi-bit planes, each (p_all, 8, m) (``raw_view64``)
    or None."""
    _check_card_tensor("words", words, torch.int32)
    kw = dict(dtype=torch.int32, device=words.device)
    wanted = (True, want_missing, want_sq)
    raw = [torch.empty((9 * m, p_all), **kw) if w else None for w in wanted]
    fn = _entry("xt_dots_t", _RAW_ENTRIES[name], _SCORE_ARGS)
    _launch(name, fn, words.device, words.data_ptr(), digits.data_ptr(),
            None, None, *_ptrs(*raw), nw, p_all, 3 * m, int(want_missing),
            int(want_sq), *plan)
    return tuple(None if r is None else raw_view64(r, m) for r in raw)


def _launch_score64(name: str, words: torch.Tensor, operands: tuple, nw: int,
                    p_all: int, m: int, want_missing: bool, want_sq: bool,
                    p: int | None):
    """The float64 score ``name`` on the card: the exact sums of its
    raw-sum entry (``_raw_sums64``) combined in float64 by
    ``decode.digit_outputs64`` (torch ops on the card).  Returns (A, M, S)
    float64 cut to ``p``."""
    digits, scale, guard, plan = operands
    sums = _raw_sums64(name, words, digits, plan, nw, p_all, m, want_missing,
                       want_sq)
    return decode.digit_outputs64(*sums, scale, guard, p)


def raw_sums64(arr: torch.Tensor, rhs: torch.Tensor, *, transposed: bool,
               want_missing: bool, want_sq: bool = False):
    """The exact digit sums of the float64 score on the card, before the
    combine: kernel 2's raw-sum entry on words_t (``transposed``) or kernel
    1's on the quad words, each launch counted as the float64 score's;
    (V'D, Miss'D or None, H'D or None), each (p_all, 8, m) int32, equal to
    the float64 sums of ``decode.digit_sums64`` of the same R bit for
    bit."""
    nw, p_all = _score_dims(arr, rhs, transposed=transposed)
    if rhs.dtype != torch.float64 or arr.device.type != "cuda":
        raise ValueError("raw_sums64 takes a float64 rhs on the card")
    digits, _, _, plan = _digit_operands64(rhs, nw, want_missing, want_sq)
    name = "xt_dots_words_t_f64" if transposed else "xt_dots_words_f64"
    return _raw_sums64(name, arr, digits, plan, nw, p_all, rhs.shape[1],
                       want_missing, want_sq)


def raw_view64(raw: torch.Tensor, m: int) -> torch.Tensor:
    """A raw-sum entry's output plane, (9m, p_all) int32 with row 3c' + d
    the sum of digit row d of pseudo-column c' = 3c + j (``pseudo_planes64``),
    -> the (p_all, 8, m) view of ``decode.combine_digits64``: digit 3j + d
    of column c (row 9c + 3j + d; the zero ninth digit dropped)."""
    return raw.view(m, 9, raw.shape[1]).permute(2, 1, 0)[:, :decode.DIGITS64]


# the lab's and the probe's A-only scores (kernels 6 and 7): their entry of
# csrc/xt_dots_t.cu; their JAX kernels have no NaN guard
_UNGUARDED = {"xt_dots_T": "xt_dots_words_t",
              "xt_i8_rounds": "xt_dots_words_rows"}


def _digit_score(name: str, words: torch.Tensor, rhs: torch.Tensor, nw: int,
                 p_all: int, want_missing: bool, want_sq: bool,
                 p: int | None):
    """Launch score kernel ``name`` on CUDA tensors and count it: kernels 1
    and 2 by ``csrc/xt_dots_t.cu``'s entry of that name (``xt_dots_words``
    on the quad words, ``xt_dots_words_t`` on the transposed words) with
    the NaN guard, kernels 6 and 7 by their ``_UNGUARDED`` entry with a zero
    guard; returns (A, M, S) cut to ``p``."""
    operands = _digit_operands(rhs, nw, want_missing, want_sq,
                               guarded=name not in _UNGUARDED)
    return _launch_score(name, words, operands, nw, p_all, rhs.shape[1],
                         want_missing, want_sq, p)


def _launch_score(name: str, words: torch.Tensor, operands: tuple, nw: int,
                  p_all: int, m: int, want_missing: bool, want_sq: bool,
                  p: int | None):
    """Launch score kernel ``name`` on ``words`` with the digit operands
    of ``_digit_operands`` and count it; returns (A, M, S) cut to ``p``."""
    _check_card_tensor("words", words, torch.int32)
    digits, scale, guard, plan = operands
    A, M, S = _outputs(m, p_all, want_missing, want_sq, words.device)
    fn = _entry("xt_dots_t", _UNGUARDED.get(name, name), _SCORE_ARGS)
    _launch(name, fn, words.device, words.data_ptr(), digits.data_ptr(),
            scale.data_ptr(), guard.data_ptr(), *_ptrs(A, M, S), nw, p_all,
            m, int(want_missing), int(want_sq), *plan)
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


# column groups of 8 a warpgroup that csrc/xt_dots_t.cu is built for, and
# the most groups x output planes a warpgroup's registers hold
_NG_T = (1, 2, 4, 7, 13)
_NG_PLANES_T = 14


def score_plan_t(m: int, planes: int):
    """(ng, split, passes) of the transposed score kernel for m columns and
    ``planes`` output planes (1 + want_missing + want_sq): m <= 2 takes one
    8-row digit group (ng = 0); else ng column groups of 8 a warpgroup, the
    fewest of ``_NG_T`` that hold the columns, with the two warpgroups of a
    block on 128 SNPs (split False) or, where one warpgroup's registers do
    not hold the columns, splitting the groups of 64 SNPs (split True, at
    most 7 groups each, so three stages of digits fit shared memory); wider
    R takes passes of the most groups on 128 SNPs."""
    if m <= 2:
        return 0, False, 1
    groups = -(-m // 8)
    cap = min(_NG_PLANES_T // planes, max(_NG_T))
    fit = lambda g: min(x for x in _NG_T if x >= g)          # noqa: E731
    if groups <= cap:
        return fit(groups), False, 1
    if groups <= 2 * min(cap, 7):
        return fit(-(-groups // 2)), True, 1
    ng = max(x for x in _NG_T if x <= cap)
    return ng, False, -(-groups // ng)


@functools.lru_cache(maxsize=64)
def _digit_source_t(m: int, ng: int, split: bool, passes: int, device):
    """For each digit row of the kernel's order, the row of the (3m, n_pad)
    digit planes it holds, or 3m for a zero row (``_digit_rows_t``)."""
    r = torch.arange(8 if ng == 0 else 24 * ng * (2 if split else 1))
    if ng == 0:
        d, c, cols = r // 2, r % 2, 2
    else:
        d, c, cols = (r % 24) // 8, (r // 24) * 8 + r % 8, len(r) // 3
    col = torch.arange(passes)[:, None] * cols + c
    src = torch.where((d < 3) & (col < m), d * m + col, 3 * m).reshape(-1)
    return src.to(device)


def score_row_map(m: int, planes: int, f64: bool, device) -> torch.Tensor:
    """The cached device tensor that a card score of an RHS m wide with
    ``planes`` output planes (float64 where ``f64``) reads besides the
    words and its RHS: the digit-row map of ``_digit_source_t``.  A
    caller that records the score in a CUDA graph keys on its address."""
    m = 3 * m if f64 else m
    return _digit_source_t(m, *score_plan_t(m, planes), device)


def _digit_rows_t(planes: torch.Tensor, nw: int, ng: int, split: bool,
                  passes: int) -> torch.Tensor:
    """(3m, 16*nw) digit planes [hi|mid|lo] -> (passes*rows, 4, k4) int8 in
    xt_dots_t.cu's order: plane q of a row its samples q*4nw .. with zeros
    after; row 24b + 8d + r of a pass is digit d of the pass's column 8b + r
    (ng = 0: 8 rows, row 2d + c digit d of column c); rows of no column are
    zero.  k4 = 4*nw rounded up to 128 (K steps of 32 samples, a multiple
    of 4)."""
    n4 = 4 * nw
    k4 = 128 * -(-nw // 32)
    src = _digit_source_t(planes.shape[0] // 3, ng, split, passes,
                          planes.device)
    padded = torch.cat([planes, planes.new_zeros((1, planes.shape[1]))])
    out = planes.new_zeros((len(src), 4, k4))
    out[:, :, :n4] = padded[src].view(-1, 4, n4)
    return out


def _digit_stages_t(rows_t: torch.Tensor, passes: int) -> torch.Tensor:
    """``_digit_rows_t``'s (passes*rows, 4, k4) -> the kernel's shared-memory
    image of each K step, (passes, k4/32, 4, 2, rows/8, 8, 16) int8: for
    pass, K step, plane q and K half, the 8-row x 16-byte core matrices of
    the rows, so one K step of one pass is one contiguous copy."""
    r, _, k4 = rows_t.shape
    v = rows_t.view(passes, r // passes // 8, 8, 4, k4 // 32, 2, 16)
    return v.permute(0, 4, 3, 5, 1, 2, 6).contiguous()


def xt_dots_words_t(words_t: torch.Tensor, rhs: torch.Tensor, *,
                    want_missing: bool, want_sq: bool = False,
                    p: int | None = None):
    """Fused decode + multi-RHS dots over the transposed per-SNP words
    through int8 digit planes of R.

    words_t (nw = n4/4, 4*p4) int32 (``build_words_t``); rhs (16*nw, m)
    float.  Returns (A, M, S) like ``xt_dots_words``, f32.  The function of
    ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words_t``: its integer sums
    are exact while 128 * 16*nw < 2^31, and past that the wrapper raises
    before any work, on either device.  The digit planes and their layout
    are torch ops here, as XLA runs them around the Pallas call; the kernel
    equals its plain version (``decode.xt_dots_words_t``) bit for bit.  A
    float64 rhs takes the float64 digit score: the raw-sum entry of the
    same body (counted as ``xt_dots_words_t_f64``), its sums combined in
    float64, float64 outputs equal to the plain version's bit for bit."""
    nw, p_all = _score_dims(words_t, rhs, transposed=True)
    if words_t.device.type == "cpu":
        return decode.xt_dots_words_t(words_t, rhs, want_missing=want_missing,
                                      want_sq=want_sq, p=p)
    if rhs.dtype == torch.float64:
        return _launch_score64(
            "xt_dots_words_t_f64", words_t,
            _digit_operands64(rhs, nw, want_missing, want_sq), nw, p_all,
            rhs.shape[1], want_missing, want_sq, p)
    return _digit_score("xt_dots_words_t", words_t, rhs, nw, p_all,
                        want_missing, want_sq, p)


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


def xt_dots_T(words_t: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Value dots A = V'R over the transposed per-SNP words through int8
    digit planes of R: words_t (nw, p_all) int32 (``build_words_t``), rhs
    (16*nw, m) float32 -> (p_all, m) float32.  The contract of
    ``tools/kernel_lab5.py::xt_dots_T`` (A only, no NaN re-poisoning;
    missing crumbs count 0): kernel 2's A with a zero guard, launched from
    its entry and counted as ``xt_dots_T``, so it equals its plain version
    and kernel 2's A bit for bit.  A ``p_all`` that is not a multiple of 4
    is padded with zero columns for the kernel's 16-byte runs, a copy that
    ``build_words_t``'s output never needs."""
    if words_t.dtype != torch.int32 or words_t.dim() != 2:
        raise ValueError(f"words_t must be 2-D int32, got {words_t.dtype} "
                         f"{tuple(words_t.shape)}")
    if rhs.dim() != 2 or rhs.shape[0] != 16 * words_t.shape[0]:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match words_t "
                         f"{tuple(words_t.shape)}: need (16*nw, m)")
    if rhs.device != words_t.device:
        raise ValueError(f"words_t on {words_t.device}, rhs on {rhs.device}")
    if words_t.device.type == "cpu":
        return decode.xt_dots_T(words_t, rhs)
    if words_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {words_t.device}")
    nw, p_all = words_t.shape
    _check_exact_range("words_t", words_t, 16 * nw, p_all, rhs.shape[1])
    if p_all % 4:
        words_t = torch.cat([words_t, words_t.new_zeros((nw, -p_all % 4))],
                            dim=1)
    return _digit_score("xt_dots_T", words_t, rhs, nw, words_t.shape[1],
                        False, False, p_all)[0]


def unpack_words(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(r, c) int32 -> (32/bits * r, c) int32 sign-extended ``bits``-wide
    fields in ``pltpu.bitcast``'s word-major order (``decode.unpack_words``):
    the body ``k_bitcast`` of ``tools/kernel_lab5.py::probe_int4``."""
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be 2-D int32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.device.type == "cpu":
        return decode.unpack_words(x, bits)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_card_tensor("x", x, torch.int32)
    r, c = x.shape
    out = torch.empty((32 // bits * r, c), dtype=torch.int32, device=x.device)
    fn = _entry("int_probe", "unpack_words",
                (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 2
                + (ctypes.c_int, ctypes.c_void_p))
    _launch("unpack_words", fn, x.device, x.data_ptr(), out.data_ptr(), r, c,
            bits)
    return out


def int_dot_packed(x_words: torch.Tensor, y: torch.Tensor, bits: int,
                   lhs_packed: bool = True,
                   general: bool = False) -> torch.Tensor:
    """Exact int32 dot with one packed operand: the ``bits``-wide fields of
    x_words (``unpack_words``) against y cast to int8, as the left operand
    (``lhs_packed``: (32/bits*r, c) . (c, N)) or the right one ((M, K) .
    (32/bits*r, c)).  The bodies ``k_dot_i4_i8`` / ``k_dot_i8_weights_i4``
    of ``tools/kernel_lab5.py::probe_int4`` and ``bench_int4_ingestion``'s
    kernel.  Mismatched contracting dimensions raise dot_general's
    TypeError before any launch.  ``general`` (packed rhs only) launches
    the guarded ``rhs_dot_kernel`` also at the lab probe's shape, which
    otherwise takes its unguarded instantiation: the same result, to time
    the two against each other."""
    if general and lhs_packed:
        raise ValueError("general selects a packed-rhs instantiation; "
                         "pass lhs_packed=False")
    if x_words.dtype != torch.int32 or x_words.dim() != 2:
        raise ValueError(f"x_words must be 2-D int32, got {x_words.dtype} "
                         f"{tuple(x_words.shape)}")
    if y.dim() != 2 or y.dtype.is_floating_point or y.dtype.is_complex:
        raise ValueError(f"y must be a 2-D integer tensor, got {y.dtype} "
                         f"{tuple(y.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if y.device != x_words.device:
        raise ValueError(f"x_words on {x_words.device}, y on {y.device}")
    if x_words.device.type == "cpu":
        return decode.int_dot_packed(x_words, y, bits, lhs_packed)
    if x_words.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_words.device}")
    _check_card_tensor("x_words", x_words, torch.int32)
    rows, xc = 32 // bits * x_words.shape[0], x_words.shape[1]
    if lhs_packed:
        (M, K), (ky, N) = (rows, xc), y.shape
        decode.check_contraction(K, ky)
        # (copies, N, K): each block of the kernel reads one copy
        y8 = y.to(torch.int8).t().expand(_Y_COPIES, N, K).contiguous()
    else:
        (M, ky), (K, N) = y.shape, (rows, xc)
        decode.check_contraction(ky, K)
        y8 = y.to(torch.int8).contiguous()                   # (M, K)
    if K % 32 or max(M, N, K) >= 2**31:
        raise ValueError(f"contracting dimension {K} must be a multiple of "
                         "32 (one MMA step), sizes below 2^31")
    _check_card_tensor("y", y8, torch.int8)
    out = torch.empty((M, N), dtype=torch.int32, device=x_words.device)
    fn = _entry("int_probe", "int_dot_packed",
                (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8
                + (ctypes.c_void_p,))
    _launch("int_dot_packed", fn, x_words.device, x_words.data_ptr(),
            y8.data_ptr(), out.data_ptr(), M, N, K, xc, bits,
            int(lhs_packed), _Y_COPIES, int(general))
    return out


def _check_tile(name: str, v):
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        raise ValueError(f"{name} must be a positive int, got {v!r}")


def xt_i8_rounds(words: torch.Tensor, rhs: torch.Tensor, tp: int = TP,
                 tw: int | None = None) -> torch.Tensor:
    """Value dots A = V'R over the round-3 row-major words through int8
    digit planes of R: words (p, nw) int32 (``words_t.T``), rhs (16*nw, m)
    float32 -> (p, m) float32.  The contract of ``tools/kernel_probe.py::
    xt_i8_rounds``: kernel 2's A on the row-major words with a zero guard
    (``csrc/xt_dots_t.cu``'s ROW loader), equal bit for bit to its plain
    version and to ``xt_dots_T(words.T, rhs)``.

    ``tp`` (the reference's SNP rows a grid step) is validated and
    otherwise a no-op: the kernel's persistent blocks take 128-SNP tiles in
    turn whatever it is.  ``tw`` (the reference's word-column tile) is
    accepted only as None or nw: the exact integer sums do not depend on
    either, and the kernel tiles the words itself.  An rhs of another
    height than 16*nw (the quad words' (4*n4, m) included) raises before
    any work."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be 2-D int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    p, nw = words.shape
    if rhs.dim() != 2 or rhs.shape[0] != 16 * nw:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match words "
                         f"{tuple(words.shape)}: need (16*nw, m), the "
                         "round-3 layout")
    _check_tile("tp", tp)
    if tw is not None and tw != nw:
        raise ValueError(f"tw must be None or nw = {nw}, got {tw!r}")
    if rhs.device != words.device:
        raise ValueError(f"words on {words.device}, rhs on {rhs.device}")
    _check_exact_range("words", words, 16 * nw, p, rhs.shape[1])
    if words.device.type == "cpu":
        return decode.xt_i8_rounds(words, rhs)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if nw % 4:
        raise ValueError(f"words {tuple(words.shape)}: nw must be a multiple "
                         "of 4 (16-byte loads)")
    return _digit_score("xt_i8_rounds", words, rhs, nw, p, False, False,
                        None)[0]


def _check_seeded(words: torch.Tensor, seed: torch.Tensor, tp: int):
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be 2-D int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if seed.shape != (1, 1) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be a (1, 1) int32 tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != words.device:
        raise ValueError(f"words on {words.device}, seed on {seed.device}")
    _check_tile("tp", tp)


def _xor_launch(name: str, words, seed, tp: int, tw: int):
    """Launch ``stream_xor`` or ``decode_only`` into a (tp, tw) int32."""
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    _check_card_tensor("words", words, torch.int32)
    if tp * tw >= 2**31:
        raise ValueError(f"output ({tp}, {tw}) out of range")
    out = torch.empty((tp, tw), dtype=torch.int32, device=words.device)
    seed = seed.contiguous()
    fn = _entry("kernel_probe", "xor_tiles",
                (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
                + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    _launch(name, fn, words.device, words.data_ptr(), seed.data_ptr(),
            out.data_ptr(), *words.shape, tp, tw, int(name == "decode_only"))
    return out


def stream_xor(words: torch.Tensor, seed: torch.Tensor,
               tp: int = TP) -> torch.Tensor:
    """The streaming-read probe: words (p, nw) int32, seed (1, 1) int32 on
    the words' device -> (tp, nw) int32, row r the XOR of ``words[i*tp + r]
    + seed`` (wrapping) over the row tiles i.  ``tools/kernel_probe.py::
    stream_xor``; rows past p are absent (``decode.stream_xor``)."""
    _check_seeded(words, seed, tp)
    if words.device.type == "cpu":
        return decode.stream_xor(words, seed, tp)
    return _xor_launch("stream_xor", words, seed, tp, words.shape[1])


def decode_only(words: torch.Tensor, seed: torch.Tensor, tp: int = TP,
                tw: int | None = None) -> torch.Tensor:
    """The decode-only probe: words (p, nw) int32, seed (1, 1) int32 on the
    words' device -> (tp, tw) int32, the XOR over every (tp, tw) tile of the
    16-crumb value sums of ``words + seed``.  ``tools/kernel_probe.py::
    decode_only``; ``tw`` (default nw) is honoured, and rows and word
    columns past the array are absent (``decode.decode_only``)."""
    _check_seeded(words, seed, tp)
    tw = words.shape[1] if tw is None else tw
    _check_tile("tw", tw)
    if words.device.type == "cpu":
        return decode.decode_only(words, seed, tp, tw)
    return _xor_launch("decode_only", words, seed, tp, tw)
