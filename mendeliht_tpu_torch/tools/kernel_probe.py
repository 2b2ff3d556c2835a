"""The round-3 kernel probe on a CUDA card (the JAX package's
``tools/kernel_probe.py``): candidate designs of the 2-bit decode-matmul on
the retired row-major layout ``words (p, nw)`` with 16 decode rounds.

Variants, each timed at the RHS widths given (default 1, 8, 64):

  v0      - the quad-word score (kernel 1, ``kernels.xt_dots_words``)
  v1      - the 16-round int8 digit-plane score (kernel 7,
            ``kernels.xt_i8_rounds``, the row-major loader of
            ``csrc/xt_dots_t.cu``) on the round-3 words; ``v1tp512`` /
            ``v1tp2048`` ask for 512 / 2048 SNP rows a grid step, which the
            kernel takes as a no-op (its blocks take 128-SNP tiles)
  stream  - XOR-accumulate read of the quad words (kernel 8): the read ceiling
  decode  - the 16-round decode alone, XOR-accumulated (kernel 9)

Every timed loop is carry-dependent through a small operand (the rhs, or a
(1, 1) seed added inside the kernel), so no call can be skipped, and none
copies the words.  Timings are device time from CUDA events and raise off
the card.

    python -m mendeliht_tpu_torch.tools.kernel_probe [m ...]

prints its lines and writes no file.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..ops import decode, kernels
from ..ops.decode import quantize_rhs_planes, rounds_restride  # noqa: F401
from ..ops.kernels import (TP, decode_only, stream_xor,  # noqa: F401
                           xt_i8_rounds)
from ..utils import profiling
from .kernel_lab5 import load_problem

WIDTHS = (1, 8, 64)


def timeit(fn, words, rhs, iters=10) -> float:
    """Device seconds per call of ``fn(words, rhs) -> (p, m)``, each call's
    rhs carried from the previous output."""
    def step(r):
        out = fn(words, r)
        return r * (1.0 + out[0, 0] * 1e-12) + out[1, 0] * 1e-9

    return profiling._seconds_per_call(step, rhs, iters, words.device)


def timeit_roofline_style(fn, words, rhs, iters=10) -> float:
    """:func:`timeit` in the shape of ``profiling.kernel_roofline``'s loop:
    the rhs carried as there, and each output summed."""
    def step(state):
        r, _ = state
        a = fn(words, r)
        return r * (1.0 + a[1, 0] * 1e-12) + a[0, 0] * 1e-6, torch.sum(a)

    return profiling._seconds_per_call(step, (rhs, None), iters, words.device)


def timeit_seeded(fn, words, iters=10) -> float:
    """Device seconds per call of ``fn(words, seed (1, 1)) -> int32``, the
    seed carried through the output's first element."""
    def step(c):
        return c + fn(words, c)[0:1, 0:1]

    seed = torch.zeros((1, 1), dtype=torch.int32, device=words.device)
    return profiling._seconds_per_call(step, seed, iters, words.device)


def round3_words(g) -> torch.Tensor:
    """The retired round-3 layout of the genotypes ``g`` on their device:
    (4*p4, nw = n4/4) int32, row j SNP j's crumb-transposed byte row viewed
    as little-endian words (``words_t.T``; rows past p zero).  The byte
    rows' reshape is the one copy of the words, made on their device."""
    return decode.quad_rows_bytes(g.words).contiguous().view(torch.int32)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the kernel probe measures a CUDA device, not "
                           f"{dev}" + ("" if torch.cuda.is_available()
                                       else " (no CUDA device here)"))
    return dev


def main(argv=None, g=None, device="cuda:0") -> dict:
    """The probe: the read and decode ceilings over the quad words, kernel 7
    against kernel 1 at m = 2, then the six variants at each width in
    ``argv`` (default 1, 8, 64); a variant that fails prints FAILED and the
    run goes on.  ``g`` are the genotypes (default: the lab's 10k x 1M
    problem on ``device``).  Returns every number it printed."""
    argv = sys.argv[1:] if argv is None else argv
    dev = _device(device)
    ms = [int(a) for a in argv] or list(WIDTHS)
    g = load_problem(dev) if g is None else g
    _device(g.device)
    words = g.words
    w3 = round3_words(g)
    p, nw = words.shape
    gb = words.numel() * 4 / 1e9
    res = {"device": torch.cuda.get_device_name(g.device),
           "words_shape": [p, nw], "words_gb": gb, "stream_xor_ms": [],
           "decode_only_ms": [], "variants": {}}
    print(f"words ({p}, {nw}) = {gb:.2f} GB", flush=True)

    for name, fn in (("stream-xor", kernels.stream_xor),
                     ("decode-only", kernels.decode_only)):
        for _ in range(2):
            dt = timeit_seeded(fn, words)
            res[f"{name.replace('-', '_')}_ms"].append(dt * 1e3)
            print(f"{name:13s}: {dt * 1e3:7.2f} ms  {gb / dt:6.1f} GB/s",
                  flush=True)

    # correctness spot check against the quad-word score
    rng = np.random.default_rng(0)

    def rhs_of(m):
        return torch.from_numpy(rng.standard_normal((g.n_pad, m)).astype(
            np.float32)).to(g.device)

    rhs1 = rhs_of(2)
    a0 = kernels.xt_dots_words(words, rhs1, want_missing=False, p=g.p)[0]
    a1 = kernels.xt_i8_rounds(w3, rhs1)[:g.p]
    res["i8_rounds_rel_err"] = float((a1 - a0).abs().max()
                                     / a0.abs().max())
    # kernels 7 and 1 compute one exact digit-plane function: equal
    print(f"i8-rounds max rel err vs v0: {res['i8_rounds_rel_err']:.2e} "
          f"(equal: {bool(torch.equal(a1, a0))})", flush=True)

    def v0(w, r):
        return kernels.xt_dots_words(w, r, want_missing=False)[0]

    for m in ms:
        rhs = rhs_of(m)
        variants = [
            ("v0", v0, timeit, words),
            ("v0-roofl", v0, timeit_roofline_style, words),
            ("v1", kernels.xt_i8_rounds, timeit, w3),
            ("v1-roofl", kernels.xt_i8_rounds, timeit_roofline_style, w3),
            ("v1tp512", functools.partial(kernels.xt_i8_rounds, tp=512),
             timeit, w3),
            ("v1tp2048", functools.partial(kernels.xt_i8_rounds, tp=2048),
             timeit, w3),
        ]
        out = res["variants"][m] = {}
        for name, fn, tmr, arr in variants:
            try:
                d1 = tmr(fn, arr, rhs)
                d2 = tmr(fn, arr, rhs)
                out[name] = [d1 * 1e3, d2 * 1e3]
                print(f"m={m:4d} {name:9s} {d1 * 1e3:7.2f}/{d2 * 1e3:7.2f} ms "
                      f"{gb / min(d1, d2):6.1f} GB/s", flush=True)
            except Exception as e:  # noqa: BLE001  (the reference's verdict)
                out[name] = f"FAILED {type(e).__name__}: {str(e)[:200]}"
                print(f"m={m:4d} {name:9s} {out[name]}", flush=True)
    return res


if __name__ == "__main__":
    main()
