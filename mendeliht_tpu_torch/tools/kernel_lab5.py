"""Kernel lab round 5 on a CUDA card: the score kernels across RHS widths
and the narrow-integer probes of the tensor cores (the JAX package's
``tools/kernel_lab5.py``).

- :func:`probe_int4` — does each narrow-integer kernel run: the int4 unpack,
  int4 x int8 and int8 x int4 dots, and int4 x int4 (whose operands do not
  match, in the reference too: its verdict is dot_general's shape error);
- :func:`bench_int4_ingestion` — us per call of the same (8192, 2048) x
  (2048, 8) dot with the big operand packed as int8 or as int4;
- :func:`xt_dots_T` — the int8 digit-plane score over the transposed words
  (kernel 2's A, ``csrc/xt_dots_t.cu``), swept beside the quad-word score
  at widths 1..128 (the JAX lab's quad production kernel and transposed
  prototype);
- :func:`attrib` — the transposed-layout score at m = 100, 66, 33 and the
  read-only pass, to split the m = 100 time into MMA and read time.

    python -m mendeliht_tpu_torch.tools.kernel_lab5 [--quick | --attrib]

writes ``kernel_lab5_results.json`` in the working directory (``--attrib``
merges its key into that file).  Every entry point takes a ``device``
(default ``cuda:0``); timings need a CUDA device and raise elsewhere.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..genotype.snparray import PackedGenotypes
from ..ops import kernels
from ..ops.kernels import xt_dots_T  # noqa: F401  (the JAX lab's name)
from ..utils import profiling
from ..utils.simulate import simulate_packed_problem

N, P, SEED = 10_000, 1_000_000, 2026     # the JAX lab's problem (bench.py)
WIDTHS = (1, 2, 4, 8, 16, 32, 64, 100, 128)
QUICK_WIDTHS = (1, 8, 100)
RESULTS = "kernel_lab5_results.json"
INGEST_SHAPE, INGEST_REPS = (8192, 2048, 8), 200


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: the lab measures a "
                           "card (pass device='cpu' for the plain versions)")
    return dev


def time_kernel(fn, arr, n_pad: int, m: int, iters: int = 25) -> float:
    """Device seconds per call of ``fn(arr, rhs) -> (p, m)``, each call's
    rhs carried from the previous result so no call can be skipped."""
    def step(r):
        a = fn(arr, r)
        return r * (1.0 + a[1, 0] * 1e-12) + a[0, 0] * 1e-6

    rhs0 = torch.ones((n_pad, m), dtype=torch.float32, device=arr.device)
    return profiling._seconds_per_call(step, rhs0, iters, arr.device)


def sweep(name: str, fn, arr, n_pad: int, widths=WIDTHS, iters=lambda m: 25):
    """{m: ms per call} of :func:`time_kernel` at each width, printed."""
    out = {}
    for m in widths:
        out[m] = time_kernel(fn, arr, n_pad, m, iters(m)) * 1e3
        print(f"{name:<16} m={m:3d}: {out[m]:7.3f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# narrow-integer probes
# ---------------------------------------------------------------------------

def probe_int4(device="cuda:0") -> dict:
    """Does each narrow-integer kernel run on ``device``: "ok", or "FAIL:
    <type>: <message>" as the JAX lab records it.  Inputs are
    ``arange % 3`` int32 tiles of the JAX lab's shapes."""
    dev = _device(device)
    out = {}

    def try_one(name, call, in_shapes):
        try:
            args = [torch.arange(int(np.prod(s)), dtype=torch.int32,
                                 device=dev).reshape(s) % 3
                    for s in in_shapes]
            call(*args).cpu()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001  (the verdict is the result)
            out[name] = f"FAIL: {type(e).__name__}: {str(e)[:200]}"

    try_one("bitcast_i32_to_i4", lambda x: kernels.unpack_words(x, 4),
            [(32, 256)])
    try_one("dot_i4_i8", lambda x, y: kernels.int_dot_packed(x, y, 4),
            [(32, 256), (256, 128)])
    try_one("dot_i4_i4_256x256_256x128",
            lambda x, y: kernels.int_dot_packed(
                x, kernels.unpack_words(y, 4), 4),
            [(32, 256), (16, 128)])
    try_one("dot_i8_lhs_i4_rhs",
            lambda x, y: kernels.int_dot_packed(y, x, 4, lhs_packed=False),
            [(8, 256), (32, 512)])
    return out


def ingestion_operands(bits: int, device):
    """The lab's ingestion dot: all-ones words (M*bits/32, K) int32 and an
    all-ones (K, N) int8; the product is K on rows 0 mod 32/bits, else 0."""
    M, K, N = INGEST_SHAPE
    x = torch.ones((M * bits // 32, K), dtype=torch.int32, device=device)
    return x, torch.ones((K, N), dtype=torch.int8, device=device)


def bench_int4_ingestion(device="cuda:0") -> dict:
    """{"i8_us", "i4_us"}: device us per call of the ingestion dot with the
    big operand packed as int8 or int4, over INGEST_REPS carry-dependent
    calls (each call's rhs is ``y + c`` with c carried from its result)."""
    dev = _device(device)
    res = {}
    for bits, key in ((8, "i8_us"), (4, "i4_us")):
        x, y = ingestion_operands(bits, dev)

        def step(c, x=x, y=y, bits=bits):
            o = kernels.int_dot_packed(x, y + c.to(torch.int8), bits)
            return c + o[0, 0] * 0

        c0 = torch.zeros((), dtype=torch.int32, device=dev)
        res[key] = profiling._seconds_per_call(step, c0, INGEST_REPS,
                                               dev) * 1e6
    return res


# ---------------------------------------------------------------------------
# attribution and the sweep's problem
# ---------------------------------------------------------------------------

def attrib(g) -> dict:
    """The transposed-layout score (kernel 2, A only) at m = 100, 66, 33 --
    the digit-row counts 300, 200, 100 of the JAX lab -- and the read-only
    pass (the read probe's ceiling over the words), in ms."""
    g = g.with_dual_layout()
    out = {}
    for planes in (3, 2, 1):
        def f(a, r):
            return kernels.xt_dots_words_t(a, r, want_missing=False, p=g.p)[0]
        dt = time_kernel(f, g.words_t, g.n_pad, 100 * planes // 3)
        out[f"digit_rows_{planes * 100}"] = dt * 1e3
        print(f"vt m-equiv {planes}/3 digit rows: {dt * 1e3:7.2f} ms",
              flush=True)
    bw = profiling.stream_bandwidth_kernel(g)
    out["reader_only_ms"] = g.words.numel() * 4 / bw * 1e3
    print(f"decode-free reader pass:  {out['reader_only_ms']:7.2f} ms",
          flush=True)
    return out


def load_problem(device="cuda:0") -> PackedGenotypes:
    """The JAX lab's 10k x 1M genotypes (``bench.load_problem``'s bytes)."""
    words, mu, inv_sd, hm, _, _ = simulate_packed_problem(
        np.random.default_rng(SEED), N, P)
    return PackedGenotypes.from_numpy(words, mu, inv_sd, n=N, p=P,
                                      has_missing=hm, device=device)


def _write(results: dict, merge: bool):
    prev = {}
    if merge and os.path.exists(RESULTS):
        with open(RESULTS) as f:
            prev = json.load(f)
    prev.update(results)
    with open(RESULTS, "w") as f:
        json.dump(prev, f, indent=2)
    print("wrote", os.path.abspath(RESULTS), flush=True)


def main(argv=None, g=None, device="cuda:0") -> dict:
    """The lab: with ``--attrib`` only :func:`attrib`, else the probes, the
    ingestion rates and the width sweep (``--quick``: m = 1, 8, 100) of the
    quad-word score and the int8 transposed score.  ``g`` are the genotypes
    to use (default: :func:`load_problem` on ``device``).  Returns the
    results it writes."""
    argv = sys.argv[1:] if argv is None else argv
    dev = _device(device)
    results = {"device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else str(dev))}

    if "--attrib" in argv:
        g = load_problem(dev) if g is None else g
        results["attrib_m100"] = attrib(g)
        _write(results, merge=True)
        return results

    print("== int4 probes ==", flush=True)
    results["int4_probe"] = probe_int4(dev)
    for k, v in results["int4_probe"].items():
        print(f"  {k}: {v}", flush=True)
    results["int4_ingestion"] = bench_int4_ingestion(dev)
    print(f"  ingestion: {results['int4_ingestion']}", flush=True)

    g = load_problem(dev) if g is None else g
    print(g, flush=True)
    widths = QUICK_WIDTHS if "--quick" in argv else WIDTHS

    def quad(a, r):
        return kernels.xt_dots_words(a, r, want_missing=False)[0]

    results["quad_ms"] = sweep("quad production", quad, g.words, g.n_pad,
                               widths)
    results["vt_ms"] = sweep("vt transposed", kernels.xt_dots_T,
                             g.with_dual_layout().words_t, g.n_pad, widths)
    _write(results, merge=False)
    return results


if __name__ == "__main__":
    main()
