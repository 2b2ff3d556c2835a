"""Read ceiling and roofline of the score kernels on a CUDA card (the JAX
package's ``utils/profiling.py``).

- :func:`stream_bandwidth_kernel` — the card's measured read ceiling: the
  read-bandwidth probe kernel (``csrc/read_probe.cu``) over the packed words.
- :func:`stream_bandwidth` — the same read through plain PyTorch ops.
- :func:`kernel_roofline` — ms per X'R pass of a score kernel, its packed
  bytes per second, and its share of the data sheet and of the measured
  ceiling.
- :func:`trace` — where a call's time goes on the card: wall time, device
  busy time and idle share, launches and host syncs, the heaviest kernels.

Each measures a CUDA device with CUDA events or the profiler and raises
where there is none: a CPU run gives no device number.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

from ..ops import kernels

# data-sheet device-memory bandwidth (bytes/s) by torch.cuda.get_device_name
_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_hbm_bandwidth(device=None) -> float:
    """Data-sheet device-memory bandwidth (bytes/s) of the card; raises for
    a card the table does not hold rather than guess."""
    name = torch.cuda.get_device_name(device)
    if name not in _HBM_BYTES_PER_S:
        raise ValueError(f"no data-sheet bandwidth for {name!r}: add it to "
                         "_HBM_BYTES_PER_S")
    return _HBM_BYTES_PER_S[name]


def _seconds_per_call(step, state, iters: int, device):
    """Mean device seconds of ``state = step(state)`` over ``iters`` calls,
    after one warm call, timed with CUDA events on ``device``."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"profiling measures a CUDA device; the genotypes "
                           f"lie on {device}")
    state = step(state)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for _ in range(iters):
            state = step(state)
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def stream_bandwidth_kernel(geno, iters: int = 50) -> float:
    """Measured read bandwidth (bytes/s) of the card: the read-bandwidth
    probe kernel sums every packed word once per pass, its result carried
    into the next pass.  The counterpart of the JAX package's
    ``stream_bandwidth_pallas``; at 10k x 1M the 2.56 GB of words are far
    past the L2, so every pass reads device memory."""
    words = geno.words
    c0 = torch.zeros(1, dtype=torch.int32, device=words.device)
    dt = _seconds_per_call(lambda c: kernels.read_words(words, c), c0, iters,
                           words.device)
    return words.numel() * 4 / dt


def stream_bandwidth(geno, iters: int = 50) -> float:
    """Read bandwidth (bytes/s) of plain PyTorch: a carry-dependent
    ``sum(words ^ c)`` per pass, as the JAX package's ``stream_bandwidth``,
    over the packed bytes.  Eager PyTorch writes ``words ^ c`` out before
    summing it, so a pass moves three times the words' bytes: this is the
    plain version's rate, not the card's read ceiling."""
    words = geno.words
    c0 = torch.zeros((), dtype=torch.int32, device=words.device)

    def step(c):
        return c + torch.sum(words ^ c, dtype=torch.int32)

    return words.numel() * 4 / _seconds_per_call(step, c0, iters,
                                                 words.device)


def kernel_roofline(geno, m: int = 1, iters: int = 10, want_missing=None,
                    measured_roof: float | None = None,
                    layout: str = "quad"):
    """Achieved bandwidth of the X'R pass on ``geno`` (PackedGenotypes) at
    RHS width ``m``, through the quad-word kernel (``layout="quad"``) or the
    transposed-layout kernel (``"vt"``, which needs ``words_t``).

    Returns a dict with ms per pass, packed GB/s, and the fraction of the
    data-sheet bandwidth and, given ``measured_roof`` (bytes/s, e.g. from
    :func:`stream_bandwidth_kernel`), of the measured read ceiling."""
    if want_missing is None:
        want_missing = geno.has_missing
    if layout == "vt":
        if geno.words_t is None:
            raise ValueError("layout='vt' needs the dual layout: call "
                             "geno.with_dual_layout() first")
        arr, score = geno.words_t, kernels.xt_dots_words_t
    elif layout == "quad":
        arr, score = geno.words, kernels.xt_dots_words
    else:
        raise ValueError(f"layout must be 'quad' or 'vt', got {layout!r}")
    rhs = torch.ones((geno.n_pad, m), dtype=torch.float32, device=arr.device)

    def step(_):
        return score(arr, rhs, want_missing=want_missing, p=geno.p)

    dt = _seconds_per_call(step, None, iters, arr.device)
    bw = geno.words.numel() * 4 / dt
    out = {
        "ms_per_pass": dt * 1e3,
        "packed_gbytes_per_s": bw / 1e9,
        "hbm_roofline_fraction": bw / device_hbm_bandwidth(arr.device),
        "rhs_columns": m,
        "want_missing": want_missing,
        "backend": "cuda",
        "layout": layout,
    }
    if measured_roof:
        out["measured_stream_gbytes_per_s"] = measured_roof / 1e9
        out["measured_roofline_fraction"] = bw / measured_roof
    return out


@contextlib.contextmanager
def trace(logdir: str | None = None, top: int = 8):
    """Profile the body on the CUDA card with ``torch.profiler`` (host and
    device activity): the counterpart of the JAX package's ``trace``.

    Yields a dict that is filled when the body ends with :func:`summarize`
    of the events and the host wall time from the body's start to a device
    synchronize after it (that synchronize is one of the ``syncs``).  With
    ``logdir`` the Chrome trace is written there as ``trace.json``."""
    if not torch.cuda.is_available():
        raise RuntimeError("trace measures a CUDA device; none is available")
    from torch.profiler import ProfilerActivity, profile

    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.update(summarize(prof.events(), wall, top=top))
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize(events, wall_s: float, top: int = 8) -> dict:
    """Where the time went, from profiler events (``FunctionEvent``s with
    ``name``, ``device_type`` and ``time_range`` in microseconds):

    - ``wall_ms``: host wall time around the profiled call;
    - ``device_busy_ms``: the union of device activity (kernels, copies,
      fills), so concurrent work counts once; ``idle_share`` the rest of
      the wall time;
    - ``device_ops``: device activities, ``launches``: host
      ``cudaLaunchKernel`` calls and their host ms, ``syncs``: host stream
      or device synchronizations and the ms they waited;
    - ``kernels``: the ``top`` device activities by total ms, each
      ``(name, ms, count)``."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    launches, launch_us, syncs, sync_us = 0, 0.0, 0, 0.0
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            spans.append((s, t))
            by_name[e.name][0] += t - s
            by_name[e.name][1] += 1
        elif e.name.startswith("cudaLaunchKernel"):
            launches, launch_us = launches + 1, launch_us + t - s
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"):
            syncs, sync_us = syncs + 1, sync_us + t - s
    busy_ms = _union_us(spans) / 1e3
    wall_ms = wall_s * 1e3
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else float("nan"),
        "device_ops": len(spans),
        "launches": launches,
        "launch_host_ms": launch_us / 1e3,
        "syncs": syncs,
        "sync_wait_ms": sync_us / 1e3,
        "kernels": [(name, us / 1e3, cnt) for name, (us, cnt) in heavy],
    }
