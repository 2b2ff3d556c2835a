"""The traced run's instruments: a named range around the program's score
entry, put on at run time from here (the program is not edited), and the
reading of a ``torch.profiler`` trace into what the per-layer metrics
take.  The idle gaps of the breakdown are named by the innermost host op
the profiler records (aten ops, the call's range); named ranges inside the
program's other layers are for the program's own spans.

``_union_us`` and the device-busy, launch and sync arithmetic of
``summarize`` are a frozen copy of ``mendeliht_tpu_torch/utils/
profiling.py::summarize`` (launches also count ``cuLaunchKernel``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import time

import torch

SCORE = "bench.score"          # the port's score entry, PackedOp._xt_dots
CALL = "bench.call"            # one call of the traffic, made by run.py
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
# host runtime calls that put work on the device
_ENQUEUES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cuMemcpy", "cuMemset")
NAME = 160                     # characters of an op's name kept


@contextlib.contextmanager
def score_range(widths: list):
    """A profiler range ``SCORE`` around the port's score entry,
    ``PackedOp._xt_dots(self, RT)``, while inside, with each call's (n, p,
    m) appended to ``widths``.  The original is put back after."""
    from mendeliht_tpu_torch.ops import linalg
    xt_dots = linalg.PackedOp._xt_dots

    @functools.wraps(xt_dots)
    def ranged(op, RT, *args, **kwargs):
        with torch.profiler.record_function(SCORE):
            widths.append((op.geno.n, op.geno.p, int(RT.shape[1])))
            return xt_dots(op, RT, *args, **kwargs)
    linalg.PackedOp._xt_dots = ranged
    try:
        yield
    finally:
        linalg.PackedOp._xt_dots = xt_dots


def profile(calls):
    """Run ``calls()`` under the profiler with the score's range on; returns
    (its result, the profiler's events, the host wall seconds from the
    start to a synchronize after it, the score widths seen)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    widths = []
    torch.cuda.synchronize()
    with score_range(widths), _profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = calls()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof.events(), wall, widths


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _merged(spans):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _on_card(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_device(e) -> bool:
    """A device op: a kernel, copy or fill on the card, not the device-side
    mark of a named range."""
    return (_on_card(e) and not e.name.startswith("bench.")
            and not getattr(e, "is_user_annotation", False))


def _score_device(events, device):
    """Device events of the score: those launched from inside a ``SCORE``
    range, linked by the launch's correlation id, or by the external id of
    a host op inside the range."""
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name == SCORE and not _on_card(e):
            ranges[e.thread].append((e.time_range.start, e.time_range.end))
    for r in ranges.values():
        r.sort()
    launch_ids, op_ids = set(), set()
    for e in events:
        if _on_card(e) or e.thread not in ranges:
            continue
        r, t = ranges[e.thread], e.time_range.start
        i = bisect.bisect_right(r, (t, float("inf"))) - 1
        if i >= 0 and r[i][0] <= t <= r[i][1] and e.id > 0:
            if e.name.startswith(_ENQUEUES):
                launch_ids.add(e.id)
            elif not e.name.startswith("cu"):
                op_ids.add(e.id)
    by_launch = {id(e) for e in device if e.id in launch_ids}
    by_op = {id(e) for e in device
             if getattr(e, "linked_correlation_id", 0) in op_ids}
    score = [e for e in device if id(e) in by_launch | by_op]
    unmatched = len(launch_ids - {e.id for e in device})
    return score, (len(by_launch), len(by_op), unmatched)


def _innermost(events, times):
    """For each time in ``times`` (sorted), the name of the innermost host
    range open at it (nested ranges of one thread), else None."""
    evs = sorted(((e.time_range.start, -e.time_range.end, e.name)
                  for e in events), key=lambda x: (x[0], x[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(evs) and evs[i][0] <= t:
            s, neg_end, name = evs[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        out.append(stack[-1][1] if stack else None)
    return out


def summarize(events, wall_s: float, widths, peak: dict,
              top: int = 10) -> dict:
    """What the metric readers take: device-busy and score seconds, the
    score's least seconds (``workcount``), launches and syncs, and the
    breakdown (device ops by total seconds; device idle seconds by the
    innermost host range open when each gap began)."""
    from . import workcount
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if not _on_card(e)]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy_us = _union_us(spans)
    by_name = collections.defaultdict(float)
    for e in device:
        by_name[e.name] += e.time_range.end - e.time_range.start
    score, links = _score_device(events, device)
    score_ops = collections.defaultdict(lambda: [0, 0.0])
    for e in score:
        score_ops[e.name[:60]][0] += 1
        score_ops[e.name[:60]][1] += (e.time_range.end - e.time_range.start) / 1e6
    launches = sum(e.name.startswith(_LAUNCHES) for e in host)
    syncs = sum(e.name in _SYNCS for e in host)

    calls = [e for e in host if e.name == CALL]
    main = calls[0].thread if calls else None
    lo = min((e.time_range.start for e in calls), default=0.0)
    hi = max((e.time_range.end for e in calls), default=0.0)
    gaps, prev = [], lo
    for s, e in _merged(spans):
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps = [(s, e) for s, e in gaps if e > s]
    labels = _innermost([e for e in host if e.thread == main
                         and not e.name.startswith(("cuda", "cu"))],
                        [s for s, _ in gaps])
    idle = collections.defaultdict(float)
    for (s, e), name in zip(gaps, labels):
        idle[name or "host, outside any range"] += e - s
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    waits = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "calls": len(calls),
        "wall_s": wall_s,
        "busy_s": busy_us / 1e6,
        "score_device_s": sum(e.time_range.end - e.time_range.start
                              for e in score) / 1e6,
        "score_kernels": len(score),
        # by launch, by host op, launches in the range with no device op
        "score_links": links,
        # the trace is whole where every enqueue has its device op
        "device_ops": len(device),
        "enqueues": sum(e.name.startswith(_ENQUEUES) for e in host),
        "score_ops": sorted(score_ops.items(), key=lambda kv: -kv[1][1])[:8],
        "score_calls": len(widths),
        "score_bound_s": sum(workcount.score_bound_s(n, p, m, peak)
                             for n, p, m in widths),
        "launches": launches,
        "syncs": syncs,
        "breakdown": {"device_ops": [[k[:NAME], v / 1e6] for k, v in heavy],
                      "idle_gaps": [[k[:NAME], v / 1e6] for k, v in waits]},
    }
