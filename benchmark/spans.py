"""The program's own spans in a traced run: the ``iht.*`` ranges that
``mendeliht_tpu_torch`` opens at its layer boundaries
(``utils/profiling.py::span``) while the profiler records, read from the
profiler's events (``t["events"]``) for the per-layer metrics.

- **Counts.** The spans on the calls' thread by name: ``iht.iteration`` the
  iterations, ``iht.backtrack`` the wasted steps, ``iht.sync`` the host
  reads that wait for the card (those inside ``iht.solve`` apart).
- **Device time by span.** Each device op is put down to the innermost
  ``iht.*`` span open at its launch, linked by the launch's correlation id
  or by the external id of the host op that launched it (as
  ``trace.py::_score_device`` links the score's).
- **Idle time by span.** The device idles inside the calls (``bench.call``)
  where no device op runs; that time is split by the spans open at each
  instant: inside ``iht.solve``, inside the call's entry span (``iht.fit`` /
  ``iht.cv``) but outside ``iht.solve``, and outside the entry span.  The
  three parts partition the calls' idle time.

A program without the spans gives no counts and no span time: the readers
then return None.
"""

from __future__ import annotations

import bisect
import collections

from benchmark.trace import (CALL, _ENQUEUES, _innermost, _is_device,
                             _merged, _on_card)

PREFIX = "iht."
ENTRY = {"fit": "iht.fit", "cv": "iht.cv"}

_last = None        # (events, read's dict) of the last trace read


def _length(iv) -> float:
    return sum(e - s for s, e in iv)


def _intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a, b):
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def read(t) -> dict:
    """What the spans of the traced run ``t`` (``trace.py::summarize``'s
    dict with the profiler's ``events``) give: ``calls``, ``count`` (spans
    by name), ``syncs_in_solve``, ``device_s`` (device seconds by the
    innermost span at launch, None outside every span), ``idle_s`` (the
    calls' idle seconds and its ``solve`` / ``entry`` / ``outside``
    parts).  The last trace read is kept: each metric reads the same
    one."""
    global _last
    events = t["events"]
    if _last is not None and _last[0] is events:
        return _last[1]
    host = [e for e in events if not _on_card(e)]
    calls = [e for e in host if e.name == CALL]
    main = calls[0].thread if calls else None
    marks = [e for e in host
             if e.thread == main and e.name.startswith(PREFIX)]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in marks)
    count = collections.Counter(name for _, _, name in spans)
    solve = _merged([(s, e) for s, e, n in spans if n == "iht.solve"])
    starts = [s for s, _ in solve]
    syncs_in_solve = 0
    for s, e, n in spans:
        i = bisect.bisect_right(starts, s) - 1
        if n == "iht.sync" and i >= 0 and e <= solve[i][1]:
            syncs_in_solve += 1

    # device ops by the innermost span open at their launch
    launches, ops = [], []
    for e in host:
        if e.thread == main and e.id > 0:
            if e.name.startswith(_ENQUEUES):
                launches.append((e.time_range.start, e.id))
            elif not e.name.startswith("cu"):
                ops.append((e.time_range.start, e.id))
    label = {}
    for kind, found in (("launch", launches), ("op", ops)):
        found.sort()
        at = _innermost(marks, [t for t, _ in found])
        label[kind] = {cid: name for (_, cid), name in zip(found, at)}
    device = [e for e in events if _is_device(e)]
    device_s = collections.defaultdict(float)
    for d in device:
        if d.id in label["launch"]:
            name = label["launch"][d.id]
        else:
            name = label["op"].get(getattr(d, "linked_correlation_id", 0))
        device_s[name] += (d.time_range.end - d.time_range.start) / 1e6

    # idle inside the calls, split by the spans open
    inside = _merged([(e.time_range.start, e.time_range.end)
                      for e in calls])
    busy = _merged([(e.time_range.start, e.time_range.end)
                    for e in device])
    idle = _subtract(inside, busy)
    top = _merged([(s, e) for s, e, n in spans if n in ENTRY.values()])
    out = {
        "calls": len(calls),
        "count": dict(count),
        "syncs_in_solve": syncs_in_solve,
        "device_s": dict(device_s),
        "idle_s": {
            "calls": (_length(inside) - _length(_intersect(inside, busy)))
            / 1e6,
            "solve": _length(_intersect(idle, solve)) / 1e6,
            "entry": _length(_intersect(idle, _subtract(top, solve))) / 1e6,
            "outside": _length(_subtract(idle, top)) / 1e6,
        },
    }
    _last = (events, out)
    return out


def per_call(t, kind: str, span: str, value):
    """``value`` of the spans of the traced run ``t`` over its calls, for a
    run of ``kind`` in which the program opened ``span``; else None (another
    kind of call, or a program without the span)."""
    if t["kind"] != kind:
        return None
    s = read(t)
    if not s["count"].get(span) or not s["calls"]:
        return None
    return value(s) / s["calls"]
