"""replay_share.fit (share): the share of the traced fits' ``iht.iteration``
spans that hold an ``iht.replay`` span and no ``iht.capture`` span, the
iterations replayed from CUDA graphs captured before them
(``mendeliht_tpu_torch/models/replay.py``).  Spans on the calls' thread,
as ``spans.py`` reads them.  None for a cv, and for a program that opens
no ``iht.replay`` span.  Layer: solver host loop.  Moves fit_s."""

import bisect

from benchmark import spans
from benchmark.trace import CALL, _on_card


def _ranges(host, thread, name):
    return sorted((e.time_range.start, e.time_range.end) for e in host
                  if e.thread == thread and e.name == name)


def _holds(outer, inner) -> bool:
    """Whether a range of ``inner`` (sorted) starts inside ``outer``."""
    s, e = outer
    i = bisect.bisect_left(inner, (s, float("-inf")))
    return i < len(inner) and inner[i][0] <= e


def read(t):
    if t["kind"] != "fit":
        return None
    count = spans.read(t)["count"]
    if not count.get("iht.replay") or not count.get("iht.iteration"):
        return None
    host = [e for e in t["events"] if not _on_card(e)]
    main = next(e.thread for e in host if e.name == CALL)
    iterations, replays, captures = (
        _ranges(host, main, spans.PREFIX + name)
        for name in ("iteration", "replay", "capture"))
    replayed = sum(_holds(it, replays) and not _holds(it, captures)
                   for it in iterations)
    return replayed / len(iterations)
