"""solver_idle_ms.fit (ms): device idle time a traced fit that falls inside
``iht.solve``, the host-stepped loop (``spans.py``: idle inside the calls,
split by the spans open).  Layer: solver host loop.  Moves fit_s."""

from benchmark import spans


def read(t):
    return spans.per_call(t, "fit", "iht.solve",
                          lambda s: 1e3 * s["idle_s"]["solve"])
