"""entry_idle_ms.fit (ms): device idle time a traced fit inside ``iht.fit``
and outside ``iht.solve``: the entry's host prep (``iht.build``), the
initial state, finalize and the result's fetch.  Layer: entry.  Moves
fit_s."""

from benchmark import spans


def read(t):
    return spans.per_call(t, "fit", "iht.fit",
                          lambda s: 1e3 * s["idle_s"]["entry"])
