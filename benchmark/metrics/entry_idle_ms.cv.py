"""entry_idle_ms.cv (ms): device idle time a traced cv inside ``iht.cv``
and outside ``iht.solve``: the entry's host prep (``iht.build``, the fold
masks ``iht.masks``), the initial state, finalize and the fetch.  Layer:
entry.  Moves cv_s."""

from benchmark import spans


def read(t):
    return spans.per_call(t, "cv", "iht.cv",
                          lambda s: 1e3 * s["idle_s"]["entry"])
