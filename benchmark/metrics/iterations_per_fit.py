"""iterations_per_fit (iterations): the ``iht.iteration`` spans a traced
fit, the solver's host-stepped iterations.  Layer: solver host loop.
Moves fit_s."""

from benchmark import spans


def read(t):
    return spans.per_call(t, "fit", "iht.iteration",
                          lambda s: s["count"]["iht.iteration"])
