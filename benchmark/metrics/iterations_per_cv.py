"""iterations_per_cv (iterations): the ``iht.iteration`` spans a traced cv:
the host loop steps every (fold, k) task together until the slowest one
converges.  Layer: solver host loop.  Moves cv_s."""

from benchmark import spans


def read(t):
    return spans.per_call(t, "cv", "iht.iteration",
                          lambda s: s["count"]["iht.iteration"])
