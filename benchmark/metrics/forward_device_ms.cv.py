"""forward_device_ms.cv (ms): device time a traced cv of the ops launched
inside ``iht.forward``: the k-sparse forward products of the step size,
each step and each backtrack.  Layer: solver.  Moves cv_s."""

from benchmark import spans


def read(t):
    return spans.per_call(
        t, "cv", "iht.forward",
        lambda s: 1e3 * s["device_s"].get("iht.forward", 0.0))
