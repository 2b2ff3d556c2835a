"""topk_device_ms.cv (ms): device time a traced cv of the ops launched
inside ``iht.project``: the solver's top-k projections over ``[b; c]``,
with the magnitudes, the concatenation and the scatters into the (B, p)
state.  Layer: solver.  Moves cv_s."""

from benchmark import spans


def read(t):
    return spans.per_call(
        t, "cv", "iht.project",
        lambda s: 1e3 * s["device_s"].get("iht.project", 0.0))
