"""syncs_per_iteration.fit (syncs): the ``iht.sync`` spans inside
``iht.solve`` (host reads that wait for the card: the loop's
``active.any()`` and each backtrack check's ``need.any()``) over the
``iht.iteration`` spans of the traced fits.  Layer: solver host loop.
Moves fit_s."""

from benchmark import spans


def read(t):
    if t["kind"] != "fit":
        return None
    s = spans.read(t)
    iterations = s["count"].get("iht.iteration")
    return s["syncs_in_solve"] / iterations if iterations else None
