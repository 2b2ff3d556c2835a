"""score_roofline.cv (%): the score's least time (``workcount``: 2 n p m
operations at 1,979 T/s or its bytes at 3.35 TB/s, the larger) over its
device time, summed over the traced cvs.  Layer: kernels.  Moves cv_s."""


def read(t):
    if t["kind"] != "cv" or t["score_kernels"] == 0:
        return None
    return 100.0 * t["score_bound_s"] / t["score_device_s"]
