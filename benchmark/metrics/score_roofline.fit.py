"""score_roofline.fit (%): as score_roofline.cv, over the traced fits.
Layer: kernels.  Moves fit_s."""


def read(t):
    if t["kind"] != "fit" or t["score_kernels"] == 0:
        return None
    return 100.0 * t["score_bound_s"] / t["score_device_s"]
