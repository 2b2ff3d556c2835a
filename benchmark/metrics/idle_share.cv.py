"""idle_share.cv (share): 1 - the device-busy union over the profiled
wall time of the traced cvs.  Layer: device.  Moves cv_s."""


def read(t):
    if t["kind"] != "cv" or t["wall_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["wall_s"]
