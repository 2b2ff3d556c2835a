"""idle_share.fit (share): 1 - the device-busy union over the profiled
wall time of the traced fits.  Layer: device.  Moves fit_s."""


def read(t):
    if t["kind"] != "fit" or t["wall_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["wall_s"]
