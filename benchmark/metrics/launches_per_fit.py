"""launches_per_fit (launches): host kernel launches a fit, from the
profiler.  Layer: solver host loop.  Moves fit_s."""


def read(t):
    if t["kind"] != "fit" or t["calls"] == 0:
        return None
    return t["launches"] / t["calls"]
