"""solver_device_ms.cv (ms): the device-busy time of a cv less its score's
device time: the solver's (B, p) state updates, top-k, forward products
and GLM.  Layer: solver.  Moves cv_s."""


def read(t):
    if t["kind"] != "cv" or t["score_kernels"] == 0 or t["calls"] == 0:
        return None
    return 1e3 * (t["busy_s"] - t["score_device_s"]) / t["calls"]
