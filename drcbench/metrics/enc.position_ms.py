"""The mean a request of the program's ``timings["position_s"]``, in ms: the position path: quantize, upload, K1, K2, the rANS coder and its readback (BatchEncoder)."""


def value(run):
    return run.mean_timing_ms("position_s")
