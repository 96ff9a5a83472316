"""The share of device time outside K1 and K2 in a transcription cell:
the analysis, the overlap-add, the skip route's bridge and adds, copies."""


def read(ctx):
    t = ctx["trace"]
    if t["device_s"] <= 0:
        return None
    kernels = ctx["groups"].get("k1", 0.0) + ctx["groups"].get("k2", 0.0)
    return 100.0 * (t["device_s"] - kernels) / t["device_s"]
