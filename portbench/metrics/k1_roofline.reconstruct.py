"""K1's share of its roofline, float32 stage (TF32 peak): the least time the
architecture's work on its convs needs (the larger of operations over the
peak rate and bytes over the HBM rate, ``work/convs.py``) over the device
time of the kernels of ``kernels/k1/`` in the traced window."""


def read(ctx):
    seconds = ctx["groups"].get("k1", 0.0)
    if seconds <= 0:
        return None
    w, p = ctx["work"], ctx["peaks"]
    least = max(w["k1_ops"] / p["tf32_flops"], w["k1_bytes"] / p["hbm_bytes"])
    return 100.0 * least / seconds
