"""K3's share of its roofline, bfloat16 backward (dX, dW, the ELU' seed): the least time the
architecture's work on its convs needs (the larger of operations over the
peak rate and bytes over the HBM rate, ``work/convs.py``) over the device
time of the kernels of ``kernels/k3/`` in the traced window."""


def read(ctx):
    seconds = ctx["groups"].get("k3", 0.0)
    if seconds <= 0:
        return None
    w, p = ctx["work"], ctx["peaks"]
    least = max(w["k3_ops"] / p["bf16_flops"], w["k3_bytes"] / p["hbm_bytes"])
    return 100.0 * least / seconds
