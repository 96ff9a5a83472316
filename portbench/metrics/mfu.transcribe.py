"""The whole model's share of the bfloat16 peak: the published architecture's
operations over the traced window (``work/convs.py``), over the window's
length times the peak."""


def read(ctx):
    ops = ctx["work"]["model_ops"]
    return 100.0 * ops / (ctx["trace"]["window_s"] * ctx["peaks"]["bf16_flops"])
