"""The device's idle share of the traced window, in a transcribe cell: 100 x
(1 - the union of device operations' intervals / the window)."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
