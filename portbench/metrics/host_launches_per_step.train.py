"""The host's kernel and graph launch calls in the traced window, per
training step."""


def read(ctx):
    return ctx["trace"]["launches"] / ctx["work"]["steps"]
