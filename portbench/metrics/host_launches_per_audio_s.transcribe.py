"""The host's kernel and graph launch calls in the traced window, per
second of audio transcribed."""


def read(ctx):
    return ctx["trace"]["launches"] / ctx["work"]["audio_s"]
