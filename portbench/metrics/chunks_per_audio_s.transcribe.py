"""Chunks the forwards ran a second of audio transcribed: the ``tt.forward``
spans' items over the window's audio seconds. The audio needs 2 a block
and 1 a request; a streamed clip's last piece, padded to whole pieces,
runs more."""

from portbench import spans


def read(ctx):
    forward = spans.get("tt.forward")
    if not forward:
        return None
    return forward["items"] / ctx["work"]["audio_s"]
