"""The share of the traced window's chunk groups (``tt.forward`` spans) in a
transcribe cell that no graph captured before them served, in percent: those
that captured their graph (``tt.graph.capture``) or replayed none. 0 once
the warm-up has captured every shape. None where the program replays no
graph."""

from portbench import spans


def read(ctx):
    forward = spans.get("tt.forward")
    replay = spans.get("tt.graph.replay")
    if not forward or not forward["count"] or not replay:
        return None
    capture = spans.get("tt.graph.capture")
    served = replay["count"] - (capture["count"] if capture else 0)
    return 100.0 * (forward["count"] - served) / forward["count"]
