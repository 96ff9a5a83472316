"""The host's time a chunk group's CUDA graph replay in the traced window of
a reconstruct cell, in microseconds: the ``tt.graph.replay`` spans' total over
their count (the replay call, with the profiler's own events in it). None
where the program replays no graph."""

from portbench import spans


def read(ctx):
    replay = spans.get("tt.graph.replay")
    if not replay or not replay["count"]:
        return None
    return 1e6 * replay["total_s"] / replay["count"]
