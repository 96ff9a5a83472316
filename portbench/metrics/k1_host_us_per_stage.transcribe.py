"""K1's host time a stage in the traced window, in microseconds: the
``tt.k1`` spans' total over their count (the wrapper's checks, the
operand and plan lookups and the launch call, with the profiler's own
events in them)."""

from portbench import spans


def read(ctx):
    k1 = spans.get("tt.k1")
    if not k1 or not k1["count"]:
        return None
    return 1e6 * k1["total_s"] / k1["count"]
