"""The host's time in the step's update a step, in milliseconds: the
``tt.step.update`` spans' total over their count (the gradient
telemetry, the optimizer's loop over the leaves, the cache drop)."""

from portbench import spans


def read(ctx):
    update = spans.get("tt.step.update")
    if not update or not update["count"]:
        return None
    return 1e3 * update["total_s"] / update["count"]
