"""The host's time rebuilding what the step could keep, in milliseconds a
step: the ``tt.spec_build`` spans (the level specs and their adjoints)
and the ``tt.prepare`` spans (cache misses of the kernels' operands and
plans), their totals over the window's steps."""

from portbench import spans


def read(ctx):
    rec = spans.record()
    if not rec or "tt.step.update" not in rec:
        return None
    rebuilt = sum(rec[name]["total_s"] for name in ("tt.spec_build",
                                                    "tt.prepare")
                  if name in rec)
    return 1e3 * rebuilt / ctx["work"]["steps"]
