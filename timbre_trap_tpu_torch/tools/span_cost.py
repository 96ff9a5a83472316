"""What a span of ``utils/profiling.py`` costs the host, off and on.

    python -m timbre_trap_tpu_torch.tools.span_cost [--spans N]

Off (no profiler running): ``N`` (default 10**6) ``with span("tt.k1"):
pass`` in a loop, against the same loop with no span, best of 5 runs;
the difference over ``N`` is the gated span's cost. On (under a CPU and
CUDA ``torch.profiler``): ``N // 10`` spans, best of 3, the same way:
the Kineto op and the record's update. Prints one JSON line with the
card's name and power limit and the interpreter's and PyTorch's versions.
Times the card's host, so it needs a CUDA device; exits non-zero without
one.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from ..utils.profiling import reset_record, span


def _loop_s(n, spanned):
    t0 = time.perf_counter()
    if spanned:
        for _ in range(n):
            with span("tt.k1"):
                pass
    else:
        for _ in range(n):
            pass
    return time.perf_counter() - t0


def _per_span_us(n, repeats):
    """(best loop with spans, best loop without, their difference per
    span), in microseconds a span."""
    with_s = min(_loop_s(n, True) for _ in range(repeats))
    bare_s = min(_loop_s(n, False) for _ in range(repeats))
    return {"loop_us": 1e6 * with_s / n, "bare_us": 1e6 * bare_s / n,
            "span_us": 1e6 * (with_s - bare_s) / n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=10 ** 6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.init()
    off = _per_span_us(args.spans, 5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = _per_span_us(args.spans // 10, 3)
    reset_record()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "python": sys.version.split()[0],
                      "torch": torch.__version__, "spans": args.spans,
                      "off": off, "on": on}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
