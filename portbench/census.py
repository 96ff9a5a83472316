"""A census of one traced window of a cell, for the breakdown in PERF.md:
the kernels of each group of ``kernels/`` the device ran in it, the
port's span record, and every idle gap by what the host was doing then
(the result's breakdown keeps the ten largest).

    python3 -m portbench.census --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``python3 -m portbench.run ... --trace 1`` does and
prints one JSON line: the result's metrics, ``correct`` and ``device``,
``kernels`` {group: kernels that started in the window}, ``spans`` (the
record, or None where the program keeps none), ``idle_gaps`` {what:
seconds}, every one, and the idle time named by a harness span alone,
by the host op that closed last before each gap (``unnamed_after``) and
by the innermost port span open then (``unnamed_in``).
Exits non-zero without a CUDA device.
"""

import argparse
import bisect
import json
import sys

import torch

from . import spans, spec, trace


def kernel_counts(prof, groups):
    """{group: device kernels matching the group's patterns that started
    inside the harness's ``window`` span}."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    w0, w1 = next((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.is_user_annotation()
                  and e.device_type() != cuda and e.name() == "window")
    counts = dict.fromkeys(groups, 0)
    for e in events:
        if (e.device_type() != cuda or e.is_user_annotation()
                or not w0 <= e.start_ns() < w1):
            continue
        for group, patterns in groups.items():
            if any(p.search(e.name()) for p in patterns):
                counts[group] += 1
    return counts


def unnamed_gaps(prof):
    """Idle time that the breakdown names by a harness span alone (no host
    op open among the last ones started), two ways: by the host op that
    closed last before each such gap, and by the innermost port span
    (``tt.*``) open at its start however long ago it opened. Returns
    ({op: seconds}, {span: seconds})."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.is_user_annotation():
            if e.device_type() != cuda and iv[2] == "window":
                window = iv
        elif e.device_type() == cuda:
            device.append(iv[:2])
        else:
            host.append(iv)
    w0, w1 = window[:2]
    busy = trace._union([(max(s, w0), min(e, w1)) for s, e in device
                         if min(e, w1) > max(s, w0)])
    host.sort()
    starts = [s for s, _, _ in host]
    by_end = sorted((e, name) for _, e, name in host)
    ends = [e for e, _ in by_end]
    port = [iv for iv in host if iv[2].startswith("tt.")]
    after, inside = {}, {}
    open_spans, k = [], 0
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        mid = g0 + 1
        if g1 <= g0:
            continue
        # The port spans open at ``mid``: they nest, so a stack sweep.
        while k < len(port) and port[k][0] <= mid:
            while open_spans and open_spans[-1][1] <= port[k][0]:
                open_spans.pop()
            open_spans.append(port[k])
            k += 1
        while open_spans and open_spans[-1][1] <= mid:
            open_spans.pop()
        if trace._innermost(starts, host, mid) is not None:
            continue
        j = bisect.bisect_right(ends, mid) - 1
        before = by_end[j][1] if j >= 0 else "none"
        span = open_spans[-1][2] if open_spans else "none"
        after[before] = after.get(before, 0.0) + (g1 - g0) * 1e-9
        inside[span] = inside.get(span, 0.0) + (g1 - g0) * 1e-9
    return after, inside


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("census: no CUDA device", file=sys.stderr)
        return 2

    from . import bench, program

    seen = {}
    reduce_trace = trace.reduce_trace

    def reduce_and_count(prof):
        reduced = reduce_trace(prof)
        seen["kernels"] = kernel_counts(prof, spec.kernel_groups(cell.root))
        seen["idle_gaps"] = reduced["idle_gaps"]
        seen["unnamed_after"], seen["unnamed_in"] = unnamed_gaps(prof)
        return reduced

    trace.reduce_trace = reduce_and_count
    try:
        result = bench.run(cell, args.seed, args.seconds, True,
                           torch.device("cuda", 0), program)
    finally:
        trace.reduce_trace = reduce_trace
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"],
                      "attempted": result["attempted"],
                      "device": result["device"],
                      "metrics": result["metrics"],
                      "kernels": seen["kernels"], "spans": spans.record(),
                      "idle_gaps": seen["idle_gaps"],
                      "unnamed_after": seen["unnamed_after"],
                      "unnamed_in": seen["unnamed_in"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
