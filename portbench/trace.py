"""Reduce a ``torch.profiler`` (CUPTI) trace of the measured window to what
the per-layer metrics and the breakdown read.

The raw Kineto events are read directly (``kineto_results.events()``),
without building the profiler's Python event tree, so a window of a
million events reduces in seconds.

* device operations: every event on the CUDA device (kernels, copies,
  fills), clipped to the harness's ``window`` span;
* busy seconds: the union of their intervals; idle gaps: its complement;
* host launches: the CPU-side kernel and graph launch calls;
* the breakdown: device time summed by operation name, and idle time
  summed by what the host was doing then, named by the innermost harness
  span and the innermost host operation open at the gap's start.
"""

import bisect
import re

import torch

__all__ = ["reduce_trace", "SPANS"]

# The spans the harness records around its calls into the program.
SPANS = ("window", "request", "transcribe", "reconstruct", "peak_mask",
         "to_host", "upload", "step", "loss_read")
_LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchKernelEx|LaunchKernelExC|"
                     r"LaunchCooperativeKernel|GraphLaunch)(_v\d+)?$")
_NAME_CHARS = 160


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(starts, intervals, t):
    """The shortest interval of ``intervals`` (sorted by start, with
    ``starts`` their starts) open at time ``t``; None if none is."""
    best = None
    i = bisect.bisect_right(starts, t)
    # Host ops nest, so the open ones are among the last few started.
    for s, e, name in reversed(intervals[max(0, i - 64):i]):
        if e > t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def reduce_trace(prof):
    """A dict: ``window_s``, ``busy_s``, ``device_ops`` {name: seconds},
    ``device_s`` (their sum), ``launches``, ``idle_gaps`` {what: seconds}."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, host = [], [], []
    launches_at = []
    window = None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.is_user_annotation():
            # Kineto mirrors each span on the device's timeline too; only
            # the host's copy is a span, and neither is device work.
            if e.device_type() == cuda:
                continue
            if name == "window":
                window = (start, end)
            elif name in SPANS:
                spans.append((start, end, name))
        elif e.device_type() == cuda:
            device.append((start, end, name))
        elif _LAUNCH.match(name):
            launches_at.append(start)
            host.append((start, end, name))
        else:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace holds no 'window' span")
    w0, w1 = window
    ops, clipped = {}, []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        ops[name] = ops.get(name, 0) + (e - s)
    busy = _union(clipped)
    spans.sort()
    host.sort()
    span_starts = [s for s, _, _ in spans]
    host_starts = [s for s, _, _ in host]
    gaps = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = g0 + 1
        what = "/".join(x for x in (_innermost(span_starts, spans, mid),
                                    _innermost(host_starts, host, mid)) if x)
        gaps[what or "none"] = gaps.get(what or "none", 0) + (g1 - g0)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "device_ops": {k: v * 1e-9 for k, v in ops.items()},
        "device_s": sum(ops.values()) * 1e-9,
        "launches": sum(1 for t in launches_at if w0 <= t <= w1),
        "idle_gaps": {k: v * 1e-9 for k, v in gaps.items()},
    }


def top(table, n=10):
    """The ``n`` largest entries of {name: seconds} as [[name, seconds]],
    names shortened to a readable length."""
    items = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:_NAME_CHARS], v] for k, v in items]
