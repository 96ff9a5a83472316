"""Profiling and tracing helpers: the port's counterpart of
``timbre_trap_tpu/utils/profiling.py`` on ``torch.profiler`` (the reference
has none).

``trace(log_dir)`` records the host and, where a card is present, the
device (CUPTI) timeline and writes it as a Chrome trace
``log_dir/trace_<pid>_<ns>.json`` (Perfetto or ``chrome://tracing``);
``annotate(name)`` names a region on that timeline and, on the card, as an
NVTX range; ``Timer`` accumulates wall-clock time per section.
"""

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate", "Timer"]


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block and write its Chrome trace into ``log_dir``; yields
    the ``torch.profiler.profile`` (``key_averages()`` and the like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name):
    """Named region on the profiler's timeline (``record_function``) and,
    with a card present, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Timer:
    """Accumulating wall-clock timer: ``with timer('fwd'): ...``."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / self.counts[name], 3)}
                for name in self.totals}
