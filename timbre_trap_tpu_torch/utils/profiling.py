"""Profiling and tracing: the port's spans, their record, and a Chrome-trace
exporter, on ``torch.profiler`` (the counterpart of
``timbre_trap_tpu/utils/profiling.py``, which the reference lacks).

``span(name, items=1)`` marks a region of the port; every name the port
uses starts with ``tt.``. With no profiler running it returns one shared
no-op context, behind a single C call. While a profiler runs (``trace``
below, or any ``torch.profiler.profile``) it records a Kineto CPU op of
that name, on the clock the device's events are converted to, and adds to
the span record: the count, the ``items`` (chunks, for a forward), the
total seconds and the self seconds (the total less the spans it encloses
on its own thread; the autograd engine's thread keeps its own stack).
``record()`` reads the record and ``reset_record()`` clears it, so a
profiled window holds exactly that window's spans.

``trace(log_dir)`` records the host and, where a card is present, the
device (CUPTI) timeline and writes it as a Chrome trace
``log_dir/trace_<pid>_<ns>.json`` (Perfetto or ``chrome://tracing``), the
port's spans in it; ``annotate`` is ``span``; ``Timer`` accumulates
wall-clock time per section.
"""

import contextlib
import os
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace", "span", "annotate", "record", "reset_record", "Timer"]

_enabled = torch.autograd._profiler_enabled


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


class Timer:
    """Accumulating wall-clock timer: ``with timer('fwd'): ...``."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def add(self, name, seconds):
        """Fold one timed section into ``name``."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def summary(self):
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / self.counts[name], 3)}
                for name in self.totals}


class _SpanRecord(Timer):
    """The span record: a ``Timer`` that also keeps each span's items and
    self time, added to from any thread."""

    def __init__(self):
        super().__init__()
        self.items = {}
        self.selfs = {}
        self._lock = threading.Lock()

    def add(self, name, seconds, items=1, self_s=None):
        with self._lock:
            super().add(name, seconds)
            self.items[name] = self.items.get(name, 0) + items
            self.selfs[name] = self.selfs.get(name, 0.0) + (
                seconds if self_s is None else self_s)

    def read(self):
        with self._lock:
            return {name: {"count": self.counts[name],
                           "items": self.items[name],
                           "total_s": self.totals[name],
                           "self_s": self.selfs[name]}
                    for name in self.totals}

    def clear(self):
        with self._lock:
            for table in (self.totals, self.counts, self.items, self.selfs):
                table.clear()


_RECORD = _SpanRecord()
_local = threading.local()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    """One span while a profiler runs: a Kineto CPU op, and its times
    added to the record on exit. The op also covers the span's own
    bookkeeping, so the trace names the host's time in it."""

    __slots__ = ("name", "items", "op", "start", "children")

    def __init__(self, name, items):
        self.name = name
        self.items = items

    def __enter__(self):
        self.op = _RecordFunctionFast(self.name)
        self.op.__enter__()
        self.children = 0.0
        _stack().append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter() - self.start
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].children += total
        _RECORD.add(self.name, total, self.items, total - self.children)
        self.op.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name, items=1):
    """A region of the port named ``name`` (``items``: the units of work in
    it, 1 unless the caller counts them): a no-op unless a profiler runs."""
    if not _enabled():
        return _OFF
    return _Span(name, items)


annotate = span


def record():
    """{name: {"count", "items", "total_s", "self_s"}} of every span closed
    while a profiler ran, since the last ``reset_record()``."""
    return _RECORD.read()


def reset_record():
    """Clear the span record."""
    _RECORD.clear()
