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
port's spans in it; ``kernel_counts()`` counts the device kernels a block
ran, by name (``kernel_name``, or with the template arguments that tell a
kernel's instances apart, ``kernel_instance``), from the same device
records; ``annotate`` is ``span``;
``Timer`` accumulates wall-clock time per section.
"""

import collections
import contextlib
import os
import re
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace", "kernel_counts", "kernel_name", "kernel_instance",
           "span", "annotate", "record", "reset_record", "Timer"]

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


# The first name in a demangled signature that a template argument list or
# a parameter list follows (or that ends it): the function's own.
_BASE_NAME = re.compile(r"([A-Za-z_]\w*)\s*(?:[<(]|$)")
# Seconds ``kernel_counts`` keeps the profiler running before its block and
# after the block's last kernel: the profiler keeps only the device records
# that fall inside its window on the host's clock, and a short block's
# kernels at the window's edges are otherwise lost now and then.
_MARGIN_S = 0.02


def kernel_name(name):
    """The base function name of a device kernel as the profiler records it
    (a demangled signature): return type, namespaces, template arguments
    and parameters dropped, e.g. ``band_product_kernel`` of ``void
    (anonymous namespace)::band_product_kernel<float, true>(BandArgs)``."""
    found = _BASE_NAME.search(name.replace("(anonymous namespace)::", ""))
    return found.group(1) if found else name


def kernel_instance(name):
    """``kernel_name`` with the template argument list that follows it in
    the demangled signature, if any: the instance of a kernel template,
    e.g. ``band_wgmma_kernel<true>`` of ``(anonymous
    namespace)::band_wgmma_kernel<true>(CUtensorMap_st, ...)``."""
    name = name.replace("(anonymous namespace)::", "")
    found = _BASE_NAME.search(name)
    if not found:
        return name
    rest = name[found.end(1):].lstrip()
    if not rest.startswith("<"):
        return found.group(1)
    depth = 0
    for i, c in enumerate(rest):
        depth += (c == "<") - (c == ">")
        if depth == 0:
            return found.group(1) + rest[:i + 1]
    return found.group(1)


@contextlib.contextmanager
def kernel_counts(key=kernel_name):
    """Count the device kernels that the block runs, by ``key`` of the
    recorded name (``kernel_name``, or ``kernel_instance``): yields a
    ``collections.Counter``, empty until the block ends. The
    counts come from the profiler's device (CUPTI) records, so a kernel of
    a CUDA graph replay counts as one of its own and a capture, which runs
    nothing, counts nothing. The profiler slows the block down: count
    outside timed calls. Copies and memsets are not counted; without a
    CUDA device the block runs and counts nothing."""
    counts = collections.Counter()
    cuda = torch.cuda.is_available()
    activity = (torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=[activity]) as prof:
        if cuda:
            time.sleep(_MARGIN_S)
        yield counts
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_MARGIN_S)
    device = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == device and not e.is_user_annotation()
                and not e.name().startswith(("Memcpy", "Memset"))):
            counts[key(e.name())] += 1


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
