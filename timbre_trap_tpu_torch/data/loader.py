"""Host-side batch loader with threaded workers and a prefetch thread (the
port's copy of ``timbre_trap_tpu/data/loader.py``).

A thread pool maps ``dataset[i]`` over shuffled indices (audio decode is
IO-bound and the numpy resample/rasterize kernels release the GIL), batches
are collated to numpy, and :func:`device_prefetch` composes the next batches
on a background thread so host work overlaps the training step. The shuffle
draws the same numbers as the JAX package's loader from the same seeds.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .collate import default_collate

__all__ = ["DataLoader", "device_prefetch"]


class DataLoader:
    """Iterate a dataset in collated batches with optional worker threads.

    ``set_epoch(k)`` re-keys the shuffle RNG per epoch (``seed`` + epoch),
    making the order a pure function of (seed, epoch): a resumed run then
    reshuffles epoch k exactly as the uninterrupted run did — the
    process-lifetime RNG stream cannot provide that across a restart. The
    Trainer calls it at every epoch start.

    ``batch_rows`` (multi-process input sharding): positions within each
    batch this process should materialize. All processes draw the same
    shuffled order (same seed/epoch), but ``dataset[i]`` is only called for
    this process's rows of each batch, so host-side decode/rasterize cost
    stays O(1/n_processes) instead of every process composing the full
    global batch. Requires ``drop_last`` (a short final batch has no well-defined row
    split). An empty list yields ``{}`` sentinels: the batch exists for
    epoch accounting but carries no local rows.
    """

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=0,
                 drop_last=False, collate_fn=default_collate, seed=0,
                 prefetch_batches=2, batch_rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.batch_rows = batch_rows
        self._epoch = None

    def set_epoch(self, epoch):
        """Key the shuffle order by (seed, epoch) instead of the lifetime RNG."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            if self._epoch is None:
                self.rng.shuffle(order)
            else:
                np.random.RandomState(
                    (self.seed + 0x9E3779B1 * (self._epoch + 1))
                    % (2 ** 32)).shuffle(order)
        n_batches = len(self)
        for b in range(n_batches):
            idcs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.batch_rows is not None:
                if len(idcs) < self.batch_size:
                    raise ValueError(
                        "batch_rows requires drop_last=True batches")
                idcs = idcs[np.asarray(self.batch_rows, np.int64)]
            yield idcs

    def _collate(self, items):
        if self.batch_rows is not None and len(self.batch_rows) == 0:
            return {}  # no local rows: sentinel keeps epoch accounting
        return self.collate_fn(items)

    def __iter__(self):
        if self.num_workers <= 0:
            for idcs in self._batches():
                yield self._collate([self.dataset[i] for i in idcs])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            batch_iter = self._batches()

            def submit_next():
                idcs = next(batch_iter, None)
                if idcs is None:
                    return False
                pending.append([pool.submit(self.dataset.__getitem__, i)
                                for i in idcs])
                return True

            for _ in range(self.prefetch_batches):
                if not submit_next():
                    break
            while pending:
                futures = pending.pop(0)
                submit_next()
                yield self._collate([f.result() for f in futures])


def _pinned(item):
    """``item`` (an array, or a tuple or list of them) with its numpy
    arrays as tensors in page-locked host memory."""
    if isinstance(item, np.ndarray):
        return torch.from_numpy(item).pin_memory()
    if isinstance(item, (tuple, list)):
        return type(item)(_pinned(v) for v in item)
    return item


def device_prefetch(iterator, transfer=None, depth=2, pin_memory=False):
    """Stage up to ``depth`` batches ahead on a background thread.

    ``transfer`` (optional) maps a host batch before staging; it runs on
    the background thread, so it must not touch the device: the Trainer
    copies batches to the card from the main thread (``Trainer._transfer``).
    ``pin_memory`` turns the numpy arrays of each staged batch (an array,
    or a tuple or list of them) into tensors in page-locked host memory,
    on the background thread, so the main
    thread's copies to a CUDA device can run asynchronously; it needs CUDA
    (a CPU-only torch raises).

    Closing the returned generator (``gen.close()``, or a ``break`` that
    drops the last reference) stops the worker thread, closes ``iterator``
    (a ``DataLoader``'s worker pool with it) and joins the thread before it
    returns: the Trainer breaks out mid-epoch on early stop and must not
    leave threads iterating the loader or pinning batches.
    """
    if transfer is None:
        transfer = lambda batch: batch  # noqa: E731 - identity staging
    q = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    error = []

    def worker():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                item = transfer(batch)
                if pin_memory:
                    item = _pinned(item)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            error.append(e)
        finally:
            if hasattr(iterator, "close"):
                iterator.close()
            # The queue may be FULL of unconsumed batches here (slow
            # consumer) — keep trying until the sentinel lands or the
            # consumer closed us, else the consumer waits forever.
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, name="device_prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join()
