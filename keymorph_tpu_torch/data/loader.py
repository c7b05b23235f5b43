"""Background prefetching for host-side data loading, and the transfer to
the card. Port of ``keymorph_tpu/data/loader.py``.

A daemon thread walks the loader (NIfTI decode: zlib inflation in libkmio
and the numpy resize release the GIL) while the consumer computes on the
device; :func:`device_prefetch` also moves each batch to the card from
pinned host memory in that thread, so the copy overlaps compute too.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from keymorph_tpu_torch import resolve_device


class ThreadPrefetcher:
    """Wrap any (re-)iterable loader with an N-deep background prefetch queue.

    Each ``iter()`` spawns a fresh daemon thread that walks the underlying
    loader and fills a bounded queue; the consumer overlaps device compute
    with the next batch's IO. Exceptions in the worker propagate to the
    consumer at the point of ``next()``.
    """

    _SENTINEL = object()

    def __init__(self, loader: Iterable, depth: int = 2):
        assert depth >= 1
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not _put(item):
                        return  # consumer stopped early (break/close)
            except BaseException as e:  # propagate into the consumer
                _put(("__prefetch_error__", e))
            finally:
                _put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()

        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and item[0] == "__prefetch_error__"
                ):
                    raise item[1]
                yield item
        finally:
            # consumer broke out (or the generator was closed): release the
            # worker so it stops decoding and drops its queued items instead
            # of blocking on q.put forever (volumes are hundreds of MB)
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def batch_to_device(batch, device):
    """Every numpy array (or tensor) in a batch (nested dicts, lists and
    tuples) as a tensor on ``device``: pinned host memory, then
    ``.to(device, non_blocking=True)`` for a CUDA device. Other leaves
    (names, modalities) pass through."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(batch_to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray) and batch.dtype.kind in "biuf":
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not torch.is_tensor(batch):
        return batch
    if device.type == "cuda":
        return batch.pin_memory().to(device, non_blocking=True)
    return batch.to(device)


def device_prefetch(loader: Iterable, to_device=None, depth: int = 2, device=None):
    """:class:`ThreadPrefetcher` with the host -> device transfer inside the
    worker thread.

    ``to_device`` maps a host batch to device tensors; by default
    :func:`batch_to_device` onto ``device`` (None = the CUDA card, raising
    without one; the tests pass "cpu").
    """
    if to_device is None:
        dev = resolve_device(device)

        def to_device(item):
            return batch_to_device(item, dev)

    class _Mapped:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            for item in self.inner:
                yield to_device(item)

    return ThreadPrefetcher(_Mapped(loader), depth)
