"""Spans inside the port, on the profiler's clock, and the stage timer of
``KeyMorph``'s result fields.

``span(name)`` opens ``torch.profiler.record_function("km." + name)`` while
``torch.profiler`` is recording, and is a shared no-op context otherwise:
the range then lives in the profiler's trace beside the CUPTI device
events, on one clock, so each kernel can be put down to the span that
launched it and each idle gap of the device to what the host was doing.
With the profiler off a span builds nothing (an ungated ``record_function``
costs ~15 us on the host). Span names start with ``km.``:

  * ``km.backbone``, ``km.unet.pool``, ``km.unet.final`` and ``km.head``:
    ``KeyMorphNet.features``, the executors' 2x max-pool and final 1x1
    conv, ``KeyMorphNet.keypoints_from_features``;
  * ``km.unet.residual``, ``km.unet.tconv``, ``km.unet.se``: the residual
    executor's (``models/fast_resunet.py``) 1x1 lifts, transposed convs with
    their skip sums, and scSE gates with their squeeze;
  * ``km.align`` with ``km.align.fit`` and ``km.align.flow`` inside it:
    ``align_pair``, its solver calls and its planes or grid;
  * ``km.warp``: ``ops/resample.py:align_planes`` and ``align_img``;
  * ``km.train.augment``, ``km.train.extract``, ``km.train.loss``,
    ``km.train.backward``, ``km.train.optimizer``: the training step's
    phases;
  * ``km.conv.recompute``, ``km.conv.input_grad``, ``km.conv.weight_grad``:
    the conv's autograd backward (on autograd's device thread on the card);
  * ``km.unet.tconv.bwd``, ``km.unet.se.bwd``, ``km.unet.residual.bwd``: the
    residual executor's backward of a transposed conv (its input and weight
    gradients), of a gate's pass and of a lift.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``km.<name>`` range of the profiler's trace while it records; else
    a shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("km." + name)


class StageTimer:
    """Marks between a call's stages: CUDA events on the device's current
    stream, or the host clock on the CPU. ``wait()`` once after the last
    mark, then read ``seconds(a, b)`` between any two marks; nothing
    blocks the host before that wait."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._marks = []

    def mark(self) -> int:
        """Record a point of the stream (or the host clock); its index."""
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())
        return len(self._marks) - 1

    def wait(self):
        """Block the host until the device has passed the last mark."""
        if self.cuda and self._marks:
            self._marks[-1].synchronize()

    def seconds(self, a: int, b: int) -> float:
        """Seconds between marks ``a`` and ``b`` (after :meth:`wait`)."""
        if self.cuda:
            return self._marks[a].elapsed_time(self._marks[b]) / 1e3
        return self._marks[b] - self._marks[a]
