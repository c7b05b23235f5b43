"""Spans the benchmark records around its calls into the program's layers.

In a traced run (``--trace 1``) each span is a pair of marks of the
``Clock`` (CUDA events on the current stream on the card, so its length is
device time between the two points of the stream), and it is also a
``torch.profiler.record_function`` range named ``kmbench.<span>``, which
labels the host's work in a profile. In an untraced run a span records
nothing. Events are read once the window has closed, so reading them stalls
nothing inside it.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch


class Spans:
    def __init__(self, clock):
        self.clock = clock
        self.on = False  # the driver turns it on for a traced window
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"kmbench.{name}"):
            start = self.clock.mark()
            yield
            end = self.clock.mark()
        self._events[name].append((start, end))

    def milliseconds(self) -> dict:
        """{span: [ms of each occurrence]}, after a synchronisation."""
        self.clock.sync()
        return {name: [self.clock.ms(s, e) for s, e in pairs]
                for name, pairs in self._events.items()}
