"""Marks on the device's timeline.

On the card a mark is a CUDA event recorded on the current stream, and the
time between two marks is device time. The harness runs on the CPU only in
its own tests (a measured run refuses a machine without a card), where a
mark is the host clock.
"""

from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, mark):
        """Block the host until the device has passed ``mark``."""
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3
