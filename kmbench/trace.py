"""A profiled stretch of the window, read from ``torch.profiler``'s trace.

The reading follows the port's ``tools/trace_summary.py``: device activity
is what CUPTI records on the card (kernels, copies, memsets); the device's
busy time is the union of those intervals, so overlapping streams count
once; the idle share is 1 - busy / the host's wall time of the stretch.
Beyond it this module keeps each kernel's launch (the runtime call of the
same correlation id) and the host's ranges, so that kernels can be
attributed to the host range that launched them (an autograd node, a
``kmbench.<span>``) and idle gaps to what the host was doing.

The trace is exported to a file under the temporary directory, read and
deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Reading:
    """What one profiled stretch holds (times in microseconds).

    ``device``: [(name, start, end, category, correlation)] of kernels,
    copies and memsets, by start; ``launches``: {correlation: (tid, ts)} of the host's
    runtime calls; ``host``: {tid: [(start, end, name)]} of host ranges;
    ``wall_us``: the host's wall time of the stretch."""

    def __init__(self, events, wall_us: float):
        self.wall_us = wall_us
        self.device, self.launches = [], {}
        self.host = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", "?"), ts, ts + dur, cat, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launches[corr] = (e.get("tid"), ts)
            elif cat in HOST_CATS:
                self.host[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
        self.device.sort(key=lambda d: d[1])
        for ranges in self.host.values():
            ranges.sort(key=lambda r: (r[0], -r[1]))
        self._enclosing = None

    @classmethod
    def from_trace_file(cls, path: str, wall_us: float):
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []), wall_us)

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e, _, _ in self.device])

    def enclosing(self, correlation):
        """The names of the host ranges around the launch of
        ``correlation``, outermost first (None for an unknown launch)."""
        if self._enclosing is None:
            self._enclosing = self._sweep()
        return self._enclosing.get(correlation)

    def _sweep(self):
        """One pass per host thread over its ranges (which nest) and its
        launches, both by time, keeping the stack of open ranges."""
        by_tid = defaultdict(list)
        for corr, (tid, ts) in self.launches.items():
            by_tid[tid].append((ts, corr))
        out = {}
        for tid, launches in by_tid.items():
            ranges, i, stack = self.host.get(tid, []), 0, []
            for ts, corr in sorted(launches):
                while i < len(ranges) and ranges[i][0] <= ts:
                    while stack and stack[-1][1] < ranges[i][0]:
                        stack.pop()
                    stack.append(ranges[i])
                    i += 1
                while stack and stack[-1][1] < ts:
                    stack.pop()
                out[corr] = [r[2] for r in stack if r[0] <= ts <= r[1]]
        return out

    def launched_under(self, d, name_part: str) -> bool:
        """Was device event ``d`` launched inside a host range whose name
        holds ``name_part``?"""
        names = self.enclosing(d[4])
        return bool(names) and any(name_part in n for n in names)

    def top_device_ops(self, n: int = 10):
        """[[name, seconds]] of the ``n`` device operations that took most
        time, summed by (short) name."""
        totals = defaultdict(float)
        for name, s, e, _, _ in self.device:
            totals[short_name(name)] += e - s
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in rows]

    def idle_gaps(self, n: int = 10):
        """[[label, seconds]]: the device's idle gaps between two of its
        operations, summed by what the host was doing as the second was
        launched (the outermost ``kmbench.`` span and the innermost host
        range on the launching thread), the ``n`` largest."""
        totals = defaultdict(float)
        end = None
        for d in self.device:
            if end is not None and d[1] > end:
                totals[self._label(d)] += d[1] - end
            end = d[2] if end is None else max(end, d[2])
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[label, us / 1e6] for label, us in rows]

    def _label(self, d) -> str:
        names = self.enclosing(d[4])
        if names is None:
            return "unattributed"
        spans = [n for n in names if n.startswith("kmbench.")]
        return f"{spans[0] if spans else 'outside spans'} / {names[-1] if names else 'host'}"


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and parameter list,
    at most ``limit`` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):  # cut at the parameter list's "(" outside templates
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif (ch == "(" and depth == 0 and i > 0 and name[i - 1] != " "
              and not name.startswith("(anonymous", i)):
            name = name[:i]
            break
    return name[:limit]


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


class Profiled:
    """``with Profiled(on, clock) as p: ...`` runs the block under
    ``torch.profiler`` (host and, on the card, CUDA activity, synchronised
    before and after) when ``on``; afterwards ``p.reading`` is its
    :class:`Reading` (None when off)."""

    def __init__(self, enabled: bool, clock):
        self.enabled = enabled
        self.clock = clock
        self.reading = None

    def __enter__(self):
        if not self.enabled:
            return self
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.clock.cuda else [])
        self._prof = profile(activities=activities)
        self.clock.sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self.clock.sync()
        wall_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="kmbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.reading = Reading.from_trace_file(path, wall_us)
        finally:
            os.unlink(path)
        del self._prof
        return False
