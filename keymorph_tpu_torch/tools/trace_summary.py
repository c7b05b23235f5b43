"""Read device time out of a ``torch.profiler`` run: busy time, idle share
and time by kernel name. The torch.profiler form of
``keymorph_tpu/tools/trace_summary.py``.

Device activity is what CUPTI records on the card: kernels, copies and
memsets (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset`` in an exported
Chrome trace; ``DeviceType.CUDA`` events in a live profile). The device's
busy time is the union of those intervals, so overlapping streams count
once; its idle share is 1 - busy / the host's wall time of the run.

Usage:
    python -m keymorph_tpu_torch.tools.trace_summary <trace.json[.gz] or dir> [top_n]

Library:
    profile_fn(fn, *args) -> (result, summary)
    summarize_trace(path, top_n) -> [(name, total_ms, count)]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_file(path: str):
    """``path`` if it names a trace file, else the newest ``*.json[.gz]``
    under the directory (None where there is none)."""
    if path.endswith((".json", ".json.gz")):
        return path
    hits = [p for pattern in ("*.json", "*.json.gz")
            for p in glob.glob(os.path.join(path, "**", pattern), recursive=True)]
    return max(hits, key=os.path.getmtime) if hits else None


def device_reading(intervals, top_n=None):
    """(busy µs, [(name, total ms, count)] by time, the largest first) of
    device intervals ``(name, start µs, end µs)``; busy counts the union of
    the intervals."""
    busy, end, totals = 0.0, float("-inf"), {}
    for name, s, e in sorted(intervals, key=lambda iv: iv[1]):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + e - s)
    rows = sorted(((name, t / 1e3, n) for name, (n, t) in totals.items()),
                  key=lambda r: -r[1])
    return busy, rows[:top_n] if top_n else rows


def _trace_intervals(trace_path: str):
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    return [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def summarize_trace(trace_path: str, top_n: int = 20):
    """[(name, total_ms, count)] of a Chrome trace's device events, the
    largest first."""
    return device_reading(_trace_intervals(trace_path), top_n)[1]


def profile_fn(fn, *args, top_n=None, trace_dir=None):
    """Run ``fn(*args)`` under ``torch.profiler`` (CPU, and CUDA where a
    card is visible, synchronized before and after). Returns (its result,
    summary): ``wall_ms`` (host clock), ``busy_ms`` and ``idle_share``
    (None where the profiler recorded no device activity, as on the CPU:
    not measured), ``ops`` ([(name, total_ms, count)] of device events, the
    largest first, ``top_n`` of them). With ``trace_dir`` the Chrome trace
    is also written there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    intervals = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    busy, rows = device_reading(intervals, top_n)
    measured = bool(intervals)
    return out, {"wall_ms": wall_us / 1e3,
                 "busy_ms": busy / 1e3 if measured else None,
                 "idle_share": 1.0 - busy / wall_us if measured else None,
                 "ops": rows}


def main():
    path = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    trace = find_trace_file(path)
    if trace is None:
        print(f"no trace file under {path}")
        return
    print(f"trace: {trace}")
    total = 0.0
    for name, ms, count in summarize_trace(trace, top_n):
        total += ms
        print(f"{ms:10.3f} ms  x{count:<5d} {name[:100]}")
    print(f"{'':>10}  (top-{top_n} total {total:.3f} ms)")


if __name__ == "__main__":
    main()
