"""Read device time out of a ``torch.profiler`` run: busy time, idle share
and time by kernel name. The torch.profiler form of
``keymorph_tpu/tools/trace_summary.py``.

Device activity is what CUPTI records on the card: kernels, copies and
memsets (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset`` in an exported
Chrome trace; ``DeviceType.CUDA`` events in a live profile). The device's
busy time is the union of those intervals, so overlapping streams count
once; its idle share is 1 - busy / the host's wall time of the run.

The program's spans (``keymorph_tpu_torch/tracing.py``: ``km.*`` ranges on
the profiler's clock) split the device's time and its idle gaps: a device
operation belongs to the innermost ``km.*`` range open on the thread that
launched it (the runtime call of the same correlation id), or, where that
thread has none open (autograd's device thread), to the innermost one open
on any thread; it counts for every span that range lies within, on any
thread. An operation's idle gap is the device's idle time between the end
of everything before it and its start.

Usage:
    python -m keymorph_tpu_torch.tools.trace_summary <trace.json[.gz] or dir> [top_n]

Library:
    profile_fn(fn, *args) -> (result, summary)
    summarize_trace(path, top_n) -> [(name, total_ms, count)]
    summarize_spans(path) -> [(span, device_ms, idle_ms)]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "km."


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


def _trace_events(trace_path: str):
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as fh:
        return [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]


def _trace_intervals(trace_path: str):
    return [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in _trace_events(trace_path) if e.get("cat") in DEVICE_CATS]


def span_reading(events):
    """[(span, device ms, idle ms)] of the ``km.*`` ranges among Chrome
    trace ``events``, by device time, the largest first; [] where the trace
    holds no device activity (not measured)."""
    ranges, launches, device = [], [], []
    for e in events:
        cat, name, ts = e.get("cat"), e.get("name", ""), float(e.get("ts", 0))
        end = ts + float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, end, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches.append((ts, corr, e.get("tid")))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            ranges.append((ts, end, name, e.get("tid")))
    if not device:
        return []
    ranges.sort(key=lambda r: (r[0], -r[1]))  # every container before what it holds
    around = [{o[2] for o in ranges[: i + 1] if o[1] >= r[1]} for i, r in enumerate(ranges)]
    owner, active, nxt = {}, [], 0
    for ts, corr, tid in sorted(launches, key=lambda launch: launch[0]):
        while nxt < len(ranges) and ranges[nxt][0] <= ts:
            active.append(nxt)
            nxt += 1
        active = [i for i in active if ranges[i][1] >= ts]
        mine = [i for i in active if ranges[i][3] == tid]
        if mine or active:
            owner[corr] = max(mine or active)  # the innermost
    totals = {r[2]: [0.0, 0.0] for r in ranges}
    last = None
    for s, e, corr in sorted(device, key=lambda d: d[0]):
        gap = max(0.0, s - last) if last is not None else 0.0
        last = e if last is None else max(last, e)
        for name in around[owner[corr]] if corr in owner else ():
            totals[name][0] += e - s
            totals[name][1] += gap
    rows = [(name, dev / 1e3, idle / 1e3) for name, (dev, idle) in totals.items()]
    return sorted(rows, key=lambda r: -r[1])


def summarize_spans(trace_path: str):
    """[(span, device ms, idle ms)] of a Chrome trace's ``km.*`` spans
    (:func:`span_reading`)."""
    return span_reading(_trace_events(trace_path))


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
    spans = summarize_spans(trace)
    if spans:
        print("by span: device ms, idle ms before its operations")
    for name, device_ms, idle_ms in spans:
        print(f"{device_ms:10.3f} ms  {idle_ms:10.3f} ms idle  {name}")


if __name__ == "__main__":
    main()
