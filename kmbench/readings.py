"""Arithmetic the metric readers share. Every reader takes the run's
``data`` (the driver's record of its window, with ``peak_bytes``) and
returns a number, or None where the run holds nothing to read: a reader
never returns 0 for a share it could not measure.

``data`` keys: ``unit`` ("request" or "step"), ``units`` completed in the
window, ``window_s``, ``setup_s``, ``peak_bytes``; serving also
``registrations``, ``volumes`` and ``latencies_ms``; a traced run also
``spans`` ({span: [ms]}), ``profile`` (a ``trace.Reading`` or None),
``profiled_units``, ``flops_per_unit``, ``conv_calls_per_unit`` and
``conv_bound_s_per_unit``.
"""

from __future__ import annotations

import re

from kmbench import counts

# the program's conv kernels (csrc/conv3d.cu), as CUPTI names them:
# "void (anonymous namespace)::conv3x3_mma_kernel<64>(...)"
CONV_KERNEL = re.compile(r"(^|[\s:])conv3x3_\w*kernel")


def quantile(values, q: float):
    """The q-quantile by linear interpolation between order statistics
    (numpy's default), None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def span_total_ms(data, name):
    ms = (data.get("spans") or {}).get(name)
    return None if not ms else sum(ms)


def span_mean_ms(data, name):
    ms = (data.get("spans") or {}).get(name)
    return None if not ms else sum(ms) / len(ms)


def per_unit_ms(data, name):
    total = span_total_ms(data, name)
    return None if total is None or not data["units"] else total / data["units"]


def profiled(data):
    """The profile and its unit count, or (None, 0) where nothing was
    profiled or the device recorded nothing."""
    reading, n = data.get("profile"), data.get("profiled_units", 0)
    if reading is None or not n or not reading.device:
        return None, 0
    return reading, n


def idle_share_pct(data):
    reading, _ = profiled(data)
    if reading is None or reading.wall_us <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_us() / reading.wall_us)


def conv_roofline_pct(data):
    """The conv kernels' share of their roofline over the profiled units:
    the sum of each call's bound (``counts.bound_s``) over the sum of the
    ``conv3x3_*`` kernels' device time. None unless the profile holds
    exactly the calls the configuration's plan predicts."""
    reading, n = profiled(data)
    if reading is None:
        return None
    convs = [d for d in reading.kernels() if CONV_KERNEL.search(d[0])]
    if not convs or len(convs) != n * data["conv_calls_per_unit"]:
        return None
    busy_s = sum(e - s for _, s, e, _, _ in convs) / 1e6
    return 100.0 * n * data["conv_bound_s_per_unit"] / busy_s


def mfu_pct(data):
    """Useful FLOPs of the window's completed units over its time, against
    the bf16 peak."""
    if not data["units"] or data["window_s"] <= 0:
        return None
    return (100.0 * data["flops_per_unit"] * data["units"] / data["window_s"]
            / counts.H100_BF16_PEAK_FLOPS)
