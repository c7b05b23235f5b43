"""The scSE gates' (``scse_gate_kernel``) share of their roofline over the
profiled requests: each gate's block output read once and written once at
3.35 TB/s (``counts/resunet.py``) over the kernels' device time."""

import re

from kmbench.kernel_share import roofline_pct

KERNEL = re.compile(r"(^|[\s:])scse_gate_kernel")


def read(data):
    return roofline_pct(data, KERNEL, "gate_calls_per_unit", "gate_bound_s_per_unit")
