"""The scSE gates' backward kernel's (``scse_gate_bwd_kernel``) share of its
roofline over the profiled steps: each gate's block output and cotangent read
once and its input gradient written once at 3.35 TB/s
(``counts/resunet_train.py``) over the kernels' device time."""

import re

from kmbench.kernel_share import roofline_pct

KERNEL = re.compile(r"(^|[\s:])scse_gate_bwd_kernel")


def read(data):
    return roofline_pct(data, KERNEL, "gate_bwd_calls_per_unit", "gate_bwd_bound_s_per_unit")
