"""The transposed convs' backward kernels' (``tconv3_dgrad_mma_kernel``,
``tconv3_wgrad_mma_kernel`` and ``tconv3_wgrad_reduce_kernel``: the input and
weight gradients) share of their roofline over the profiled steps: each
gradient's bound from ``counts/resunet_train.py`` (the forward's useful
operations over the bf16 peak, or bytes over the HBM rate, whichever is
larger) over the kernels' device time."""

import re

from kmbench.kernel_share import roofline_pct

KERNEL = re.compile(r"(^|[\s:])tconv3_(dgrad|wgrad)_\w*kernel")


def read(data):
    return roofline_pct(data, KERNEL, "tconv_bwd_calls_per_unit", "tconv_bwd_bound_s_per_unit")
