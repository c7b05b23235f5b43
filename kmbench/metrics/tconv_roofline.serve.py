"""The transposed convs' (``tconv3_mma_kernel``, the residual decoders'
upsampling) share of their roofline over the profiled requests: each call's
bound from ``counts/resunet.py`` (useful operations over the bf16 peak or
bytes over the HBM rate) over the kernels' device time."""

import re

from kmbench.kernel_share import roofline_pct

KERNEL = re.compile(r"(^|[\s:])tconv3_mma_kernel")


def read(data):
    return roofline_pct(data, KERNEL, "tconv_calls_per_unit", "tconv_bound_s_per_unit")
