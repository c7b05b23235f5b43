"""The conv kernels' (``conv3x3_*``: forward, its recomputation, input
gradient) share of their roofline over the profiled steps."""

from kmbench.readings import conv_roofline_pct


def read(data):
    return conv_roofline_pct(data)
