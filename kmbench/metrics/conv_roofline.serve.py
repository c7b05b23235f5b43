"""The conv kernels' (``conv3x3_*``) share of their roofline over the
profiled requests (``readings.conv_roofline_pct``)."""

from kmbench.readings import conv_roofline_pct


def read(data):
    return conv_roofline_pct(data)
