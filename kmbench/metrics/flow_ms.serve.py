"""Device time of the kernels launched inside the program's
``km.align.flow`` spans (``align_pair``'s planes: the TPS flow kernel, the
affine planes), over the profiled requests, a request."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "align.flow")
