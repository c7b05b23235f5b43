"""Device time of the kernels launched inside the program's ``km.unet.tconv``
spans (``models/fast_resunet.py``: a residual decoder's transposed conv with
its skip sum), over the profiled requests, a volume."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.tconv", 2)
