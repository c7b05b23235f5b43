"""Device time of the kernels launched inside the program's ``km.unet.se``
spans (``models/fast_resunet.py``: the scSE gate, its channel MLP included),
over the profiled requests, a volume."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.se", 2)
