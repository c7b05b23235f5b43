"""Device time of the kernels launched inside the program's ``km.unet.pool``
spans (``models/fast_unet.py:_maxpool2_flat``, the U-Net's 2x max-pools),
over the profiled requests, a volume."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.pool", 2)
