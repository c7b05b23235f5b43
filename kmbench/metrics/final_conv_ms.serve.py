"""Device time of the kernels launched inside the program's
``km.unet.final`` spans (``models/fast_unet.py:fast_unet_forward``'s final
1x1 conv: the fp32 matmul and bias), over the profiled requests, a volume."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.final", 2)
