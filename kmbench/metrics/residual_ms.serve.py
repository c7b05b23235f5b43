"""Device time of the kernels launched inside the program's
``km.unet.residual`` spans (``models/fast_resunet.py``: the encoders' 1x1
lifts and their statistics; the residual sum and its ReLU run in the block's
last conv), over the profiled requests, a volume."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.residual", 2)
