"""Device time of the kernels launched inside the program's
``km.unet.tconv.bwd`` spans (``ops/cuda/conv3d.py:_TConv.backward``: a
residual decoder's transposed conv's input and weight gradients, its bias and
stats terms), over the profiled steps, a step."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.tconv.bwd")
