"""Device time of the kernels launched inside the program's
``km.unet.residual.bwd`` spans (``ops/cuda/resblock.py:_Lift.backward``: the
encoders' 1x1 lifts' input, weight and bias gradients with their stats term),
over the profiled steps, a step."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.residual.bwd")
