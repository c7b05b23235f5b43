"""Device time of the kernels launched inside the program's ``km.unet.se.bwd``
spans (``ops/cuda/resblock.py:_ScseGate.backward``: the gate's backward pass
and the sums of its partials; the MLP's backward on (C,) runs as autograd's
own nodes, outside the span), over the profiled steps, a step."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "unet.se.bwd")
