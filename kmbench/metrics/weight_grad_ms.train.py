"""Device time of the kernels launched inside the program's
``km.conv.weight_grad`` spans (``_FusedConv.backward``'s ``u`` and
``_weight_grad``: its fp32 GEMMs and copies), over the profiled steps, a
step."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "conv.weight_grad")
