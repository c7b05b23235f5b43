"""Device time of the kernels launched inside the program's
``km.train.optimizer`` span (the gradients' global norm and Adam's update),
over the profiled steps, a step."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "train.optimizer")
