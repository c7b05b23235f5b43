"""The device's idle gaps before the kernels launched inside the program's
``km.train.augment`` span (the step's affine augmentation, whose matrix
inverse blocks the host), over the profiled steps, a step."""

from kmbench.program_spans import idle_ms, per_unit


def read(data):
    return per_unit(data, idle_ms, "train.augment")
