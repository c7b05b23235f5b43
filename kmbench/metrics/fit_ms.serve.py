"""Device time of the kernels launched inside the program's ``km.align.fit``
spans (``align_pair``'s closed-form fits and matrix inverses), over the
profiled requests, a request."""

from kmbench.program_spans import device_ms, per_unit


def read(data):
    return per_unit(data, device_ms, "align.fit")
