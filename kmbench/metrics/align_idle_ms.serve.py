"""The device's idle gaps before the kernels launched inside the program's
``km.align`` spans (``align_pair``: the host's dispatch of the fits' small
launches and its blocking calls), over the profiled requests, a request."""

from kmbench.program_spans import idle_ms, per_unit


def read(data):
    return per_unit(data, idle_ms, "align")
