"""Device time of a request's ``align_planes`` calls (warps), summed,
CUDA-event spans over the traced window, mean a request."""

from kmbench.readings import per_unit_ms


def read(data):
    return per_unit_ms(data, "warp")
