"""Useful FLOPs of the traced window's completed registrations (both
extractions, fits, flows, warps) over the window, against 989 TFLOP/s."""

from kmbench.readings import mfu_pct


def read(data):
    return mfu_pct(data)
