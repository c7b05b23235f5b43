"""Device kernels a profiled step launches."""

from kmbench.readings import profiled


def read(data):
    reading, n = profiled(data)
    return None if reading is None else len(reading.kernels()) / n
