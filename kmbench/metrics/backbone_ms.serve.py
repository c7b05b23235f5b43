"""Device time of ``KeyMorphNet.features`` (the U-Net on the conv
kernels), CUDA-event spans over the traced window, mean a volume."""

from kmbench.readings import span_mean_ms


def read(data):
    return span_mean_ms(data, "backbone")
