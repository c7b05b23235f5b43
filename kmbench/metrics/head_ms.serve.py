"""Device time of ``KeyMorphNet.keypoints_from_features`` (the centre of
mass), CUDA-event spans over the traced window, mean a volume."""

from kmbench.readings import span_mean_ms


def read(data):
    return span_mean_ms(data, "head")
