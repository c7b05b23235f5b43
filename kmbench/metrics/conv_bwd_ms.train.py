"""Device time of the kernels launched inside the conv's autograd backward
node (``_FusedConvBackward``: the recomputed forward, the input-gradient
kernel, the weight gradient's GEMMs and copies), a profiled step."""

from kmbench.readings import profiled

NODE = "_FusedConvBackward"


def read(data):
    reading, n = profiled(data)
    if reading is None:
        return None
    under = [d for d in reading.device if reading.launched_under(d, NODE)]
    if not under:
        return None
    return sum(e - s for _, s, e, _, _ in under) / 1e3 / n
