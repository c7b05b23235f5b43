"""Everything a run draws from its seed: weights, the volume pool, the
order of the requests and the training draws.

The same seed gives the same inputs on any device of one kind. Weights and
volumes are drawn on the device in a few large calls from a
``torch.Generator`` of that device; the small draws (request order,
lambda, keypoint subsets, augmentation parameters) come from the host and
are the same on every device. Nothing here imports the program: the
harness hands the same tensors to the program and to the reference.
"""

from __future__ import annotations

import hashlib
import math
import random

import torch

WEIGHTS, VOLUMES, ORDER, DRAWS = range(4)  # the streams of one seed


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def make_weights(seed: int, specs, device) -> dict:
    """{name: fp32 tensor} for ``specs`` [(name, shape, kind)], from one
    normal draw on ``device``. ``kind``: ``conv`` (LeCun normal, std
    sqrt(1/fan_in), as the port's ``init_weights``), ``scale`` (1 + 0.1 z:
    a norm's scale), ``shift`` (0.1 z: a norm's shift or a bias). Scales,
    shifts and biases are drawn around their initial values, not left at
    1 and 0, so that the output check covers them."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device), device=device)
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = flat[off: off + n].view(shape)
        off += n
        if kind == "conv":
            out[name] = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "scale":
            out[name] = 1.0 + 0.1 * z
        elif kind == "shift":
            out[name] = 0.1 * z
        else:
            raise ValueError(f"weight kind {kind!r}")
    return out


SMOOTHING = 8  # voxels between the knots of a volume's random field


def make_pool(seed: int, count: int, size: int, device) -> torch.Tensor:
    """(count, 1, size, size, size) fp32 volumes in [0, 1): uniform noise
    at knots ``SMOOTHING`` voxels apart, interpolated trilinearly. A scan's
    intensities vary smoothly at the scale of a voxel; white noise would
    make the loss of a sub-voxel shift, and so every gradient of the
    training step, change sign from one rounding to the next."""
    knots = max(2, size // SMOOTHING + 1)
    coarse = torch.rand((count, 1, knots, knots, knots),
                        generator=generator(seed, VOLUMES, device), device=device)
    return torch.nn.functional.interpolate(coarse, size=(size, size, size), mode="trilinear",
                                           align_corners=True)


class PairOrder:
    """The ordered (fixed, moving) pairs of a pool, two distinct volumes
    each: a permutation of all of them drawn from the seed, walked in a
    cycle, so that the first ``count * (count - 1)`` pairs all differ."""

    def __init__(self, seed: int, count: int):
        pairs = [(f, m) for f in range(count) for m in range(count) if f != m]
        random.Random(sub_seed(seed, ORDER)).shuffle(pairs)
        self.pairs = pairs

    def __call__(self, i: int):
        return self.pairs[i % len(self.pairs)]


def train_draws(seed: int, rows: int, num_keypoints: int, train_keypoints: int,
                max_lmbda: float, max_aug, device) -> dict:
    """``rows`` steps' draws, row i for step i (cycled): ``lmbda`` (rows,)
    log-uniform in [1e-6, max_lmbda); ``keypoint_idx`` (rows, k) the first k
    of a permutation of the keypoints; the augmentation's ``scale``
    (rows, 3) in 1 +- s, ``offset`` (rows, 3), ``theta`` (rows, 3) and
    ``shear`` (rows, 6) uniform in +- their maximum. Drawn on the host,
    stored on ``device``."""
    gen = torch.Generator().manual_seed(sub_seed(seed, DRAWS))
    lo, hi = math.log(1e-6), math.log(max_lmbda)
    lmbda = torch.exp(torch.rand(rows, generator=gen) * (hi - lo) + lo)
    idx = torch.stack([torch.randperm(num_keypoints, generator=gen)[:train_keypoints]
                       for _ in range(rows)])
    s, o, a, z = (float(v) for v in max_aug)

    def uniform(n, low, high):
        return low + (high - low) * torch.rand((rows, n), generator=gen)

    draws = {"lmbda": lmbda, "keypoint_idx": idx,
             "scale": uniform(3, 1 - s, 1 + s), "offset": uniform(3, -o, o),
             "theta": uniform(3, -a, a), "shear": uniform(6, -z, z)}
    return {k: v.to(device) for k, v in draws.items()}
