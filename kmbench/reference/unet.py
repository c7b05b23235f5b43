"""The keypoint extractor: a DoubleConv U-Net (GroupNorm -> 3x3x3 conv ->
ReLU, twice a block), truncated by its last decoders, a 1x1 head and the
centre of mass of each ReLU'd heatmap.

Weights are a dict under the published U-Net's ``state_dict`` names
(``encoders.i.basic_module.SingleConv{1,2}.{groupnorm,conv}.*``,
``decoders.j...``, ``final_conv.*``), conv weights (Cout, Cin, 3, 3, 3).
Channel-first (1, C, D, H, W) float32 tensors hold bf16 values: the input
and every block output are stored in bf16, GroupNorm takes fp32 statistics
(eps 1e-5; one group below 8 channels, else 8), convolution operands are
rounded to the configuration's precision and summed in fp32, a 2x max-pool
precedes every encoder but the first, the head's output is stored in bf16
and its centre of mass summed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kmbench.reference.precision import Precision, store


def widths(f_maps: int, num_levels: int):
    return [f_maps * 2 ** k for k in range(num_levels)]


def param_specs(f_maps: int, num_levels: int, num_truncated: int, keypoints: int):
    """[(name, shape, kind)] of the extractor's parameters, in a fixed
    order; kind ``conv``, ``scale`` or ``shift``."""
    specs = []

    def single(prefix, cin, cout):
        specs.append((f"{prefix}.conv.weight", (cout, cin, 3, 3, 3), "conv"))
        specs.append((f"{prefix}.groupnorm.weight", (cin,), "scale"))
        specs.append((f"{prefix}.groupnorm.bias", (cin,), "shift"))

    fm = widths(f_maps, num_levels)
    cin = 1
    for i, ch in enumerate(fm):
        mid = max(ch // 2, cin)
        single(f"encoders.{i}.basic_module.SingleConv1", cin, mid)
        single(f"encoders.{i}.basic_module.SingleConv2", mid, ch)
        cin = ch
    rev = fm[::-1]
    for j in range(len(rev) - 1 - num_truncated):
        out = rev[j + 1]
        single(f"decoders.{j}.basic_module.SingleConv1", out + cin, out)
        single(f"decoders.{j}.basic_module.SingleConv2", out, out)
        cin = out
    specs.append(("final_conv.weight", (keypoints, cin, 1, 1, 1), "conv"))
    specs.append(("final_conv.bias", (keypoints,), "shift"))
    return specs


def _single(w, prefix, x, prec: Precision):
    c = x.shape[1]
    u = F.group_norm(x, 1 if c < 8 else 8, w[f"{prefix}.groupnorm.weight"],
                     w[f"{prefix}.groupnorm.bias"], eps=1e-5)
    v = F.conv3d(prec.conv_operand(u), prec.conv_operand(w[f"{prefix}.conv.weight"]),
                 padding=1)
    return store(torch.relu(v))


def _double(w, prefix, x, prec):
    x = _single(w, f"{prefix}.SingleConv1", x, prec)
    return _single(w, f"{prefix}.SingleConv2", x, prec)


def max_pool2(x):
    """2x max-pool (floor) as a max over 2x2x2 blocks; at tied maxima its
    gradient is split evenly among them (``amax``), the convention the
    program states for its pool."""
    B, C, D, H, W = x.shape
    x = x[:, :, : D // 2 * 2, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, C, D // 2, 2, H // 2, 2, W // 2, 2).amax(dim=(3, 5, 7))


def heatmaps(w, img, num_levels: int, num_truncated: int, prec: Precision):
    """(1, 1, D, H, W) volume -> (1, K, D', H', W') heatmaps (bf16 values)."""
    x = store(img)
    n_dec = num_levels - 1 - num_truncated
    keep = set(range(num_levels - 1 - n_dec, num_levels - 1))  # skips a decoder reads
    skips = {}
    for i in range(num_levels):
        if i > 0:
            x = max_pool2(x)
        x = _double(w, f"encoders.{i}.basic_module", x, prec)
        if i in keep:
            skips[i] = x
    for j in range(n_dec):
        skip = skips.pop(num_levels - 2 - j)
        up = F.interpolate(x, size=skip.shape[2:], mode="nearest")
        x = _double(w, f"decoders.{j}.basic_module", torch.cat([skip, up], dim=1), prec)
    out = F.conv3d(prec.conv_operand(x), prec.conv_operand(w["final_conv.weight"]))
    return store(out + w["final_conv.bias"].reshape(1, -1, 1, 1, 1))


def center_of_mass(heat):
    """(1, K, D, H, W) -> (1, K, 3) keypoints, ``ij`` order, in [-1, 1]:
    along an axis of N voxels the mass-weighted mean of linspace(0, 1, N),
    mapped by ``* 2 - 1``, over the ReLU'd heatmap."""
    v = torch.relu(heat)
    coords = []
    for axis in (2, 3, 4):
        others = tuple(a for a in (2, 3, 4) if a != axis)
        m = v.sum(dim=others)  # (1, K, N)
        line = torch.linspace(0.0, 1.0, v.shape[axis], device=v.device)
        coords.append((m * line).sum(-1) / (m.sum(-1) + 1e-8))
    return torch.stack(coords, dim=-1) * 2.0 - 1.0


def keypoints(w, img, num_levels: int, num_truncated: int, prec: Precision):
    """(1, 1, D, H, W) volume -> (1, K, 3) keypoints."""
    return center_of_mass(heatmaps(w, img, num_levels, num_truncated, prec))
