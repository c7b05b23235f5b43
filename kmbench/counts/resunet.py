"""Operation and byte counts of ResidualUNetSE3D's serving pass (useful
operations from the architecture, not what a kernel executes), with the
functions of ``kmbench.counts`` that the serving driver calls, under the same
names and signatures.

A block of width C over V voxels: the 1x1 lift where the widths change (an
encoder's), two 3x3x3 convs C -> C (the second reads the residual, C x V
more bf16 values, in its epilogue), the scSE gate. A decoder's transposed
3x3x3 stride-2 conv takes each of its V/8 input voxels once a tap: 2 x 27 x
Cin x Cout x V/8 useful operations (the kernel, over the zero-dilated input,
executes eight times as many).
"""

from __future__ import annotations

from math import prod

# bound_s and conv_flops are the serving driver's, as kmbench.counts gives them
from kmbench.counts import (BF16_BYTES, affine_flow_flops, bound_s, conv_flops,  # noqa: F401
                            head_flops, tps_flow_flops, tps_solve_flops, unet_levels, warp_flops)
from kmbench.counts import conv_bytes as _conv_bytes


def _levels(spatial, f_maps: int, num_levels: int):
    """[(width, voxels)] of each level, the volume halved (floor) a level."""
    out, s = [], tuple(spatial)
    for ch in unet_levels(f_maps, num_levels):
        out.append((ch, prod(s)))
        s = tuple(d // 2 for d in s)
    return out


def conv_plan(spatial, f_maps: int, num_levels: int, num_truncated: int = 0,
              in_channels: int = 1):
    """The 3x3x3 convs of one pass, in the order they run (as
    ``counts.conv_plan``: ``name``, ``cin``, ``cout``, ``vox``, ``lowres``
    0, and ``res``: the residual channels the second conv of a block reads),
    the last width and its voxels. ``num_truncated`` must be 0 (the residual
    nets keep every decoder)."""
    if num_truncated:
        raise ValueError("the residual U-Nets keep every decoder")
    lv = _levels(spatial, f_maps, num_levels)
    plan = []
    for name, (ch, vox) in [(f"e{i}", lv[i]) for i in range(num_levels)] + \
            [(f"d{j}", lv[num_levels - 2 - j]) for j in range(num_levels - 1)]:
        plan.append(dict(name=f"{name}c2", cin=ch, cout=ch, vox=vox, lowres=0, res=0))
        plan.append(dict(name=f"{name}c3", cin=ch, cout=ch, vox=vox, lowres=0, res=ch))
    return plan, lv[0][0], lv[0][1]


def conv_bytes(c) -> float:
    """``counts.conv_bytes`` plus the residual the epilogue reads."""
    return _conv_bytes(c) + c.get("res", 0) * c["vox"] * BF16_BYTES


def tconv_plan(spatial, f_maps: int, num_levels: int):
    """The decoders' transposed convs in the order they run: ``cin`` (the
    half-resolution input's channels), ``cout``, ``vox`` (output voxels)."""
    lv = _levels(spatial, f_maps, num_levels)
    return [dict(name=f"d{j}t", cin=lv[num_levels - 1 - j][0], cout=lv[num_levels - 2 - j][0],
                 vox=lv[num_levels - 2 - j][1]) for j in range(num_levels - 1)]


def tconv_flops(t) -> float:
    return 2.0 * 27.0 * t["cin"] * t["cout"] * t["vox"] / 8.0


def tconv_bytes(t) -> float:
    """Its input once, its bf16 weights once, the skip read once, the sum
    written once."""
    return (t["cin"] * t["vox"] / 8.0 + 27.0 * t["cin"] * t["cout"]
            + 2.0 * t["cout"] * t["vox"]) * BF16_BYTES


def gate_plan(spatial, f_maps: int, num_levels: int):
    """The scSE gates in the order they run: ``c``, ``vox``."""
    lv = _levels(spatial, f_maps, num_levels)
    order = list(range(num_levels)) + list(range(num_levels - 2, -1, -1))
    return [dict(c=lv[i][0], vox=lv[i][1]) for i in order]


def gate_flops(g) -> float:
    """The spatial gate's 1x1 conv (2C a voxel) and the two gated products
    (2C); the channel gate's MLP on C values is nought beside them."""
    return 4.0 * g["c"] * g["vox"]


def gate_bytes(g) -> float:
    """The block output read once and the gated output written once."""
    return 2.0 * g["c"] * g["vox"] * BF16_BYTES


def lift_flops(spatial, f_maps: int, num_levels: int) -> float:
    lv = _levels(spatial, f_maps, num_levels)
    cin = [1] + [ch for ch, _ in lv[:-1]]
    return sum(2.0 * ci * ch * vox for ci, (ch, vox) in zip(cin, lv))


def extract_flops(spatial, keypoints, f_maps, num_levels, num_truncated=0) -> float:
    """Useful FLOPs of one keypoint extraction: the 3x3x3 convs, the lifts,
    the transposed convs, the gates, the head and its centre of mass."""
    plan, cin, vox = conv_plan(spatial, f_maps, num_levels, num_truncated)
    return (sum(conv_flops(c) for c in plan) + lift_flops(spatial, f_maps, num_levels)
            + sum(tconv_flops(t) for t in tconv_plan(spatial, f_maps, num_levels))
            + sum(gate_flops(g) for g in gate_plan(spatial, f_maps, num_levels))
            + head_flops(cin, keypoints, vox))


def registration_flops(spatial, keypoints, f_maps, num_levels, num_truncated,
                       transforms) -> float:
    """Useful FLOPs of one served request (``counts.registration_flops``
    with this extractor): both extractions, then per transform its fit,
    flow and warp."""
    n = prod(spatial)
    total = 2.0 * extract_flops(spatial, keypoints, f_maps, num_levels, num_truncated)
    for t in transforms:
        if t.startswith("tps"):
            total += tps_solve_flops(keypoints) + tps_flow_flops(n, keypoints)
        else:
            total += affine_flow_flops(n)
        total += warp_flops(n)
    return total
