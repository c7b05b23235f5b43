"""Operation and byte counts of the registration's stages, and the H100's peaks.

The formulas of the port's ``tools/flops.py`` (useful operations from the
architecture, not what a kernel executes), copied here so that the
yardstick stays fixed while the program changes, plus the per-call
roofline bounds of the 3x3x3 convolutions.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at the full
700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.
A run reports the card's power limit beside every share of them.
"""

from __future__ import annotations

from math import prod

H100_BF16_PEAK_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
FP32_BYTES = 4


def unet_levels(f_maps: int, num_levels: int):
    return [f_maps * 2 ** k for k in range(num_levels)]


def conv_plan(spatial, f_maps: int, num_levels: int, num_truncated: int, in_channels: int = 1):
    """The 3x3x3 convolutions of one pass of a DoubleConv U-Net over a
    volume of ``spatial``, in the order they run: dicts with ``name``,
    ``cin`` (the channels the conv reads), ``cout``, ``vox`` (output
    voxels), ``lowres`` (channels of the input read at half resolution: a
    decoder's upsampled part) and ``cin_read_full`` (channels read at full
    resolution). Encoder conv 1 is ``max(out // 2, in)`` wide; decoders
    read ``[skip, up2(deeper)]``; a 2x max-pool precedes every encoder but
    the first."""
    fm = unet_levels(f_maps, num_levels)
    vox = prod(spatial)
    plan = []
    cin = in_channels
    for i, ch in enumerate(fm):
        if i > 0:
            vox //= 8
        mid = max(ch // 2, cin)
        plan.append(dict(name=f"e{i}c1", cin=cin, cout=mid, vox=vox, lowres=0))
        plan.append(dict(name=f"e{i}c2", cin=mid, cout=ch, vox=vox, lowres=0))
        cin = ch
    rev = fm[::-1]
    for j in range(len(rev) - 1 - num_truncated):
        vox *= 8
        out = rev[j + 1]
        plan.append(dict(name=f"d{j}c1", cin=out + cin, cout=out, vox=vox, lowres=cin))
        plan.append(dict(name=f"d{j}c2", cin=out, cout=out, vox=vox, lowres=0))
        cin = out
    return plan, cin, vox


def conv_flops(c) -> float:
    return 2.0 * 27.0 * c["cin"] * c["cout"] * c["vox"]


def conv_bytes(c) -> float:
    """Least traffic of one forward conv: its input read once (the
    upsampled part at half resolution), its bf16 weights once, its bf16
    output written once."""
    full = c["cin"] - c["lowres"]
    inp = (full * c["vox"] + c["lowres"] * c["vox"] / 8.0) * BF16_BYTES
    return inp + 27.0 * c["cin"] * c["cout"] * BF16_BYTES + c["cout"] * c["vox"] * BF16_BYTES


def conv_input_grad_bytes(c) -> float:
    """Least traffic of one input gradient: the bf16 cotangent of the
    output read once, the weights once, the bf16 input gradient written
    once at the input's resolution."""
    return (c["cout"] * c["vox"] + 27.0 * c["cin"] * c["cout"]
            + c["cin"] * c["vox"]) * BF16_BYTES


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the bf16 peak
    or bytes over the HBM rate, whichever is longer."""
    return max(flops / H100_BF16_PEAK_FLOPS, nbytes / H100_HBM_BYTES_PER_S)


def head_flops(cin: int, keypoints: int, vox: int) -> float:
    """The 1x1 head and the centre-of-mass marginals."""
    return 2.0 * cin * keypoints * vox + 2.0 * keypoints * vox


def extract_flops(spatial, keypoints, f_maps, num_levels, num_truncated) -> float:
    """Useful FLOPs of one keypoint extraction (the port's
    ``unet_extract_flops``)."""
    plan, cin, vox = conv_plan(spatial, f_maps, num_levels, num_truncated)
    return sum(conv_flops(c) for c in plan) + head_flops(cin, keypoints, vox)


def tps_flow_flops(n_grid: int, n_ctrl: int) -> float:
    """The fitted spline at ``n_grid`` points with ``n_ctrl`` centres:
    distance (8), U(r) (~4) and the weight contraction (6) a centre, plus
    the affine part (~24) a point."""
    return float(n_grid) * (n_ctrl * (8.0 + 4.0 + 6.0) + 24.0)


def tps_solve_flops(n_ctrl: int) -> float:
    """LU of the (T+4)^2 system with 3 right-hand sides."""
    m = n_ctrl + 4
    return (2.0 / 3.0) * m ** 3 + 2.0 * m ** 2 * 3


def affine_flow_flops(n_grid: int) -> float:
    """A 3x4 matrix at every grid point."""
    return 18.0 * n_grid


def warp_flops(n_out: int, channels: int = 1) -> float:
    """Trilinear: the corner weights (~24) a point, the 8-corner sum (15)
    a channel."""
    return float(n_out) * (24.0 + 15.0 * channels)


def registration_flops(spatial, keypoints, f_maps, num_levels, num_truncated,
                       transforms) -> float:
    """Useful FLOPs of one served request: both extractions, then per
    transform its fit, flow and warp (affine and rigid: the fit is a few
    hundred operations, counted as nought)."""
    n = prod(spatial)
    total = 2.0 * extract_flops(spatial, keypoints, f_maps, num_levels, num_truncated)
    for t in transforms:
        if t.startswith("tps"):
            total += tps_solve_flops(keypoints) + tps_flow_flops(n, keypoints)
        else:
            total += affine_flow_flops(n)
        total += warp_flops(n)
    return total


def train_step_flops(spatial, keypoints, f_maps, num_levels, num_truncated,
                     train_keypoints) -> float:
    """Useful FLOPs of one training step (no recomputation): the forward
    of both extractions, their backward (weight gradient of every conv and
    of the head, input gradient of all but the first conv), the fit, the
    spline forward and its gradient (twice the forward), the warp and its
    gradient to the planes (twice the forward). The augmentation warp is
    one trilinear warp more."""
    plan, cin, vox = conv_plan(spatial, f_maps, num_levels, num_truncated)
    conv = sum(conv_flops(c) for c in plan)
    head = head_flops(cin, keypoints, vox)
    fwd_extract = conv + head
    bwd_extract = 2.0 * conv - conv_flops(plan[0]) + 2.0 * head
    n = prod(spatial)
    geo = (tps_solve_flops(train_keypoints) + 3.0 * tps_flow_flops(n, train_keypoints)
           + 3.0 * warp_flops(n) + warp_flops(n))
    return 2.0 * (fwd_extract + bwd_extract) + geo
