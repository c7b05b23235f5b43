"""Analytic FLOP and byte counts of the registration stages, and the H100
roofline. Port of ``keymorph_tpu/tools/flops.py``: the same formulas.

The counts are *useful-math* FLOPs from the architecture (the numbers a
hand count of the math requires, not the raw multiplies a kernel executes),
so MFU against them is conservative.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense), the figures
``chip_smoke.py`` bounds its kernels by: 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s of HBM. They assume the card's full 700 W power limit.
"""

from __future__ import annotations

from math import prod

H100_BF16_PEAK_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def _number_of_features_per_level(f_maps: int, num_levels: int):
    return [f_maps * 2**k for k in range(num_levels)]


def unet_extract_flops(spatial, out_channels: int, f_maps: int = 32, num_levels: int = 4,
                       num_truncated_layers: int = 0, in_channels: int = 1) -> float:
    """FLOPs of ONE keypoint extraction (AbstractUNet 'double' topology +
    PointwiseConv head + center-of-mass), mirroring models/unet.py's channel
    plan: encoder DoubleConv mid = max(out//2, in), decoder mid = out,
    MaxPool(2) before every encoder but the first, nearest-upsample+concat
    decoders, truncation dropping the last decoders."""
    fm = _number_of_features_per_level(f_maps, num_levels)
    total = 0.0

    def conv3(cin, cout, vox):
        return 2.0 * 27.0 * cin * cout * vox

    # encoders
    vox = prod(spatial)
    cin = in_channels
    for i, ch in enumerate(fm):
        if i > 0:
            vox //= 8  # MaxPool(2) in 3D
        mid = max(ch // 2, cin)
        total += conv3(cin, mid, vox) + conv3(mid, ch, vox)
        cin = ch
    # decoders
    rev = list(reversed(fm))
    num_dec = len(rev) - 1 - num_truncated_layers
    for i in range(num_dec):
        vox *= 8  # upsample back to the skip's level
        cat = rev[i + 1] + cin  # skip channels + upsampled channels
        out = rev[i + 1]
        total += conv3(cat, out, vox) + conv3(out, out, vox)
        cin = out
    # 1x1 head + center-of-mass marginal reductions
    total += 2.0 * cin * out_channels * vox
    total += 2.0 * out_channels * vox
    return total


def tps_flow_flops(n_grid: int, n_ctrl: int) -> float:
    """Useful FLOPs of evaluating the fitted TPS at n_grid points with
    n_ctrl RBF centers: squared distance (3 sub + 3 mul + 2 add = 8) +
    U(r) = r^2 log(r+eps) (~4) + weight contraction (2*3) per center, plus
    the affine part (~24 per point)."""
    return float(n_grid) * (n_ctrl * (8.0 + 4.0 + 6.0) + 24.0)


def tps_solve_flops(n_ctrl: int) -> float:
    """Dense (T+4)^3-scale solve; tiny next to the flow (LU ~ 2/3 M^3 +
    2 M^2 rhs, M = T+4, 3 rhs dims)."""
    m = n_ctrl + 4
    return (2.0 / 3.0) * m**3 + 2.0 * m**2 * 3


def warp_flops(n_out: int, channels: int = 1) -> float:
    """Useful FLOPs of a trilinear warp: 8 corner weights (~24 flops of hat
    products per point) + per channel the 8-corner weighted sum (15)."""
    return float(n_out) * (24.0 + 15.0 * channels)


def warp_bytes(n_out: int, channels: int = 1, in_bytes: int = 2, out_bytes: int = 4,
               planes_bytes: int = 4) -> float:
    """Device-memory traffic lower bound for the warp: each source voxel
    read once, each output voxel written once, the three coordinate planes
    read once."""
    return float(n_out) * (channels * (in_bytes + out_bytes) + 3.0 * planes_bytes)


def mfu(flops: float, seconds: float, peak: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilization against the bf16 tensor-core peak."""
    return flops / seconds / peak
