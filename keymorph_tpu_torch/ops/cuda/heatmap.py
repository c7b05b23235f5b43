"""The heatmaps' kernels: ``final_conv1x1``, the U-Nets' final 1x1 conv that
writes them, and ``heatmap_com``, the per-channel centre of mass of
channel-last heatmaps in one read; each with its plain version.

Both executors (``models/fast_unet.py``, ``models/fast_resunet.py``) take
``final_conv1x1`` where no gradient is needed (serving), and the residual
executor's ``_FinalConv`` takes it for its forward under autograd too. The
kernel (``csrc/heatmap.cu``: ``final1x1_mma_kernel``) computes what the plain
version does, bf16 operands, fp32 products and sums, the fp32 bias, one
rounding, and writes each volume's channel-last heatmaps once, straight into
the tensor the executor returns. Python owns its plan
(:func:`final_conv_plan`: warps a block, warp tiles a block tile, output
channels a launch).

``models/layers.py:center_of_mass`` routes here for a CUDA tensor that needs
no gradient (serving); where one is needed (training) it runs
``center_of_mass_plain``, the differentiable ReLU and marginal sums, as on
the CPU. The kernel (``csrc/heatmap.cu``) reads each voxel's channels once
and keeps four fp32 moments a channel (the mass and its three first moments
against the axes' ``linspace(0, 1, N)``), in place of the plain version's
ReLU copy and its three marginal sums (five passes over the heatmaps).

Python owns the plan (:func:`plan`): the run of x-rows each block of the
first pass reduces, from the item's shape alone, never the batch, so a batch
gives each item the bits it gets alone. CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.cuda.conv3d import _forward_only

MAX_BLOCKS = 1024           # first-pass blocks an item at most
MIN_BLOCK_BYTES = 1 << 20   # heatmap bytes a block reads at least (but for a small item)


# the final conv's tiles (csrc/heatmap.cu's FC_* constants)
FC_VOX = 32            # voxels a warp tile
FC_NCH = 64            # output channels a pass of a warp
FC_SROW = FC_NCH + 8   # bf16 a staged output row
FC_MAX_SMEM = 232448   # shared bytes a block may opt in to (H100)
# (warps a block, warp tiles a block tile), most preferred first: 1024-voxel
# tiles read each channel row in 2-KB runs (2% faster at 256^3 than 256)
FC_SHAPES = ((8, 4), (8, 2), (8, 1), (4, 1), (2, 1), (1, 1))
SLAB_ELEMS = 1 << 26   # elements a slab of the plain final conv's fp32 products holds


def _lib():
    lib = _build.library()
    if lib.km_heatmap_com.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.km_heatmap_com.argtypes = [vp, i, i, vp, vp, vp] + [i] * 8 + [vp]
        lib.km_heatmap_com.restype = ctypes.c_int
        lib.km_final_conv1x1.argtypes = [vp] * 4 + [i, i, ctypes.c_longlong] + [i] * 5 + [vp]
        lib.km_final_conv1x1.restype = ctypes.c_int
    return lib


def z_slabs(Z, per_plane):
    """[(z0, z1)] runs of whole planes of which each holds at most
    SLAB_ELEMS elements at ``per_plane`` a plane (at least one plane)."""
    n = max(1, SLAB_ELEMS // max(1, per_plane))
    return [(z, min(Z, z + n)) for z in range(0, Z, n)]


def final_conv_smem(cin: int, nk: int, warps: int, tpw: int) -> int:
    """Shared bytes of a ``final1x1_mma_kernel`` block (csrc/heatmap.cu's
    ``fc_smem_bytes``) of ``warps`` warps, ``tpw`` warp tiles each a block
    tile: the fp32 bias and bf16 W of ``nk`` output channels padded to
    FC_NCH, W's rows Cin (padded to 16) + 8 long; two block tiles of
    features, rows of the tile's voxels + 8; a staged output block a warp."""
    cinp = -(-cin // 16) * 16
    nkp = -(-nk // FC_NCH) * FC_NCH
    xrow = warps * tpw * FC_VOX + 8
    return nkp * 4 + nkp * (cinp + 8) * 2 + 2 * cinp * xrow * 2 + warps * FC_VOX * FC_SROW * 2


def final_conv_plan(cin: int, k: int):
    """(warps a block, warp tiles a block tile, output channels a launch) of
    the final conv for ``cin`` -> ``k``: the first of FC_SHAPES whose block
    holds W of at least FC_NCH channels, and as many channels a launch as
    then fit, all ``k`` where they do. 32 -> 256 takes 8 warps of 4 tiles
    and one launch in 190,464 bytes (a block an SM); Cin past ~790 fits no
    block (ValueError)."""
    for warps, tpw in FC_SHAPES:
        fixed = final_conv_smem(cin, 0, warps, tpw)
        per = final_conv_smem(cin, FC_NCH, warps, tpw) - fixed
        group = (FC_MAX_SMEM - fixed) // per * FC_NCH
        if group >= FC_NCH:
            return warps, tpw, min(group, k)
    raise ValueError(f"final_conv1x1: {cin} input channels leave no room for a block's "
                     f"weights in {FC_MAX_SMEM} bytes of shared memory")


def final_conv1x1_plain(xf, spatial, weight, bias, out):
    """Plain PyTorch :func:`final_conv1x1`: an fp32 matmul of the bf16
    values plus the fp32 bias, rounded once, in Z-slabs (no fp32 tensor of
    the whole heatmaps). Counted; returns ``out``."""
    final_conv1x1_plain.calls += 1
    Z, _, N = xf.shape
    K = weight.shape[0]
    wf = weight.t().to(torch.bfloat16).float()  # (Cin, K)
    hb = bias.float()
    for z0, z1 in z_slabs(Z, K * N):
        y = torch.matmul(xf[z0:z1].float().transpose(1, 2), wf) + hb
        out[z0:z1] = y.reshape(z1 - z0, *spatial[1:], K).to(torch.bfloat16)
    return out


def final_conv1x1(xf, spatial, weight, bias, out):
    """``out`` (Z, Y, X, K) bf16 <- the final 1x1 conv of flat (Z, Cin, Y*X)
    bf16 ``xf`` with ``weight`` (K, Cin) and ``bias`` (K,):
    ``bf16(sum_c bf16(x) bf16(W) + b)``, fp32 products and sums, the fp32
    bias, one rounding. Forward only; returns ``out``. CPU tensors run the
    plain version; CUDA tensors launch ``final1x1_mma_kernel`` (once for
    32 -> 256; :func:`final_conv_plan`). W and the bias are read in fp32
    (another float type is converted first), W rounded in the kernel."""
    _forward_only("final_conv1x1", xf, weight, bias)
    if xf.device.type == "cpu":
        return final_conv1x1_plain(xf, spatial, weight, bias, out)
    Z, Y, X = (int(s) for s in spatial)
    if (not xf.is_cuda or xf.dtype != torch.bfloat16 or xf.dim() != 3 or not xf.is_contiguous()
            or xf.shape[0] != Z or xf.shape[2] != Y * X or 0 in xf.shape):
        raise ValueError(f"final_conv1x1: want a contiguous non-empty CUDA bf16 (Z, Cin, Y*X) "
                         f"for {tuple(spatial)}, got {xf.device} {xf.dtype} {tuple(xf.shape)}")
    cin = int(xf.shape[1])
    if weight.dim() != 2 or weight.shape[1] != cin or tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"final_conv1x1: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for Cin {cin}")
    K = int(weight.shape[0])
    if (out.dtype != torch.bfloat16 or out.device != xf.device or not out.is_contiguous()
            or tuple(out.shape) != (Z, Y, X, K)):
        raise ValueError(f"final_conv1x1: want out a contiguous bf16 {(Z, Y, X, K)} on "
                         f"{xf.device}, got {out.device} {out.dtype} {tuple(out.shape)}")
    w = weight.to(device=xf.device, dtype=torch.float32).contiguous()
    b = bias.to(device=xf.device, dtype=torch.float32).contiguous()
    warps, tpw, group = final_conv_plan(cin, K)
    lib, stream = _lib(), _build.stream_ptr(xf.device)
    for n0 in range(0, K, group):
        err = lib.km_final_conv1x1(xf.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   Z, cin, Y * X, K, n0, min(group, K - n0), warps, tpw, stream)
        _build.check(err, "km_final_conv1x1")
        final_conv1x1.launches += 1
    return out


def plan(spatial, channels: int, itemsize: int):
    """(x-rows a block, blocks an item) of the first pass for heatmaps of
    ``spatial`` (1 to 3 axes) and ``channels``: the item's Z*Y rows of X
    voxels cut into equal runs, at most MAX_BLOCKS of them and none under
    MIN_BLOCK_BYTES unless the item is smaller. 256 bf16 channels at 256^3
    give 1024 blocks of 64 rows (8 MiB each), at 128^3 1024 of 16 (1 MiB)."""
    Z, Y, X = (1,) * (3 - len(spatial)) + tuple(int(s) for s in spatial)
    rows_total = Z * Y
    row_bytes = X * channels * itemsize
    rows = max(-(-rows_total // MAX_BLOCKS), -(-MIN_BLOCK_BYTES // row_bytes))
    rows = min(rows, rows_total)
    return rows, -(-rows_total // rows)


@functools.lru_cache(maxsize=16)
def _axes_table(sizes, device):
    """The fp32 ``linspace(0, 1, N)`` of each axis, concatenated: the
    weights the plain version takes, from the same PyTorch op."""
    return torch.cat([torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
                      for n in sizes])


def heatmap_com_plain(vol):
    """Plain PyTorch :func:`heatmap_com`: ``center_of_mass_plain``, counted."""
    from keymorph_tpu_torch.models.layers import center_of_mass_plain

    heatmap_com_plain.calls += 1
    return center_of_mass_plain(vol)


def heatmap_com(vol):
    """Per-channel centre of mass, ``ij`` order, of channel-last heatmaps
    ``vol`` (B, *spatial, C) with 1 to 3 spatial axes: (B, C, d) fp32 in
    [-1, 1], the ReLU's NaN propagating and a channel without mass at -1.
    Forward only. CPU tensors run the plain version; CUDA tensors launch
    ``heatmap_moments_kernel`` and ``heatmap_finish_kernel`` on bf16 or fp32
    heatmaps (another float type is read as fp32, which its plain version
    sums in too). Another layout is made contiguous first."""
    _forward_only("heatmap_com", vol)
    if vol.device.type == "cpu":
        return heatmap_com_plain(vol)
    d = vol.dim() - 2
    if not vol.is_cuda or not 1 <= d <= 3 or not vol.is_floating_point() or 0 in vol.shape[1:]:
        raise ValueError(f"heatmap_com: want non-empty CUDA heatmaps (B, *spatial, C) with "
                         f"1 to 3 spatial axes, got {vol.device} {vol.dtype} {tuple(vol.shape)}")
    if vol.dtype not in (torch.bfloat16, torch.float32):
        vol = vol.float()
    vol = vol.contiguous()
    B, *spatial, C = (int(s) for s in vol.shape)
    out = torch.empty((B, C, d), dtype=torch.float32, device=vol.device)
    if B == 0:
        return out
    Z, Y, X = (1,) * (3 - d) + tuple(spatial)
    itemsize = vol.element_size()
    rows, blocks = plan(spatial, C, itemsize)
    vec = vol.data_ptr() % 16 == 0 and C * itemsize % 16 == 0
    table = _axes_table((Z, Y, X), vol.device)
    part = torch.empty((B, blocks, 4, C), dtype=torch.float32, device=vol.device)
    err = _lib().km_heatmap_com(vol.data_ptr(), int(vol.dtype == torch.float32), int(vec),
                                table.data_ptr(), part.data_ptr(), out.data_ptr(),
                                B, Z, Y, X, C, d, rows, blocks, _build.stream_ptr(vol.device))
    _build.check(err, "km_heatmap_com")
    heatmap_com.launches += 1
    return out


heatmap_com.launches = 0
heatmap_com_plain.calls = 0
final_conv1x1.launches = 0
final_conv1x1_plain.calls = 0
