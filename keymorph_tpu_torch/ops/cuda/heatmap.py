"""The keypoint head's kernel: ``heatmap_com``, the per-channel centre of mass
of channel-last heatmaps in one read, and its plain version.

``models/layers.py:center_of_mass`` routes here for a CUDA tensor that needs
no gradient (serving); where one is needed (training) it runs
``center_of_mass_plain``, the differentiable ReLU and marginal sums, as on
the CPU. The kernel (``csrc/heatmap.cu``) reads each voxel's channels once
and keeps four fp32 moments a channel (the mass and its three first moments
against the axes' ``linspace(0, 1, N)``), in place of the plain version's
ReLU copy and its three marginal sums (five passes over the heatmaps).

Python owns the plan (:func:`plan`): the run of x-rows each block of the
first pass reduces, from the item's shape alone, never the batch, so a batch
gives each item the bits it gets alone. CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.cuda.conv3d import _forward_only

MAX_BLOCKS = 1024           # first-pass blocks an item at most
MIN_BLOCK_BYTES = 1 << 20   # heatmap bytes a block reads at least (but for a small item)


def _lib():
    lib = _build.library()
    if lib.km_heatmap_com.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.km_heatmap_com.argtypes = [vp, i, i, vp, vp, vp] + [i] * 8 + [vp]
        lib.km_heatmap_com.restype = ctypes.c_int
    return lib


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
