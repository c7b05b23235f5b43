"""Keypoint heads and conv building blocks.

Port of ``keymorph_tpu/models/layers.py``: the center-of-mass head, the
linear keypoint regressor, the stateless batch norm, the norm factory and
the ConvNet's block, in 3D and 2D (``dim``). Modules are channel-first
(B, C, *spatial), as the reference's are; the heads take the backbone's
channel-last heatmaps.

A 2D conv or max-pool given a volume (B, C, D, H, W) runs on each of its D
slices, as a flax ``nn.Conv``/``nn.max_pool`` of two window dims treats
every leading axis as a batch axis, while a norm's statistics still span
the whole volume (flax's ``GroupNorm`` reduces over every axis but the
first): keymorph_tpu's register CLI runs its 2D backbones so on the 3D
scans it reads.

The blocks compute in ``dtype`` the way flax does with ``dtype=bf16``: conv
operands rounded to ``dtype`` (products and sums in fp32), normalization
statistics in fp32, every block output stored in ``dtype``. With fp32 they
are plain PyTorch convolutions; on a CUDA device they need TF32 off
(``keymorph_tpu_torch.disable_tf32()``), as keymorph_tpu's fp32 conv is a
full fp32 conv. With float64 every operation is float64 (the tests' oracle
for the fp32 ones).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def center_of_mass(vol: torch.Tensor) -> torch.Tensor:
    """Per-channel center of mass in normalized [-1, 1] coordinates.

    Args:
        vol: (B, *spatial, C) channel-last heatmaps, any float dtype.
    Returns:
        (B, C, d) fp32 coordinates in ``ij`` order (first volume axis
        first; keymorph_tpu's "xy" option is not ported). Along an axis of
        size N the coordinate is taken against ``linspace(0, 1, N)`` and
        mapped by ``* 2 - 1`` (align-corners style, the reference's
        convention).

    The ReLU runs in the input dtype; each marginal mass is a reduction that
    accumulates in fp32 without materializing an fp32 copy of the volume.
    """
    spatial = vol.shape[1:-1]
    d = len(spatial)
    v = torch.relu(vol)
    coords = []
    for k in range(d):
        axes = tuple(i + 1 for i in range(d) if i != k)
        m = torch.sum(v, dim=axes, dtype=torch.float32)  # (B, Nk, C)
        total = m.sum(dim=1) + 1e-8
        line = torch.linspace(0.0, 1.0, spatial[k], dtype=torch.float32,
                              device=vol.device)
        coords.append((m * line[None, :, None]).sum(dim=1) / total)
    return torch.stack(coords, dim=-1) * 2.0 - 1.0


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype products, sums and statistics are taken in: fp32, or
    float64 for a float64 module."""
    return torch.promote_types(dtype, torch.float32)


class LinearRegressor(nn.Module):
    """Global average pool (fp32) -> dense -> ``sigmoid * 2 - 1`` ->
    (B, K, dim) keypoints: keymorph_tpu's ``LinearRegressor`` (the
    reference's, with its undefined ``num_keypoints`` fixed). Takes the
    channel-last heatmaps (B, *spatial, C)."""

    def __init__(self, in_channels: int, num_keypoints: int, dim: int = 3):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.dim = dim
        self.fc = nn.Linear(in_channels, num_keypoints * dim)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.regress(feat.float().mean(dim=tuple(range(1, feat.dim() - 1))))

    def regress(self, pooled: torch.Tensor) -> torch.Tensor:
        """The keypoints (B, K, dim) from the pooled heatmaps (B, C) fp32."""
        out = torch.sigmoid(F.linear(pooled, self.fc.weight.float(), self.fc.bias.float()))
        return (out * 2.0 - 1.0).reshape(-1, self.num_keypoints, self.dim)


class StatelessBatchNorm(nn.Module):
    """Batch normalization over the batch in hand, in training and
    evaluation alike (keymorph_tpu's ``StatelessBatchNorm``, torch's
    ``track_running_stats=False``): per-channel fp32 mean and
    ``E[x^2] - mean^2`` over the batch and spatial axes, eps 1e-5, learned
    scale (``weight``) and bias; the output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(acc_dtype(self.dtype))
        axes = (0,) + tuple(range(2, x.dim()))
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
        inv = torch.rsqrt(var + 1e-5) * self.weight
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((xf - mean.reshape(shape)) * inv.reshape(shape)
                + self.bias.reshape(shape)).to(self.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm (eps 1e-5 unless given) as flax's ``GroupNorm(dtype=...)``
    computes it: per-group fp32 mean and ``max(E[x^2] - mean^2, 0)`` whatever
    the input dtype (so a single voxel a channel normalizes to the bias,
    where ``F.group_norm`` refuses), the output in ``dtype``."""

    def __init__(self, num_groups: int, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__(num_groups, channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xg = x.to(acc_dtype(self.dtype)).reshape(x.shape[0], self.num_groups, -1)
        mean = xg.mean(dim=2, keepdim=True)
        var = ((xg * xg).mean(dim=2, keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (y * self.weight.reshape(shape) + self.bias.reshape(shape)).to(self.dtype)


def norm_layer(norm_type: Optional[str], channels: int, dtype=torch.float32):
    """keymorph_tpu's ``_norm_layer``: ``instance`` is a GroupNorm with one
    channel a group and a learned scale and bias (not ``nn.InstanceNorm3d``,
    which holds no parameters by default), ``batch`` the stateless batch
    norm, ``group`` 8 groups where the channels divide, else 1; ``none``/None
    gives None."""
    if norm_type in (None, "none"):
        return None
    if norm_type == "instance":
        return GroupNorm(channels, channels, dtype)
    if norm_type == "batch":
        return StatelessBatchNorm(channels, dtype)
    if norm_type == "group":
        return GroupNorm(8 if channels % 8 == 0 and channels >= 8 else 1, channels, dtype)
    raise NotImplementedError(f"norm_type={norm_type}")


def per_slice(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` of a channel-first ``dim``-D tensor applied to ``x``
    (B, C, *lead, *spatial): every leading spatial axis is folded into the
    batch, as flax folds the leading axes of a conv's or a pool's input."""
    lead = x.shape[2:x.dim() - dim]
    if not lead:
        return fn(x)
    B, C = x.shape[:2]
    n = len(lead)
    xs = x.movedim(1, n + 1).reshape(-1, C, *x.shape[x.dim() - dim:])
    y = fn(xs)
    return y.reshape(B, *lead, *y.shape[1:]).movedim(n + 1, 1)


_CONVS = {nn.Conv3d: F.conv3d, nn.Conv2d: F.conv2d, nn.ConvTranspose3d: F.conv_transpose3d}


def conv_nd(x: torch.Tensor, conv: nn.Module, dtype: torch.dtype, **kw) -> torch.Tensor:
    """``conv`` (an ``nn.Conv3d``, ``nn.Conv2d`` or ``nn.ConvTranspose3d``,
    its bias included) applied as flax applies a conv of ``dtype``: operands
    rounded to ``dtype`` and multiplied in fp32, the result in ``dtype``. A
    2D conv takes a volume slice by slice (:func:`per_slice`)."""
    if x.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("fp32 convolutions need TF32 off: call "
                           "keymorph_tpu_torch.disable_tf32() first")
    acc = acc_dtype(dtype)
    w = conv.weight.to(dtype).to(acc)
    b = None if conv.bias is None else conv.bias.to(dtype).to(acc)
    fn = _CONVS[type(conv)]
    return per_slice(lambda t: fn(t, w, b, **kw), x.to(dtype).to(acc),
                     w.dim() - 2).to(dtype)


def max_pool(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x max-pool (VALID, floor) over the last ``dim`` axes."""
    pool = F.max_pool2d if dim == 2 else F.max_pool3d
    return per_slice(lambda t: pool(t, 2), x, dim)


class ConvBlock(nn.Module):
    """3^dim conv (with bias) -> norm -> ReLU -> optional 2x max-pool
    (keymorph_tpu's ``ConvBlock``, the reference's ``layers.py`` names
    ``conv`` and ``norm``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 norm_type: str = "instance", down_sample: bool = True,
                 dtype: torch.dtype = torch.float32, dim: int = 3):
        super().__init__()
        conv = nn.Conv2d if dim == 2 else nn.Conv3d
        self.conv = conv(in_channels, out_channels, 3, stride=stride, padding=1)
        self.norm = norm_layer(norm_type, out_channels, dtype)
        self.down_sample = down_sample
        self.dtype = dtype
        self.dim = dim

    def forward(self, x):
        x = conv_nd(x, self.conv, self.dtype, stride=self.conv.stride, padding=1)
        if self.norm is not None:
            x = self.norm(x)
        x = torch.relu(x)
        return max_pool(x, self.dim) if self.down_sample else x
