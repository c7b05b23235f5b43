"""Keypoint extraction of a volume split along Z over a 'space' group: the
module path of every backbone and keypoint head, with the exchanges that
GSPMD inserts for keymorph_tpu's spatially sharded registration spelled out.
A 2D image (B, C, H, W) is split along H, its first spatial axis, as
keymorph_tpu splits it; "plane" below is then a row.

Each rank holds a contiguous slab of Z planes. The slab boundaries fall on
multiples of the backbone's block (2^(num_levels - 1) for a U-Net, 16 for
the ConvNet's four pools), and the slab at the volume's far face takes the
remainder below a block, so at every pooling level l an inner boundary b
lies at b / 2^l and the far face at floor(D / 2^l): each 2x max-pool stays
local and floors at the far face as the unsplit pool does. A rank whose slab
is empty at some level (fewer blocks than ranks, or the remainder slab at a
deep level) holds empty tensors there and still joins every collective.
What reaches across a slab face:

  * each 3^3 conv needs one plane beyond each face of its slab: the ranks
    all-gather their first and last planes, each takes the last plane of
    the nearest rank below that holds one and the first plane of the nearest
    rank above, and zeros at a true face of the volume (the conv's padding);
  * the DoubleConv decoders' nearest upsampling takes plane floor(i s / t)
    of the deeper level's s for plane i of the skip's t (PyTorch's index
    rule, F.interpolate's own): where t is 2s that is local, where t is 2s + 1
    (a Z extent that is not a multiple of the block) plane i may need the
    plane just below the slab, which the conv's exchange already brings;
  * the residual decoders' stride-2 transposed conv (padding 1, output
    padding 1) needs the deeper input's next plane beyond the slab's upper
    face, and crops to the skip's extent as the unsplit module does;
  * GroupNorm (instance norm is a GroupNorm of one channel a group) and the
    batch norm need their sums and sums of squares over the whole volume,
    the channel squeeze-and-excitation gate and the linear head a spatial
    mean: sums all-reduced over the group;
  * the centre of mass needs each axis's marginal mass over the whole
    volume: the Z marginal is all-reduced from each slab's part at its
    global offset, the Y and X marginals from each slab's sums;
  * keypoint weighting needs each heatmap's mass (``power``) or its mean and
    variance (``variance``, two passes: the mean, then the squared
    deviations from it): all-reduced sums.

Everything else is the modules' own arithmetic (``models/unet.py``,
``models/convnet.py``, ``models/layers.py``, ``models/keymorph.py``), so on
one rank it equals the unsplit module path.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from keymorph_tpu_torch.models.convnet import ConvNet
from keymorph_tpu_torch.models.layers import GroupNorm, acc_dtype, conv_nd, max_pool
from keymorph_tpu_torch.models.unet import AbstractUNet, _activation
from keymorph_tpu_torch.parallel.mesh import (
    all_reduce,
    gather_cat,
    group_rank,
    group_size,
    split_sizes,
)


def block(net) -> int:
    """The planes a slab boundary must be a multiple of for ``net``'s (a
    ``KeyMorphNet``'s) backbone: 2^(num_levels - 1) for a U-Net, 16 for the
    ConvNet (3D or 2D). Raises ``ValueError`` for any other module."""
    bb = net.backbone
    if isinstance(bb, AbstractUNet):
        return 2 ** (len(bb.f_maps) - 1)
    if isinstance(bb, ConvNet):
        return 16
    raise ValueError(f"the spatial path runs the U-Nets and the ConvNet, not "
                     f"{type(bb).__name__}")


class Slabs:
    """Where each rank of ``group`` holds its Z planes at every pooling
    level of a volume of ``depth`` planes split by ``block``."""

    def __init__(self, depth: int, block_: int, group):
        self.group = group
        self.depth0 = depth
        self.rank = group_rank(group)
        sizes = split_sizes(depth, group_size(group), block_, empty_ok=True)
        self.bounds = [sum(sizes[:i]) for i in range(len(sizes) + 1)]

    def depth(self, level: int) -> int:
        return self.depth0 >> level

    def all(self, level: int) -> List[tuple]:
        """Every rank's [z0, z1) at ``level``: inner boundaries b / 2^level,
        the far face floor(depth / 2^level)."""
        b = [z >> level for z in self.bounds[:-1]] + [self.depth(level)]
        return [(min(b[i], b[-1]), min(b[i + 1], b[-1])) for i in range(len(b) - 1)]

    def local(self, level: int) -> tuple:
        return self.all(level)[self.rank]


def _empty(x: torch.Tensor, channels: int, spatial, dtype) -> torch.Tensor:
    return x.new_zeros((x.shape[0], channels, 0, *spatial), dtype=dtype)


def _with_halo(x: torch.Tensor, slabs: Slabs, level: int) -> torch.Tensor:
    """``x`` (B, C, z, H, W) or (B, C, z, W), this rank's slab at ``level``,
    with the planes just beyond its faces around it: global planes z0 - 1
    and z1 (zeros outside the volume), (B, C, z + 2, ...). Every rank of the
    group calls it, an empty slab too."""
    spans = slabs.all(level)
    r = slabs.rank
    zero = x.new_zeros((*x.shape[:2], 1, *x.shape[3:]))
    ends = (torch.stack([x[:, :, :1], x[:, :, -1:]]) if x.shape[2] else
            torch.stack([zero, zero])).to(acc_dtype(x.dtype))  # exact for bf16
    ends = gather_cat(ends[None], slabs.group).to(x.dtype)  # (n, 2, B, C, 1, H, W)
    below = [k for k in range(r) if spans[k][1] > spans[k][0]]
    above = [k for k in range(r + 1, len(spans)) if spans[k][1] > spans[k][0]]
    lo = ends[below[-1], 1] if below else zero
    hi = ends[above[0], 0] if above else zero
    return torch.cat([lo, x, hi], dim=2)


def _conv3(x: torch.Tensor, conv: nn.Module, dtype, slabs: Slabs, level: int) -> torch.Tensor:
    """A 3^d conv (stride 1, padding 1) of a slab."""
    xh = _with_halo(x, slabs, level)
    if not x.shape[2]:
        return _empty(x, conv.out_channels, x.shape[3:], dtype)
    return conv_nd(xh, conv, dtype, padding=(0,) + (1,) * (x.dim() - 3))


def _pointwise(x: torch.Tensor, conv: nn.Module, dtype) -> torch.Tensor:
    """A 1^d conv of a slab (local)."""
    if not x.shape[2]:
        return _empty(x, conv.out_channels, x.shape[3:], dtype)
    return conv_nd(x, conv, dtype)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """The 2x max-pool (floor) of a slab whose first plane is even."""
    if x.shape[2] < 2:
        return _empty(x, x.shape[1], [s // 2 for s in x.shape[3:]], x.dtype)
    return max_pool(x, x.dim() - 2)


def _norm(module, x: torch.Tensor, group) -> torch.Tensor:
    """A GroupNorm (clamped variance; instance norm is one channel a group)
    or the stateless batch norm (per channel over the batch) of a slab, with
    the statistics of the whole volume."""
    channel_groups = module.num_groups if isinstance(module, GroupNorm) else 0
    acc = acc_dtype(module.dtype)
    xf = x.to(acc)
    B, C = x.shape[:2]
    per = x[0, 0].numel()
    if channel_groups:
        xs = xf.reshape(B, channel_groups, C // channel_groups * per)
        dims, keep = (2,), True
    else:
        xs = xf.movedim(1, 0).reshape(C, B * per)
        dims, keep = (1,), False
    s1, s2 = xs.sum(dim=dims, keepdim=keep), (xs * xs).sum(dim=dims, keepdim=keep)
    count = torch.full((1,), float(xs.shape[dims[0]]), dtype=acc, device=x.device)
    stats = all_reduce(torch.cat([s1.reshape(-1), s2.reshape(-1), count]), group)
    k = s1.numel()
    mean = stats[:k].reshape(s1.shape) / stats[-1]
    var = stats[k: 2 * k].reshape(s1.shape) / stats[-1] - mean * mean
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if channel_groups:
        y = ((xs - mean) * torch.rsqrt(var.clamp_min(0.0) + module.eps)).reshape(x.shape)
        return (y * module.weight.reshape(shape) + module.bias.reshape(shape)).to(module.dtype)
    inv = torch.rsqrt(var + 1e-5) * module.weight
    return ((xf - mean.reshape(shape)) * inv.reshape(shape)
            + module.bias.reshape(shape)).to(module.dtype)


def _mean(x: torch.Tensor, dims, group, count: int) -> torch.Tensor:
    """The mean over ``dims`` of the whole volume, ``count`` values, from a
    slab: its fp32 (or float64) sums all-reduced."""
    return all_reduce(x.to(acc_dtype(x.dtype)).sum(dim=dims), group) / count


def _single_conv(m, x: torch.Tensor, slabs: Slabs, level: int) -> torch.Tensor:
    for ch in m.order:
        if ch == "c":
            x = _conv3(x, m.conv, m.dtype, slabs, level)
        elif ch == "g":
            x = _norm(m.groupnorm, x, slabs.group)
        elif ch == "b":
            x = _norm(m.batchnorm, x, slabs.group)
        else:
            x = _activation(ch, x)
    return x


def _double_conv(blk, x: torch.Tensor, slabs: Slabs, level: int) -> torch.Tensor:
    x = _single_conv(blk.SingleConv1, x, slabs, level)
    return _single_conv(blk.SingleConv2, x, slabs, level)


def _resnet_block(blk, x: torch.Tensor, slabs: Slabs, level: int) -> torch.Tensor:
    """``ResNetBlock.forward`` of a slab: the 1^3 lift, two SingleConvs, the
    residual sum and the activation, then the scSE gate (the channel gate's
    spatial mean all-reduced, the spatial gate pointwise)."""
    residual = (_pointwise(x, blk.conv1, blk.dtype) if isinstance(blk.conv1, nn.Conv3d)
                else x)
    out = _single_conv(blk.conv3, _single_conv(blk.conv2, residual, slabs, level), slabs, level)
    out = _activation(blk.act, out + residual)
    if blk.se_module is None:
        return out
    cse, sse = blk.se_module.cSE, blk.se_module.sSE
    count = slabs.depth(level) * math.prod(out.shape[3:])
    s = _mean(out, (2, 3, 4), slabs.group, count)
    s = cse.gate(s)
    gate_c = out * s.reshape(*s.shape, 1, 1, 1)
    gate_s = out * torch.sigmoid(_pointwise(out, sse.conv, sse.dtype))
    return torch.maximum(gate_c, gate_s)


def _upsample_nearest(x: torch.Tensor, skip: torch.Tensor, slabs: Slabs,
                      level: int) -> torch.Tensor:
    """``F.interpolate(x, size=skip's, mode="nearest")`` of the slab ``x``
    at ``level`` to the skip's slab at ``level - 1``."""
    s, t = slabs.depth(level), slabs.depth(level - 1)
    xh = _with_halo(x, slabs, level)  # global planes [c0 - 1, c1]
    c0 = slabs.local(level)[0]
    f0, f1 = slabs.local(level - 1)
    # PyTorch's nearest index along Z, as the unsplit interpolate takes it
    idx = F.interpolate(torch.arange(s, dtype=torch.float32).reshape(1, 1, s),
                        size=t, mode="nearest").flatten()[f0:f1].long() - (c0 - 1)
    if f1 == f0:
        return _empty(x, x.shape[1], skip.shape[3:], x.dtype)
    if idx.min() < 0 or idx.max() >= xh.shape[2]:
        raise RuntimeError(f"nearest upsampling {s} -> {t}: planes {f0}-{f1} need more than "
                           f"one plane beyond the slab")
    xz = xh.index_select(2, idx.to(x.device))
    return F.interpolate(xz, size=skip.shape[2:], mode="nearest")


def _transpose_upsample(up, skip: torch.Tensor, x: torch.Tensor, slabs: Slabs,
                        level: int) -> torch.Tensor:
    """``TransposeConvUpsampling.forward`` of the slab ``x`` at ``level``
    joined to the skip's slab at ``level - 1``: the stride-2 transposed conv
    (padding 1, output padding 1) over the slab and the deeper input's next
    plane, cropped to the skip, summed with it."""
    s, t = slabs.depth(level), slabs.depth(level - 1)
    if 2 * s < t or any(2 * a < b for a, b in zip(x.shape[3:], skip.shape[3:])):
        raise ValueError(f"residual decoder: the upsampled {(2 * s, *(2 * a for a in x.shape[3:]))}"
                         f" cannot join the skip {(t, *skip.shape[3:])} (odd skip sizes are not "
                         "supported, as in keymorph_tpu)")
    xh = _with_halo(x, slabs, level)[:, :, 1:]  # the slab and global plane c1
    y = conv_nd(xh, up.upsample, up.dtype, stride=2, padding=1, output_padding=(0, 1, 1))
    y = y[:, :, : skip.shape[2], : skip.shape[3], : skip.shape[4]]
    return skip + y


def _unet_features(bb: AbstractUNet, x: torch.Tensor, slabs: Slabs):
    """(heatmaps slab (B, K, z', H', W'), its level)."""
    run = _double_conv if bb.basic_module == "double" else _resnet_block
    skips = []
    level = 0
    for enc in bb.encoders:
        if enc.pool:
            x, level = _pool(x), level + 1
        x = run(enc.basic_module, x, slabs, level)
        skips.append(x)
    for dec, skip in zip(bb.decoders, skips[:-1][::-1]):
        if dec.upsampling is not None:
            x = _transpose_upsample(dec.upsampling, skip, x, slabs, level)
        else:
            x = torch.cat([skip, _upsample_nearest(x, skip, slabs, level)], dim=1)
        level -= 1
        x = run(dec.basic_module, x, slabs, level)
    if not x.shape[2]:
        return _empty(x, bb.final_conv.out_channels, x.shape[3:], bb.dtype), level
    return bb.head(x), level


def _convnet_features(net: ConvNet, x: torch.Tensor, slabs: Slabs):
    """(heatmaps slab, its level) of the ConvNet: each ``ConvBlock`` is its
    3^3 conv (stride 1: the ConvNet builds no other), its norm, ReLU and the
    optional pool."""
    level = 0
    for blk in net.children():
        x = _conv3(x, blk.conv, blk.dtype, slabs, level)
        if blk.norm is not None:
            x = _norm(blk.norm, x, slabs.group)
        x = torch.relu(x)
        if blk.down_sample:
            x, level = _pool(x), level + 1
    return x, level


def features(backbone: nn.Module, x: torch.Tensor, slabs: Slabs):
    """The backbone's heatmaps of this rank's slab ``x`` (B, 1, z, H, W) or
    (B, 1, z, W) at level 0: (B, z', ..., K) channel-last in the backbone's
    dtype, and the pooling level they lie at."""
    x = x.to(backbone.dtype)
    if isinstance(backbone, ConvNet):
        feat, level = _convnet_features(backbone, x, slabs)
    else:
        feat, level = _unet_features(backbone, x, slabs)
    return feat.movedim(1, -1), level


def center_of_mass(feat: torch.Tensor, z0: int, depth: int, group) -> torch.Tensor:
    """``models.layers.center_of_mass`` of the whole volume from a slab of
    its heatmaps (B, z, H, W, C) or (B, z, W, C) that begins at plane ``z0``
    of ``depth``."""
    B, z, *rest, C = feat.shape
    axes = range(1, feat.dim() - 1)
    v = torch.relu(feat)
    m_z = torch.zeros((B, depth, C), dtype=torch.float32, device=feat.device)
    m_z[:, z0: z0 + z] = torch.sum(v, dim=tuple(axes[1:]), dtype=torch.float32)
    m_rest = [torch.sum(v, dim=tuple(a for a in axes if a != k), dtype=torch.float32)
              for k in axes[1:]]
    sizes = [depth, *rest]
    marginals = all_reduce(torch.cat([m_z, *m_rest], dim=1), group).split(sizes, 1)
    coords = []
    for m, n in zip(marginals, sizes):
        total = m.sum(dim=1) + 1e-8
        line = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=feat.device)
        coords.append((m * line[None, :, None]).sum(dim=1) / total)
    return torch.stack(coords, dim=-1) * 2.0 - 1.0


def _weights(net, feats, slabs: Slabs, level: int):
    """``KeyMorphNet.weight_by_power`` / ``weight_by_variance`` of the
    fixed and moving heatmaps' slabs, or None."""
    if net.weight_keypoints is None:
        return None
    axes = tuple(range(1, feats[0].dim() - 1))
    if net.weight_keypoints == "power":
        p1, p2 = (all_reduce(torch.sum(torch.relu(f), dim=axes, dtype=torch.float32),
                             slabs.group) for f in feats)
        w = p1 * p2
        return w / w.sum(dim=-1, keepdim=True)
    count = slabs.depth(level) * math.prod(feats[0].shape[2:-1])
    var = []
    for a in (torch.relu(f.float()) for f in feats):
        mean = _mean(a, axes, slabs.group, count)
        var.append(_mean((a - mean.reshape(mean.shape[0], *[1] * len(axes), -1)) ** 2, axes,
                         slabs.group, count))
    return net.weights_from_variances(*var)


def pair(net, img_f: torch.Tensor, img_m: torch.Tensor, slabs: Slabs):
    """``KeyMorphNet.forward`` of a pair from this rank's slabs (B, 1, z,
    ...) of the fixed and moving volumes or images: (points_f, points_m,
    weights or None), the same on every rank of the group."""
    feats, points = [], []
    for img in (img_f, img_m):
        feat, level = features(net.backbone, img, slabs)
        if net.keypoint_layer == "com":
            p = center_of_mass(feat, slabs.local(level)[0], slabs.depth(level), slabs.group)
        else:
            count = slabs.depth(level) * math.prod(feat.shape[2:-1])
            p = net.regressor.regress(_mean(feat.float(), tuple(range(1, feat.dim() - 1)),
                                            slabs.group, count))
        feats.append(feat)
        points.append(p)
    return points[0], points[1], _weights(net, feats, slabs, level)
