"""Keypoint extraction of a volume split along Z over a 'space' group: the
module path of the DoubleConv 3D U-Nets, with the exchanges that GSPMD
inserts for keymorph_tpu's spatially sharded registration spelled out.

Each rank holds a contiguous slab of Z planes whose boundaries fall on
multiples of 2^(num_levels - 1), so every level's slab is twice the next
one's: the 2x max-pools and the nearest 2x upsampling never reach across a
boundary and stay local. What does reach across:

  * each 3^3 conv needs one plane beyond each face of its slab: the ranks
    all-gather their first and last planes, each takes its neighbours', and
    a rank at a true face of the volume takes zeros (the conv's padding);
  * GroupNorm and the batch norm need their sums and sums of squares over
    the whole volume: all-reduced over the group;
  * the centre of mass needs each axis's marginal mass over the whole
    volume: the Z marginal is all-reduced from each slab's part at its
    global offset, the Y and X marginals from each slab's sums.

Everything else is the modules' own arithmetic (``models/unet.py``,
``models/layers.py``), so on one rank it equals the unsplit module path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from keymorph_tpu_torch.models.layers import acc_dtype, conv_nd, max_pool
from keymorph_tpu_torch.models.unet import AbstractUNet, _activation
from keymorph_tpu_torch.parallel.mesh import all_reduce, gather_cat, group_rank, group_size


def check_backbone(net) -> int:
    """Raise ``ValueError`` unless ``net`` (a ``KeyMorphNet``) has a
    DoubleConv 3D U-Net, the centre-of-mass head and no keypoint weighting;
    return the slab block, 2^(num_levels - 1) planes."""
    bb = net.backbone
    if not (isinstance(bb, AbstractUNet) and bb.basic_module == "double" and bb.dim == 3):
        raise ValueError(f"the spatial path runs the DoubleConv 3D U-Nets (UNet3D, "
                         f"TruncatedUNet3D), not {type(bb).__name__} (ROADMAP Queue C)")
    if net.keypoint_layer != "com" or net.weight_keypoints is not None:
        raise ValueError("the spatial path takes the centre-of-mass head without keypoint "
                         "weighting (ROADMAP Queue C)")
    return 2 ** (len(bb.f_maps) - 1)


def _with_halo(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (B, C, z, H, W) with its Z neighbours' facing planes around it
    (zeros at the volume's faces): (B, C, z + 2, H, W)."""
    n, r = group_size(group), group_rank(group)
    ends = torch.stack([x[:, :, :1], x[:, :, -1:]]).float()  # exact for bf16
    ends = gather_cat(ends[None], group).to(x.dtype)  # (n, 2, B, C, 1, H, W)
    zero = torch.zeros_like(x[:, :, :1])
    lo = ends[r - 1, 1] if r > 0 else zero
    hi = ends[r + 1, 0] if r < n - 1 else zero
    return torch.cat([lo, x, hi], dim=2)


def _norm(module, x: torch.Tensor, group, channel_groups: int) -> torch.Tensor:
    """GroupNorm (``channel_groups`` groups, clamped variance) or the
    stateless batch norm (``channel_groups`` 0: per channel over the batch)
    of a slab, with the statistics of the whole volume."""
    acc = acc_dtype(module.dtype)
    xf = x.to(acc)
    if channel_groups:
        xs = xf.reshape(x.shape[0], channel_groups, -1)
        dims, keep = (2,), True
    else:
        xs = xf.movedim(1, 0).reshape(x.shape[1], -1)
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


def _single_conv(m, x: torch.Tensor, group) -> torch.Tensor:
    for ch in m.order:
        if ch == "c":
            x = conv_nd(_with_halo(x, group), m.conv, m.dtype, padding=(0, 1, 1))
        elif ch == "g":
            x = _norm(m.groupnorm, x, group, m.groupnorm.num_groups)
        elif ch == "b":
            x = _norm(m.batchnorm, x, group, 0)
        else:
            x = _activation(ch, x)
    return x


def _double_conv(block, x: torch.Tensor, group) -> torch.Tensor:
    return _single_conv(block.SingleConv2, _single_conv(block.SingleConv1, x, group), group)


def features(backbone: AbstractUNet, x: torch.Tensor, group) -> torch.Tensor:
    """The U-Net's heatmaps of a Z slab (B, 1, z, H, W) -> (B, z', H', W', K),
    channel-last, in the backbone's dtype (``AbstractUNet.forward`` with the
    exchanges of the module docstring)."""
    x = x.to(backbone.dtype)
    skips = []
    for enc in backbone.encoders:
        x = _double_conv(enc.basic_module, max_pool(x, 3) if enc.pool else x, group)
        skips.append(x)
    for dec, skip in zip(backbone.decoders, skips[:-1][::-1]):
        x = F.interpolate(x, size=skip.shape[2:], mode="nearest")
        x = _double_conv(dec.basic_module, torch.cat([skip, x], dim=1), group)
    return backbone.head(x).movedim(1, -1)


def center_of_mass(feat: torch.Tensor, z0: int, depth: int, group) -> torch.Tensor:
    """``models.layers.center_of_mass`` of the whole volume from a slab of
    its heatmaps (B, z, H, W, C) that begins at plane ``z0`` of ``depth``."""
    B, z, H, W, C = feat.shape
    v = torch.relu(feat)
    m_z = torch.zeros((B, depth, C), dtype=torch.float32, device=feat.device)
    m_z[:, z0: z0 + z] = torch.sum(v, dim=(2, 3), dtype=torch.float32)
    m_y = torch.sum(v, dim=(1, 3), dtype=torch.float32)
    m_x = torch.sum(v, dim=(1, 2), dtype=torch.float32)
    marginals = all_reduce(torch.cat([m_z, m_y, m_x], dim=1), group).split([depth, H, W], 1)
    coords = []
    for m, n in zip(marginals, (depth, H, W)):
        total = m.sum(dim=1) + 1e-8
        line = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=feat.device)
        coords.append((m * line[None, :, None]).sum(dim=1) / total)
    return torch.stack(coords, dim=-1) * 2.0 - 1.0


def keypoints(backbone: AbstractUNet, x: torch.Tensor, z0: int, depth: int,
              group) -> torch.Tensor:
    """(B, K, 3) keypoints of a volume of ``depth`` Z planes from its slab
    ``x`` (B, 1, z, H, W) that begins at plane ``z0``; the same on every rank
    of ``group``."""
    feat = features(backbone, x, group)
    scale = x.shape[2] // feat.shape[1]  # 2^num_truncated_layers
    return center_of_mass(feat, z0 // scale, depth // scale, group)
