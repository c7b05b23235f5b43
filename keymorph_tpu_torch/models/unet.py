"""DoubleConv U-Net backbones as plain ``nn.Module``s (the oracle).

Port of ``keymorph_tpu/models/unet.py`` for ``basic_module="double"`` and
``layer_order="gcr"`` (GroupNorm -> Conv(no bias) -> ReLU), channel-first
(B, C, Z, Y, X):

  * f_maps ladder ``[f * 2**k]``; encoder conv-1 width ``max(out // 2, in)``;
  * GroupNorm eps 1e-5, one group below ``num_groups`` channels;
  * 2x max-pool before every encoder but the first; nearest 2x upsample and
    ``[skip, x]`` concat in the decoders; ``TruncatedUNet3D`` drops the last
    ``num_truncated_layers`` decoders;
  * a final 1x1 conv with bias.

Parameter names are the reference unet3d ``state_dict`` keys
(``encoders.i.basic_module.SingleConv{1,2}.{groupnorm,conv}.*``,
``decoders.j...``, ``final_conv.*``), so weights move between this module,
the kernel executor (``models/fast_unet.py``) and keymorph_tpu's flax tree
(``tools/import_flax_params.py``).

With ``dtype=torch.bfloat16`` the module emulates the flax bf16 backbone:
GroupNorm statistics in fp32, conv operands rounded to bf16 with fp32
accumulation, activations stored in bf16. It is the straightforward
reference for the executor, not the fast path.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def number_of_features_per_level(init_channels: int, num_levels: int):
    return [init_channels * 2 ** k for k in range(num_levels)]


def gn_groups(c: int, num_groups: int) -> int:
    """One group below ``num_groups`` channels, else ``num_groups`` (largest
    divisor as the fallback for channel counts the reference rejects)."""
    if c < num_groups:
        return 1
    if c % num_groups == 0:
        return num_groups
    return next(g for g in range(num_groups, 0, -1) if c % g == 0)


class SingleConv(nn.Module):
    """'gcr': GroupNorm -> 3^3 conv (no bias) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groupnorm = nn.GroupNorm(gn_groups(in_channels, num_groups),
                                      in_channels, eps=1e-5)
        self.conv = nn.Conv3d(in_channels, out_channels, 3, padding=1, bias=False)
        self.dtype = dtype

    def forward(self, x):
        gn = self.groupnorm
        h = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps)
        h = h.to(self.dtype).float()
        w = self.conv.weight.to(self.dtype).float()
        return torch.relu(F.conv3d(h, w, padding=1)).to(self.dtype)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 num_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = max(out_channels // 2, in_channels) if encoder else out_channels
        self.SingleConv1 = SingleConv(in_channels, mid, num_groups, dtype)
        self.SingleConv2 = SingleConv(mid, out_channels, num_groups, dtype)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool: bool, num_groups, dtype):
        super().__init__()
        self.pool = pool
        self.basic_module = DoubleConv(in_channels, out_channels, True, num_groups, dtype)

    def forward(self, x):
        if self.pool:
            x = F.max_pool3d(x, 2)
        return self.basic_module(x)


class Decoder(nn.Module):
    def __init__(self, in_channels, out_channels, num_groups, dtype):
        super().__init__()
        self.basic_module = DoubleConv(in_channels, out_channels, False, num_groups, dtype)

    def forward(self, skip, x):
        x = F.interpolate(x, size=skip.shape[2:], mode="nearest")
        return self.basic_module(torch.cat([skip, x], dim=1))


class AbstractUNet(nn.Module):
    """DoubleConv 'gcr' encoder/decoder U-Net on one-channel volumes
    (channel-first). Other block families and layer orders are not ported
    (ROADMAP A9)."""

    def __init__(self, out_channels: int, f_maps: Union[int, Sequence[int]] = 64,
                 num_groups: int = 8, num_levels: int = 4,
                 num_truncated_layers: int = 0, dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False):
        super().__init__()
        # block-level gradient checkpointing in the kernel executor
        # (models/fast_unet.py); this plain module ignores it
        self.use_checkpoint = use_checkpoint
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.f_maps = list(f_maps)
        if len(self.f_maps) < 2:
            raise ValueError("a U-Net needs at least 2 levels")
        self.num_groups = num_groups
        self.dtype = dtype
        self.encoders = nn.ModuleList(
            Encoder(1 if i == 0 else self.f_maps[i - 1], ch, i > 0,
                    num_groups, dtype)
            for i, ch in enumerate(self.f_maps)
        )
        rev = self.f_maps[::-1]
        n_dec = len(rev) - 1 - num_truncated_layers
        self.decoders = nn.ModuleList(
            Decoder(rev[i] + rev[i + 1], rev[i + 1], num_groups, dtype)
            for i in range(n_dec)
        )
        self.final_conv = nn.Conv3d(self.f_maps[num_truncated_layers], out_channels, 1)

    def forward(self, x):
        """(B, 1, Z, Y, X) -> (B, out_channels, Z', Y', X')."""
        x = x.to(self.dtype)
        skips = []
        for enc in self.encoders:
            x = enc(x)
            skips.append(x)
        for dec, skip in zip(self.decoders, skips[:-1][::-1]):
            x = dec(skip, x)
        w = self.final_conv.weight.to(self.dtype).float()
        out = F.conv3d(x.float(), w) + self.final_conv.bias.float()[:, None, None, None]
        return out.to(self.dtype)


class UNet3D(AbstractUNet):
    """3D U-Net (all decoders)."""


class TruncatedUNet3D(AbstractUNet):
    """U-Net minus the last ``num_truncated_layers`` decoders: output at
    reduced resolution (the center-of-mass head is resolution-agnostic)."""


def init_weights(unet: AbstractUNet, generator: torch.Generator) -> AbstractUNet:
    """Deterministic init from ``generator`` (on the CPU, so the same seed
    gives the same weights on every device): conv kernels LeCun-normal
    (flax's default, std sqrt(1/fan_in)), GroupNorm scale 1 / bias 0, final
    conv bias 0."""
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, nn.Conv3d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return unet


def supports_fast_unet(backbone: Optional[nn.Module]) -> bool:
    """Can the kernel executor (``models/fast_unet.py``) run this backbone?"""
    return isinstance(backbone, AbstractUNet) and backbone.dtype == torch.bfloat16
