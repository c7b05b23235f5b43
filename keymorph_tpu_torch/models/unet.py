"""U-Net backbones as plain ``nn.Module``\\ s.

Port of ``keymorph_tpu/models/unet.py``, channel-first (B, C, *spatial):

  * ``SingleConv`` in any layer order of 'g' (GroupNorm, eps 1e-5, one group
    below ``num_groups`` channels), 'b' (the stateless batch norm), 'c' (the
    conv, with a bias only where the order has no norm), 'r' (ReLU), 'l'
    (LeakyReLU, slope 0.1), 'e' (ELU); ``DoubleConv`` with the encoder's
    conv-1 width ``max(out // 2, in)``;
  * ``ResNetBlock``: a 1x1 lift where the widths differ, a SingleConv, a
    SingleConv without the non-linearity, the residual sum, the
    non-linearity, and optionally the concurrent scSE gate (reduction ratio
    1; ``ChannelSE``, ``SpatialSE``, ``ChannelSpatialSE``);
  * 3^3 convs with padding 1 (keymorph_tpu's ``conv_kernel_size`` and
    ``conv_padding`` defaults, the only values its factory uses), or 3^2
    convs with ``dim=2`` (``UNet2D``, DoubleConv blocks only, as
    keymorph_tpu's factory builds it);
  * the f_maps ladder ``[f * 2**k]``; 2x max-pool before every encoder but
    the first; DoubleConv decoders join by nearest 2x upsample and
    ``[skip, x]`` concat, residual ones by a transposed conv (3^3, stride 2,
    keymorph_tpu's padding (1, 2) on the dilated input, which is
    ``ConvTranspose3d(padding=1, output_padding=1)``) cropped to the skip
    and summed; ``TruncatedUNet3D`` drops the last
    ``num_truncated_layers`` decoders; a final 1x1 conv with bias of bf16
    operands, fp32 sums and an fp32 bias (keymorph_tpu's ``PointwiseConv``);
  * ``SimpleUnet``, the brain extractor's small U-Net: encoder widths
    (4, 8, 16, 32), decoder widths (32, 16, 8, 4), each block a 3^3 conv
    with bias, an instance norm (eps 1e-6, flax's default) and a ReLU, 2x
    max-pools down and x2 trilinear upsampling up (``ops/resize.py``,
    ``jax.image.resize``'s weights) with ``[up, skip]`` concats.

Parameter names are the reference unet3d ``state_dict`` keys
(``encoders.i.basic_module.SingleConv{1,2}.{groupnorm,batchnorm,conv}.*``;
residual blocks ``conv1`` (the lift), ``conv2``, ``conv3``,
``se_module.{cSE.fc1,cSE.fc2,sSE.conv}``; ``decoders.j.upsampling.upsample``;
``final_conv.*``), so weights move between these modules, the kernel
executor (``models/fast_unet.py``), a reference ``.pt`` and keymorph_tpu's
flax tree (``tools/import_flax_params.py``).

With ``dtype=torch.bfloat16`` the modules compute as the flax bf16
backbones do (``models/layers.py:conv_nd``): normalization statistics in
fp32, conv operands rounded to bf16 with fp32 sums, activations stored in
bf16. The bf16 'gcr' and 'cr' DoubleConv U-Nets also run on the conv
kernels (:func:`supports_fast_unet`), and so do the bf16 'gcr' residual
U-Nets, serving and training (:func:`supports_fast_resunet`); every other
backbone is computed by these modules, as keymorph_tpu computes it with flax
``nn.Conv`` (XLA, no Pallas kernel).
With ``dtype=torch.float64`` they evaluate in float64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from keymorph_tpu_torch.models.layers import (
    GroupNorm,
    StatelessBatchNorm,
    acc_dtype,
    conv_nd,
    max_pool,
    per_slice,
)
from keymorph_tpu_torch.ops.resize import resize_trilinear


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


def _activation(ch: str, x: torch.Tensor) -> torch.Tensor:
    if ch == "r":
        return torch.relu(x)
    if ch == "l":
        return F.leaky_relu(x, 0.1)
    return F.elu(x)


class SingleConv(nn.Module):
    """One norm/conv/activation layer in the order ``order``."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr",
                 num_groups: int = 8, dtype: torch.dtype = torch.float32, dim: int = 3):
        super().__init__()
        if "c" not in order or set(order) - set("gbcrle"):
            raise ValueError(f"layer order {order!r}: 'c' required, chars from 'gbcrle'")
        self.order = order
        self.dtype = dtype
        conv = nn.Conv2d if dim == 2 else nn.Conv3d
        self.conv = conv(in_channels, out_channels, 3, padding=1,
                         bias=not ("g" in order or "b" in order))
        for ch in "gb":
            if ch in order:
                c = in_channels if order.index(ch) < order.index("c") else out_channels
                if ch == "g":
                    self.groupnorm = GroupNorm(gn_groups(c, num_groups), c, dtype)
                else:
                    self.batchnorm = StatelessBatchNorm(c, dtype)

    def forward(self, x):
        for ch in self.order:
            if ch == "c":
                x = conv_nd(x, self.conv, self.dtype, padding=1)
            elif ch == "g":
                x = self.groupnorm(x)
            elif ch == "b":
                x = self.batchnorm(x)
            else:
                x = _activation(ch, x)
        return x


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, encoder: bool, order: str = "gcr",
                 num_groups: int = 8, dtype: torch.dtype = torch.float32, dim: int = 3):
        super().__init__()
        mid = max(out_channels // 2, in_channels) if encoder else out_channels
        kw = dict(order=order, num_groups=num_groups, dtype=dtype, dim=dim)
        self.SingleConv1 = SingleConv(in_channels, mid, **kw)
        self.SingleConv2 = SingleConv(mid, out_channels, **kw)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


def _linear(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A flax ``Dense`` of ``dtype``: operands rounded to ``dtype``."""
    acc = acc_dtype(dtype)
    return F.linear(x.to(dtype).to(acc), fc.weight.to(dtype).to(acc),
                    fc.bias.to(dtype).to(acc)).to(dtype)


class ChannelSE(nn.Module):
    """Channel squeeze-and-excitation: spatial mean -> fc1 -> ReLU -> fc2 ->
    sigmoid -> scale each channel."""

    def __init__(self, channels: int, reduction_ratio: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction_ratio, 1))
        self.fc2 = nn.Linear(max(channels // reduction_ratio, 1), channels)
        self.dtype = dtype

    def gate(self, s: torch.Tensor) -> torch.Tensor:
        """The per-channel gate (B, C) from the spatial mean ``s``."""
        return torch.sigmoid(_linear(torch.relu(_linear(s, self.fc1, self.dtype)), self.fc2,
                                     self.dtype))

    def forward(self, x):
        s = self.gate(x.to(acc_dtype(self.dtype)).mean(dim=tuple(range(2, x.dim()))))
        return x * s.reshape(*s.shape, *([1] * (x.dim() - 2)))


class SpatialSE(nn.Module):
    """Spatial squeeze-and-excitation: 1x1 conv to one channel -> sigmoid ->
    scale every channel."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv3d(channels, 1, 1)
        self.dtype = dtype

    def forward(self, x):
        return x * torch.sigmoid(conv_nd(x, self.conv, self.dtype))


class ChannelSpatialSE(nn.Module):
    """Concurrent scSE: the elementwise max of the channel and spatial gates."""

    def __init__(self, channels: int, reduction_ratio: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cSE = ChannelSE(channels, reduction_ratio, dtype)
        self.sSE = SpatialSE(channels, dtype)

    def forward(self, x):
        return torch.maximum(self.cSE(x), self.sSE(x))


class ResNetBlock(nn.Module):
    """Residual block, optionally with the scSE gate (``se``)."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool = True,
                 order: str = "gcr", num_groups: int = 8, dtype: torch.dtype = torch.float32,
                 se: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = (nn.Conv3d(in_channels, out_channels, 1) if in_channels != out_channels
                      else nn.Identity())
        kw = dict(num_groups=num_groups, dtype=dtype)
        self.conv2 = SingleConv(out_channels, out_channels, order=order, **kw)
        n_order = "".join(c for c in order if c not in "rel")
        self.conv3 = SingleConv(out_channels, out_channels, order=n_order, **kw)
        self.act = "l" if "l" in order else "e" if "e" in order else "r"
        self.se_module = ChannelSpatialSE(out_channels, 1, dtype) if se else None

    def forward(self, x):
        residual = (conv_nd(x, self.conv1, self.dtype) if isinstance(self.conv1, nn.Conv3d)
                    else x)
        out = _activation(self.act, self.conv3(self.conv2(residual)) + residual)
        return out if self.se_module is None else self.se_module(out)


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool: bool, block, dim: int = 3):
        super().__init__()
        self.pool = pool
        self.dim = dim
        self.basic_module = block(in_channels, out_channels, True)

    def forward(self, x):
        return self.basic_module(max_pool(x, self.dim) if self.pool else x)


class TransposeConvUpsampling(nn.Module):
    """The residual decoder's upsampling: a stride-2 transposed conv."""

    def __init__(self, in_channels, out_channels, dtype):
        super().__init__()
        self.upsample = nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2, padding=1,
                                           output_padding=1)
        self.dtype = dtype

    def forward(self, skip, x):
        x = conv_nd(x, self.upsample, self.dtype, stride=2, padding=1, output_padding=1)
        x = x[(slice(None), slice(None)) + tuple(slice(0, s) for s in skip.shape[2:])]
        if x.shape != skip.shape:
            # keymorph_tpu's sum fails here too (and the reference's
            # ConvTranspose3d refuses the output size): the upsample of a
            # floor-halved odd size is one voxel short
            raise ValueError(f"residual decoder: the upsampled {tuple(x.shape[2:])} cannot join "
                             f"the skip {tuple(skip.shape[2:])} (odd skip sizes are not "
                             "supported, as in keymorph_tpu)")
        return skip + x


class Decoder(nn.Module):
    def __init__(self, in_channels, out_channels, block, residual: bool, dtype):
        super().__init__()
        if residual:
            self.upsampling = TransposeConvUpsampling(in_channels, out_channels, dtype)
            self.basic_module = block(out_channels, out_channels, False)
        else:
            self.upsampling = None
            self.basic_module = block(in_channels + out_channels, out_channels, False)

    def forward(self, skip, x):
        if self.upsampling is not None:
            return self.basic_module(self.upsampling(skip, x))
        x = F.interpolate(x, size=skip.shape[2:], mode="nearest")
        return self.basic_module(torch.cat([skip, x], dim=1))


class AbstractUNet(nn.Module):
    """Encoder/decoder U-Net on one-channel volumes or images
    (channel-first), ``dim`` 3 or 2.

    ``basic_module``: ``"double"`` (DoubleConv blocks, upsample + concat),
    ``"resnet"`` or ``"resnetse"`` (ResNetBlocks without or with the scSE
    gate, transposed conv + sum; 3D only). keymorph_tpu's segmentation head
    (``is_segmentation``) is not carried: no backbone of the registration
    pipeline sets it.
    """

    def __init__(self, out_channels: int, f_maps: Union[int, Sequence[int]] = 64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 4,
                 num_truncated_layers: int = 0, basic_module: str = "double",
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False,
                 dim: int = 3):
        super().__init__()
        if basic_module not in ("double", "resnet", "resnetse"):
            raise ValueError(f"basic_module={basic_module!r}")
        if dim not in (2, 3) or (dim == 2 and basic_module != "double"):
            raise ValueError(f"dim={dim} with basic_module={basic_module!r}: the residual "
                             "U-Nets are 3D only, as keymorph_tpu's factory asserts")
        self.dim = dim
        # block-level gradient checkpointing, here and in the kernel executor
        self.use_checkpoint = use_checkpoint
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.f_maps = list(f_maps)
        if len(self.f_maps) < 2:
            raise ValueError("a U-Net needs at least 2 levels")
        self.layer_order = layer_order
        self.num_groups = num_groups
        self.basic_module = basic_module
        self.dtype = dtype
        residual = basic_module != "double"
        kw = dict(order=layer_order, num_groups=num_groups, dtype=dtype)

        def block(cin, cout, encoder):
            if residual:
                return ResNetBlock(cin, cout, encoder, se=basic_module == "resnetse", **kw)
            return DoubleConv(cin, cout, encoder, dim=dim, **kw)

        self.encoders = nn.ModuleList(
            Encoder(1 if i == 0 else self.f_maps[i - 1], ch, i > 0, block, dim)
            for i, ch in enumerate(self.f_maps)
        )
        rev = self.f_maps[::-1]
        n_dec = len(rev) - 1 - num_truncated_layers
        self.decoders = nn.ModuleList(
            Decoder(rev[i], rev[i + 1], block, residual, dtype)
            for i in range(n_dec)
        )
        self.final_conv = (nn.Conv2d if dim == 2 else nn.Conv3d)(
            self.f_maps[num_truncated_layers], out_channels, 1)

    def _run(self, module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, x):
        """(B, 1, *spatial) -> (B, out_channels, *spatial') in ``dtype``."""
        x = x.to(self.dtype)
        skips = []
        for enc in self.encoders:
            x = self._run(enc, x)
            skips.append(x)
        for dec, skip in zip(self.decoders, skips[:-1][::-1]):
            x = self._run(dec, skip, x)
        return self.head(x)

    def head(self, x):
        """The final 1x1 conv with bias (bf16 operands, fp32 sums, an fp32
        bias), the result in ``dtype``."""
        acc = acc_dtype(self.dtype)
        w = self.final_conv.weight.to(self.dtype).to(acc)
        conv = F.conv2d if self.dim == 2 else F.conv3d
        out = per_slice(lambda t: conv(t, w), x.to(acc), self.dim)
        bias = self.final_conv.bias.to(acc).reshape(-1, *([1] * (x.dim() - 2)))
        return (out + bias).to(self.dtype)


class UNet3D(AbstractUNet):
    """3D U-Net (all decoders)."""


class UNet2D(AbstractUNet):
    """2D U-Net (all decoders): 3^2 convs, 2x2 max-pools, nearest upsampling
    to the skip's size."""

    def __init__(self, out_channels: int, **kw):
        super().__init__(out_channels, dim=2, **kw)


class TruncatedUNet3D(AbstractUNet):
    """U-Net minus the last ``num_truncated_layers`` decoders: output at
    reduced resolution (the center-of-mass head is resolution-agnostic)."""


class ResidualUNet3D(AbstractUNet):
    """Residual 3D U-Net: ResNetBlocks, transposed-conv upsampling, sum
    joining (5 levels unless told otherwise)."""

    def __init__(self, out_channels: int, num_levels: int = 5, **kw):
        super().__init__(out_channels, num_levels=num_levels, basic_module="resnet", **kw)


class ResidualUNetSE3D(AbstractUNet):
    """Residual 3D U-Net whose blocks end in the scSE gate."""

    def __init__(self, out_channels: int, num_levels: int = 5, **kw):
        super().__init__(out_channels, num_levels=num_levels, basic_module="resnetse", **kw)


class SimpleBlock(nn.Module):
    """3^3 conv with bias -> instance norm (eps 1e-6) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, dtype):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 3, padding=1)
        self.norm = GroupNorm(out_channels, out_channels, dtype, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        return torch.relu(self.norm(conv_nd(x, self.conv, self.dtype, padding=1)))


class SimpleUnet(nn.Module):
    """The brain extractor's U-Net (keymorph_tpu's ``SimpleUnet``):
    (B, 1, Z, Y, X) -> logits (B, out_channels, Z, Y, X) in ``dtype``; each
    spatial size must divide by 16. ``blocks.0-3`` encode (a 2x max-pool
    before each but the first), ``blocks.4`` is the bottleneck after a
    fourth pool, ``blocks.5-8`` decode (x2 trilinear upsampling, then the
    concat with the skip), ``final_conv`` a 3^3 conv with bias.
    keymorph_tpu's ``use_in=False`` (no norm) is not carried: its brain
    extractor builds the default."""

    def __init__(self, out_channels: int = 1, enc_nf: Sequence[int] = (4, 8, 16, 32),
                 dec_nf: Sequence[int] = (32, 16, 8, 4), dtype: torch.dtype = torch.float32):
        super().__init__()
        e, dn = list(enc_nf), list(dec_nf)
        widths = [(1, e[0]), (e[0], e[1]), (e[1], e[2]), (e[2], e[3]), (e[3], dn[0]),
                  (dn[0] + e[3], dn[1]), (dn[1] + e[2], dn[2]), (dn[2] + e[1], dn[3]),
                  (dn[3] + e[0], out_channels)]
        self.blocks = nn.ModuleList(SimpleBlock(cin, cout, dtype) for cin, cout in widths)
        self.final_conv = nn.Conv3d(out_channels, out_channels, 3, padding=1)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        skips = []
        for blk in self.blocks[:4]:
            x = blk(max_pool(x, 3) if skips else x)
            skips.append(x)
        h = self.blocks[4](max_pool(x, 3))
        for blk, skip in zip(self.blocks[5:], skips[::-1]):
            up = resize_trilinear(h, [2 * s for s in h.shape[2:]]).to(self.dtype)
            h = blk(torch.cat([up, skip], dim=1))
        return conv_nd(h, self.final_conv, self.dtype, padding=1)


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic init from ``generator`` (on the CPU, so the same seed
    gives the same weights on every device), flax's defaults: conv, transposed
    conv and dense kernels LeCun-normal (std sqrt(1 / fan_in)), their biases 0,
    norm scales 1 and biases 0."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv3d, nn.Conv2d, nn.ConvTranspose3d, nn.Linear)):
                fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose3d) \
                    else m.weight.shape[0] * m.weight[0, 0].numel()
                w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, StatelessBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return net


def supports_fast_unet(backbone: Optional[nn.Module]) -> bool:
    """Can the kernel executor (``models/fast_unet.py``) run this backbone?
    keymorph_tpu's predicate: a DoubleConv U-Net in layer order 'gcr' or
    'cr', 3D, in bf16 (its convs are 3^3 with padding 1, and it has no
    segmentation head, as every port U-Net)."""
    return (isinstance(backbone, AbstractUNet) and backbone.basic_module == "double"
            and backbone.dim == 3
            and backbone.layer_order in ("gcr", "cr") and backbone.dtype == torch.bfloat16)


def supports_fast_resunet(backbone: Optional[nn.Module]) -> bool:
    """Can the residual executor (``models/fast_resunet.py``) run this
    backbone? A 3D residual U-Net (``ResidualUNet3D`` or ``ResidualUNetSE3D``)
    in layer order 'gcr', in bf16, whose every encoder widens (lifts), as
    an int ``f_maps`` makes it. ``KeyMorphNet.features`` then takes the
    executor with grad enabled (training) and disabled (serving)."""
    return (isinstance(backbone, AbstractUNet) and backbone.basic_module in ("resnet", "resnetse")
            and backbone.dim == 3 and backbone.layer_order == "gcr"
            and backbone.dtype == torch.bfloat16
            and all(isinstance(e.basic_module.conv1, nn.Conv3d) for e in backbone.encoders))
