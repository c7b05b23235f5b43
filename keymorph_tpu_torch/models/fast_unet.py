"""Kernel-layout U-Net executor: the bf16 DoubleConv U-Net in layer order
'gcr' or 'cr' on the fused conv kernels (``ops/cuda/conv3d.py``).

Port of ``keymorph_tpu/models/fast_unet.py:fast_unet_forward``. It re-runs
the network of an :class:`~keymorph_tpu_torch.models.unet.AbstractUNet`
from its parameters on flat (Z, C, Y*X) bf16 tensors, one sample at a time:

  * 'gcr': every GroupNorm is folded into the next conv as a per-channel
    affine, computed from per-channel fp32 (mean, E[x^2]) with
    var = E[x^2] - mean^2 (not a two-pass variance), and each DoubleConv's
    second GroupNorm takes its statistics from the first conv's in-kernel
    output stats, so the intermediate is never re-read;
  * 'cr': the convs take no norm operands and their bias (added in fp32
    before the ReLU, as keymorph_tpu's ``_conv_affine`` passes it), and no
    conv emits statistics;
  * a decoder's first conv reads the skip and the half-resolution deeper
    tensor directly (``conv3x3_fused_flat_upconv``: no upsample, no concat),
    with its GroupNorm statistics taken on the small pre-upsample tensors
    (nearest x2 leaves per-channel mean and E[x^2] unchanged); where the
    skip is not exactly twice the deeper size the upsample is materialized
    and the concat-free ``conv3x3_fused_flat_parts`` runs instead;
  * the 2x max-pool is the hand-written ``maxpool2_flat`` where no
    gradient is needed (serving), and a reshape-and-``amax`` under autograd
    where one is; both give the same maxima, NaN included;
  * the final 1x1 conv (bf16 operands, fp32 sums, the fp32 bias, one
    rounding) is the hand-written ``heatmap.final_conv1x1`` where no
    gradient is needed, writing each volume's heatmaps once into the tensor
    returned, and an fp32 matmul of the bf16 values under autograd where
    one is.

The heatmaps come back channel-last (B, Z', Y', X', K) in bf16, as
keymorph_tpu's executor returns them.

The executor is differentiable: the convs carry their own backward (the
input-gradient kernel, ``ops/cuda/conv3d.py``); GroupNorm statistics, the
affine fold, the max-pool and the final conv are plain PyTorch under
autograd. The pool kernel is forward only, so a pool whose input needs a
gradient takes ``resblock.maxpool2_amax``, which splits the gradient evenly
among tied maxima, as keymorph_tpu's ``_maxpool2_rw_bwd`` does (every
all-zero window after a ReLU is such a tie). With ``unet.use_checkpoint`` each
DoubleConv is wrapped in ``torch.utils.checkpoint``: only block boundaries
are kept and the block is replayed, kernels included, in the backward.
Serving code calls it under ``torch.no_grad()``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.utils.checkpoint import checkpoint

from keymorph_tpu_torch.models.unet import AbstractUNet, gn_groups, supports_fast_unet
from keymorph_tpu_torch.ops.cuda import conv3d, heatmap, resblock
from keymorph_tpu_torch.tracing import span
from keymorph_tpu_torch.ops.cuda.conv3d import channel_stats, upsample_nearest_flat


def _maxpool2_flat(xf, spatial):
    """2x max-pool (VALID, floor) of a flat (Z, C, Y*X) bf16 tensor:
    ``maxpool2_flat`` (the kernel on the card) where no gradient is needed,
    the differentiable and uncounted ``maxpool2_amax`` where one is."""
    if torch.is_grad_enabled() and xf.requires_grad:
        return resblock.maxpool2_amax(xf, spatial)
    return resblock.maxpool2_flat(xf, spatial)


_KERNEL_CONVS = SimpleNamespace(
    flat=conv3d.conv3x3_fused_flat,
    parts=conv3d.conv3x3_fused_flat_parts,
    upconv=conv3d.conv3x3_fused_flat_upconv,
    pool=_maxpool2_flat,
    final=heatmap.final_conv1x1,
)
_PLAIN_CONVS = SimpleNamespace(
    flat=conv3d.conv3x3_fused_flat_plain,
    parts=conv3d.conv3x3_fused_flat_parts_plain,
    upconv=conv3d.conv3x3_fused_flat_upconv_plain,
    pool=resblock.maxpool2_flat_plain,
    final=heatmap.final_conv1x1_plain,
)


def _final_conv_autograd(xf, spatial, conv):
    """The final 1x1 conv under autograd: an fp32 matmul of the bf16 values
    plus the fp32 bias, rounded once to (Z, Y, X, K) bf16."""
    hw = conv.weight[:, :, 0, 0, 0].t().to(torch.bfloat16).float()
    out = torch.matmul(xf.float().transpose(1, 2), hw) + conv.bias.float()  # (Z, Y*X, K)
    return out.reshape(*spatial, -1).to(torch.bfloat16)


def gn_affine_from_stats(stats, gamma, beta, groups: int):
    """Per-channel (scale, shift) equal to GroupNorm(eps 1e-5) given
    per-channel (mean, mean-square): each equal-sized group aggregates its
    channels' statistics."""
    mean_c, msq_c = stats
    C = mean_c.shape[0]
    cg = C // groups
    mean_g = mean_c.reshape(groups, cg).mean(dim=1)
    var_g = msq_c.reshape(groups, cg).mean(dim=1) - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + 1e-5)
    gamma = gamma.float()
    scale = inv_g.repeat_interleave(cg) * gamma
    shift = beta.float() - (mean_g * inv_g).repeat_interleave(cg) * gamma
    return scale, shift


def _single_conv_operands(sc, stats, num_groups):
    """(w (3,3,3,Cin,Cout), scale, shift, bias) of a SingleConv module: 'gcr'
    folds its GroupNorm from ``stats`` (no bias), 'cr' passes the conv bias
    (no scale, shift or stats)."""
    w = sc.conv.weight.permute(2, 3, 4, 1, 0)
    if not hasattr(sc, "groupnorm"):
        return w, None, None, sc.conv.bias
    cin = w.shape[3]
    scale, shift = gn_affine_from_stats(
        stats, sc.groupnorm.weight, sc.groupnorm.bias, gn_groups(cin, num_groups)
    )
    return w, scale, shift, None


def _double_conv_flat(block, xf, spatial, num_groups, convs, stats0=None,
                      xb=None, xb_lowres=False):
    """DoubleConv on flat tensors. ``xb``: optional second input part (the
    decoder's deeper tensor; at half resolution with ``xb_lowres``), in
    which case a 'gcr' block's ``stats0`` must cover the concatenated
    channels. The first conv emits its output statistics only where the
    second normalizes."""
    gn = hasattr(block.SingleConv1, "groupnorm")
    if gn and xb is not None and stats0 is None:
        raise ValueError("a two-part DoubleConv needs the concatenated GN stats")
    if gn and stats0 is None:
        stats0 = channel_stats(xf)
    w0, sc0, sh0, b0 = _single_conv_operands(block.SingleConv1, stats0, num_groups)
    wants = hasattr(block.SingleConv2, "groupnorm")
    if xb is None:
        r = convs.flat(xf, spatial, w0, sc0, sh0, b0, emit_stats=wants)
    elif xb_lowres:
        r = convs.upconv(xf, xb, spatial, w0, sc0, sh0, b0, emit_stats=wants)
    else:
        r = convs.parts(xf, xb, spatial, w0, sc0, sh0, b0, emit_stats=wants)
    y, s1 = r if wants else (r, None)
    w1, sc1, sh1, b1 = _single_conv_operands(block.SingleConv2, s1, num_groups)
    return convs.flat(y, spatial, w1, sc1, sh1, b1)


def fast_unet_forward(unet: AbstractUNet, img: torch.Tensor, plain: bool = False):
    """Run ``unet`` on the conv kernels.

    Args:
        unet: a bf16 'gcr' or 'cr' DoubleConv :class:`AbstractUNet`
            (parameters are read from it; see ``unet.supports_fast_unet``).
        img: (B, 1, Z, Y, X) channel-first volume.
        plain: run every conv, the pool and the final conv through their
            plain PyTorch versions instead of the kernel wrappers (the oracle
            route on a GPU; CPU tensors take the plain versions either way).
    Returns:
        (B, Z', Y', X', K) bf16 channel-last heatmaps.
    Raises:
        ValueError: for a backbone ``supports_fast_unet`` refuses (its
            module's forward computes it; ``KeyMorphNet.features`` takes
            that path).
    """
    if not supports_fast_unet(unet):
        raise ValueError(f"the conv-kernel executor runs bf16 'gcr'/'cr' DoubleConv U-Nets, not "
                         f"{type(unet).__name__} (dtype {getattr(unet, 'dtype', None)}, layer "
                         f"order {getattr(unet, 'layer_order', None)!r})")
    convs = _PLAIN_CONVS if plain else _KERNEL_CONVS
    g = unet.num_groups

    def block(module, xf, spatial, **kw):
        if unet.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(_double_conv_flat, module, xf, spatial, g, convs,
                              use_reentrant=False, **kw)
        return _double_conv_flat(module, xf, spatial, g, convs, **kw)

    final = unet.final_conv
    heat, outs = None, []
    for b in range(img.shape[0]):
        x = img[b].transpose(0, 1).to(torch.bfloat16)  # (Z, 1, Y, X)
        spatial = (int(x.shape[0]), int(x.shape[2]), int(x.shape[3]))
        xf = x.reshape(spatial[0], 1, spatial[1] * spatial[2]).contiguous()
        skips = []
        for i, enc in enumerate(unet.encoders):
            if i > 0:
                with span("unet.pool"):
                    xf, spatial = convs.pool(xf, spatial)
            xf = block(enc.basic_module, xf, spatial)
            skips.append((xf, spatial))
        for dec, (skip, sk_sp) in zip(unet.decoders, skips[:-1][::-1]):
            stats0 = None
            if hasattr(dec.basic_module.SingleConv1, "groupnorm"):
                s_skip, s_low = channel_stats(skip), channel_stats(xf)
                stats0 = (torch.cat([s_skip[0], s_low[0]]), torch.cat([s_skip[1], s_low[1]]))
            if tuple(sk_sp) == tuple(2 * s for s in spatial):
                xf = block(dec.basic_module, skip, sk_sp, stats0=stats0, xb=xf,
                           xb_lowres=True)
            else:
                xb = upsample_nearest_flat(xf, spatial, sk_sp).contiguous()
                xf = block(dec.basic_module, skip, sk_sp, stats0=stats0, xb=xb)
            spatial = sk_sp
        # final 1x1 conv: bf16 operands, fp32 products and sums, fp32 bias
        with span("unet.final"):
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (xf, final.weight, final.bias)):
                outs.append(_final_conv_autograd(xf, spatial, final))
                continue
            if heat is None:
                heat = torch.empty((img.shape[0], *spatial, final.weight.shape[0]),
                                   dtype=torch.bfloat16, device=img.device)
            convs.final(xf, spatial, final.weight[:, :, 0, 0, 0], final.bias, heat[b])
    return torch.stack(outs, dim=0) if outs else heat
