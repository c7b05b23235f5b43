"""Kernel-layout executor of the bf16 'gcr' residual U-Nets
(``ResidualUNet3D`` and ``ResidualUNetSE3D``): serving and training on the
conv kernels.

It re-runs the network of an :class:`~keymorph_tpu_torch.models.unet.
AbstractUNet` with residual blocks from its parameters on flat (Z, C, Y*X)
bf16 tensors, one sample at a time, as ``models/fast_unet.py`` does for the
DoubleConv U-Nets. A residual block (a 1x1 lift where the widths change,
GN -> conv -> ReLU, GN -> conv, the residual sum, the ReLU, the optional
scSE gate) runs as:

  * the lift: ``lift1x1_flat``, the 1x1 conv with its bias (bf16 operands,
    fp32 sums, one rounding), which also emits the lifted tensor's
    per-channel statistics for the first GroupNorm (span
    ``km.unet.residual``);
  * the first conv: ``conv3x3_fused_flat`` with its GroupNorm folded into a
    per-channel affine (``fast_unet._single_conv_operands``), the ReLU fused,
    and its output statistics emitted for the second GroupNorm;
  * the second conv: ``conv3x3_fused_flat_res``, its GroupNorm folded from
    those statistics, the residual sum and the ReLU after it in the conv's
    epilogue (``relu(bf16(bf16(conv) + residual))``, the module's rounding),
    emitting the output's statistics: their mean is the scSE squeeze;
  * the scSE gate: the module's ``ChannelSE.gate`` on that mean (C values),
    then ``scse_gate_flat``, one pass over the block output (span
    ``km.unet.se``).

A decoder's transposed 3^3 stride-2 conv and its sum with the skip are
``conv_transpose3x3s2_flat`` (span ``km.unet.tconv``), which also emits the
sum's statistics for the decoder block's first GroupNorm. The module crops
the upsampled tensor to the skip and refuses a skip that is not exactly
twice its input: with floor pooling the crop is then the identity, and this
executor refuses the same sizes. The 2x max-pool is ``maxpool2_flat``, a
kernel of one read (``km.unet.pool``). The final 1x1 conv (``km.unet.final``)
takes bf16 operands and fp32 sums with the fp32 bias and one rounding:
``heatmap.final_conv1x1``, which writes each volume's heatmaps once into the
tensor returned (its plain version, on the CPU or the plain route, an fp32
matmul in Z-slabs). The heatmaps come back channel-last (B, Z, Y, X, K) in
bf16.

The walk is differentiable, and with grad enabled it computes what serving
computes, kernel for kernel: ``KeyMorphNet.features`` takes it for training
(``make_train_step`` and the other steps) as for serving. Each form carries
its backward: the convs and the residual sum ``_FusedConv`` (the residual's
cotangent is the last conv's), the transposed conv ``_TConv`` (its own input-
and weight-gradient kernels, span ``km.unet.tconv.bwd``), the gate
``_ScseGate`` (``scse_gate_bwd_kernel``, span ``km.unet.se.bwd``; the MLP
on (C,) is autograd's), the lift ``_Lift`` (fp32 products of bf16 values, span
``km.unet.residual.bwd``); the GroupNorm folds are autograd's. Under
autograd the pool is ``resblock.maxpool2_amax`` (ties split evenly, as
keymorph_tpu's ``_maxpool2_rw_bwd``), and the final conv is ``_FinalConv``:
the same final conv into a tensor of its own, with ``g_x = bf16(g W)`` and
fp32 ``g_W``, ``g_b`` from fp32 products of the bf16 values, in Z-slabs.
With ``unet.use_checkpoint`` each block is replayed in the backward.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from keymorph_tpu_torch.models.fast_unet import _maxpool2_flat, _single_conv_operands
from keymorph_tpu_torch.models.unet import AbstractUNet, supports_fast_resunet
from keymorph_tpu_torch.ops.cuda import conv3d, heatmap, resblock
from keymorph_tpu_torch.tracing import span

_KERNELS = SimpleNamespace(
    pool=_maxpool2_flat, lift=resblock.lift1x1_flat, flat=conv3d.conv3x3_fused_flat,
    res=conv3d.conv3x3_fused_flat_res, tconv=conv3d.conv_transpose3x3s2_flat,
    gate=resblock.scse_gate_flat, final=heatmap.final_conv1x1)
_PLAINS = SimpleNamespace(
    pool=resblock.maxpool2_flat_plain, lift=resblock.lift1x1_flat_plain,
    flat=conv3d.conv3x3_fused_flat_plain,
    res=conv3d.conv3x3_fused_flat_res_plain, tconv=conv3d.conv_transpose3x3s2_flat_plain,
    gate=resblock.scse_gate_flat_plain, final=heatmap.final_conv1x1_plain)


def _resnet_block(block, xf, spatial, g, ops, stats=None):
    """A ``ResNetBlock`` on flat tensors. ``stats``: the input's
    (mean, mean-square) where it is the residual (no lift): every decoder's
    input comes from the transposed conv, which emits them; every encoder
    lifts."""
    if isinstance(block.conv1, nn.Conv3d):
        with span("unet.residual"):
            residual, stats = ops.lift(xf, block.conv1.weight[:, :, 0, 0, 0], block.conv1.bias)
    else:
        residual = xf
        if stats is None:
            raise ValueError("a residual block without a lift needs its input's statistics")
    w2, sc2, sh2, _ = _single_conv_operands(block.conv2, stats, g)
    y, s2 = ops.flat(residual, spatial, w2, sc2, sh2, None, relu=True, emit_stats=True)
    w3, sc3, sh3, _ = _single_conv_operands(block.conv3, s2, g)
    se = block.se_module
    r = ops.res(y, spatial, w3, sc3, sh3, None, relu=True, emit_stats=se is not None,
                residual=residual)
    if se is None:
        return r
    out, s3 = r
    del y, residual
    with span("unet.se"):
        return ops.gate(out, se, s3[0])


class _FinalConv(torch.autograd.Function):
    """The final conv ``final`` (``final_conv1x1`` or its plain version) into
    a tensor of its own, under autograd; the backward takes the heatmaps'
    bf16 cotangent slab by slab: ``g_x = bf16(g W)`` and the fp32 ``g_W``,
    ``g_b``, all fp32 products of bf16 values (TF32 off)."""

    @staticmethod
    def forward(ctx, xf, weight, bias, spatial, final):
        out = torch.empty((*spatial, weight.shape[0]), dtype=torch.bfloat16, device=xf.device)
        final(xf, spatial, weight[:, :, 0, 0, 0], bias, out)
        ctx.save_for_backward(xf, weight)
        return out

    @staticmethod
    def backward(ctx, g_out):
        xf, weight = ctx.saved_tensors
        Z, cin, N = xf.shape
        K = weight.shape[0]
        wf = weight[:, :, 0, 0, 0].to(torch.bfloat16).float()  # (K, Cin)
        g_x = torch.empty_like(xf)
        g_w = torch.zeros((K, cin), dtype=torch.float32, device=xf.device)
        g_b = torch.zeros(K, dtype=torch.float32, device=xf.device)
        g = g_out.reshape(Z, N, K)
        for z0, z1 in heatmap.z_slabs(Z, K * N):
            gs = g[z0:z1].float()  # (m, N, K)
            g_x[z0:z1] = torch.matmul(wf.t(), gs.transpose(1, 2)).to(torch.bfloat16)
            g_w += torch.bmm(gs.transpose(1, 2), xf[z0:z1].float().transpose(1, 2)).sum(dim=0)
            g_b += gs.sum(dim=(0, 1))
        return g_x, g_w.reshape(weight.shape).to(weight.dtype), g_b, None, None


def fast_resunet_forward(unet: AbstractUNet, img: torch.Tensor, plain: bool = False):
    """Run ``unet`` on the conv kernels, differentiably.

    Args:
        unet: a bf16 'gcr' residual :class:`AbstractUNet` (see
            ``unet.supports_fast_resunet``).
        img: (B, 1, Z, Y, X) channel-first volume.
        plain: run every conv, the transposed convs, the lifts, the gates
            and the final conv through their plain PyTorch versions, forward
            and backward (the oracle route; CPU tensors take the plain
            versions either way).
    Returns:
        (B, Z', Y', X', K) bf16 channel-last heatmaps.
    Raises:
        ValueError: for a backbone ``supports_fast_resunet`` refuses, or a
            skip the transposed conv cannot join (as the module).
    """
    if not supports_fast_resunet(unet):
        raise ValueError(f"the residual executor runs bf16 'gcr' residual U-Nets, not "
                         f"{type(unet).__name__} (blocks {getattr(unet, 'basic_module', None)!r}, "
                         f"dtype {getattr(unet, 'dtype', None)}, layer order "
                         f"{getattr(unet, 'layer_order', None)!r})")
    ops = _PLAINS if plain else _KERNELS
    g = unet.num_groups
    B = img.shape[0]
    grad = torch.is_grad_enabled()

    def block(module, xf, spatial, stats=None):
        if unet.use_checkpoint and grad:
            return checkpoint(_resnet_block, module, xf, spatial, g, ops, stats,
                              use_reentrant=False)
        return _resnet_block(module, xf, spatial, g, ops, stats)

    heat, outs = None, []
    for bi in range(B):
        x = img[bi].transpose(0, 1).to(torch.bfloat16)  # (Z, 1, Y, X)
        spatial = (int(x.shape[0]), int(x.shape[2]), int(x.shape[3]))
        xf = x.reshape(spatial[0], 1, spatial[1] * spatial[2]).contiguous()
        skips = []
        for i, enc in enumerate(unet.encoders):
            if i > 0:
                with span("unet.pool"):
                    xf, spatial = ops.pool(xf, spatial)
            xf = block(enc.basic_module, xf, spatial)
            skips.append((xf, spatial))
        for dec, (skip, sk_sp) in zip(unet.decoders, skips[:-1][::-1]):
            if tuple(sk_sp) != tuple(2 * s for s in spatial):
                raise ValueError(f"residual decoder: the upsampled "
                                 f"{tuple(2 * s for s in spatial)} cannot join the skip "
                                 f"{tuple(sk_sp)} (odd skip sizes are not supported, as in "
                                 "keymorph_tpu)")
            up = dec.upsampling.upsample
            with span("unet.tconv"):
                xf, stats = ops.tconv(xf, sk_sp, up.weight, up.bias.to(torch.bfloat16).float(),
                                      skip=skip, emit_stats=True)
            spatial = sk_sp
            xf = block(dec.basic_module, xf, spatial, stats)
        del skips
        final = unet.final_conv
        with span("unet.final"):
            if grad:
                outs.append(_FinalConv.apply(xf, final.weight, final.bias, spatial, ops.final))
                continue
            if heat is None:
                heat = torch.empty((B, *spatial, final.weight.shape[0]), dtype=torch.bfloat16,
                                   device=img.device)
            ops.final(xf, spatial, final.weight[:, :, 0, 0, 0], final.bias, heat[bi])
    return torch.stack(outs) if grad else heat
