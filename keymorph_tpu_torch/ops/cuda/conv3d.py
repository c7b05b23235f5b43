"""Fused affine + 3x3x3 SAME conv + bias + ReLU on the flat (Z, C, Y*X)
layout: ``conv3x3_fused_flat`` and its ``_parts`` / ``_upconv`` forms, the
4-D entry ``conv3x3_fused``, and their gradient.

Port of ``keymorph_tpu/ops/pallas/conv3d.py`` (kernels B1-B3 and B6) and
of its weight gradient (B9). The public functions keep the JAX package's
signatures and layouts:

  * ``xf`` / ``xa`` / ``xb``: flat (Z, C, Y*X) bf16 volumes (one sample);
  * ``w``: (3, 3, 3, Cin, Cout) conv weights (flax ``nn.Conv`` layout);
  * ``scale``/``shift``: optional per-Cin affine applied before the conv
    (the folded GroupNorm), with out-of-volume taps 0 after it;
  * ``bias``: optional per-Cout bias; ``relu``: fused ReLU;
  * ``emit_stats``: also return the per-Cout fp32 (mean, mean-square) of the
    bf16 output, for the next GroupNorm.

One CUDA source (``csrc/conv3d.cu``) serves all three forms and both
gradients. The forward and the input gradient take two kernels chosen by a
shape rule (:data:`FMA_BELOW`, here only): every input gradient, and
the forward conv with 8 or more input channels, is an implicit GEMM on the
bf16 tensor cores (``wgmma``: voxels x Cout x 27*Cin, fp32 sums in registers),
bound by tensor-core operations; the forward conv with fewer (the U-Net's
e0c1, 1 -> 16) is the fp32-FMA kernel of the first slices, bound by bytes.
The tile geometry is chosen here and only validated by the C entry points
against the buffer sizes they fix at compile time. The tensor-core kernel is
told its tile geometry and is handed its weights already packed as its B
operand, bf16 ``[Cout block][16-channel chunk][ci/8][tap][co][ci%8]``;
:func:`tile_geometry`, :func:`halo_linearisation`, :func:`packed_channels`,
:func:`pack_weights` and :func:`pack_weights_grad` below are that contract in
plain Python, which the CPU tests hold against the plain versions. Shared
memory per stage is 51,200 B of halo tile plus 864 B x the Cout block (8, 16,
32 or 64) of weights, two stages when Cin > 16; ``csrc/conv3d.cu`` states
registers and spill.

The plain versions compute keymorph_tpu's ``_conv_xla`` arithmetic: operands
rounded to bf16, lifted to fp32, an fp32 ``conv3d`` (TF32 must be off), output
rounded to bf16. CPU tensors run them; CUDA tensors launch the kernel. The
tensor cores take the same fp32 sum in another order and do not round every
partial sum to nearest: a stored bf16 output lies within one bf16 ulp of the
plain version's, plus 1e-5 of the range where the terms cancel.

All forms are differentiable through one ``torch.autograd.Function`` whose
backward follows keymorph_tpu's ``_conv_bwd``: with u = a*x + b,
v = conv_W(pad0(bf16(u))) + bias, y = relu(v),

  * ``y`` is recomputed with the forward kernel where the ReLU mask or the
    stats cotangents need it (the forward saves only its inputs);
  * the stats cotangents fold into the output cotangent as
    ``(g_mean + 2 y g_msq) / n``, the ReLU masks it, and it is rounded to
    bf16 (``g_v``);
  * the input gradient ``g_u`` is :func:`conv3x3_input_grad`: the same conv
    over ``g_v`` with flipped taps and swapped channels (B6), bf16 out;
    ``g_x = bf16(g_u * a)``;
  * ``g_a``, ``g_b``, ``g_bias`` are plain reductions;
  * the weight gradient is :func:`conv3x3_weight_grad`: all 27 taps in one
    tensor-core kernel over the staged halo planes (the forward's affine,
    rounding, pad0 and half-resolution read: neither ``u`` nor the concat is
    built), voxels split across blocks, the splits summed in order by a
    second kernel (:func:`weight_grad_plan` says how); its plain version
    (:func:`_weight_grad_plain`, the CPU's and the ``plain`` path's) builds
    ``bf16(u)`` and takes 27 tap-sliced fp32 products over views of one
    padded copy.

For the upconv form the half-resolution source's gradient is the 2x2x2
block sum of the full-resolution ``g_u`` (the transpose of nearest x2).

The residual U-Nets run through two more forms of the same kernel:
``conv3x3_fused_flat_res`` (a block's last conv, the residual sum and the
ReLU in its epilogue; the residual is one more operand of the same autograd
Function, whose cotangent is ``g_v`` itself: the sum's rounding passes
straight through) and ``conv_transpose3x3s2_flat`` (the decoders' transposed
3x3x3 stride-2 conv as the conv of the zero-dilated input, the skip summed in
its epilogue), each with its plain version. The transposed conv's backward
(``_TConv``) takes two kernels of its own: the input gradient
(:func:`conv_transpose3x3s2_input_grad`, the full-resolution conv of the
cotangent kept at the even voxels: form TDGRAD of ``km_conv3x3``) and the
weight gradient (:func:`conv_transpose3x3s2_weight_grad`, the weight
gradient's kernel over the zero-dilated input).

Every form but the weight gradient is one mode of one path: the public
functions and their plain versions call :func:`_forward`, which counts the
plain version's calls or the kernel's launches and runs :func:`_plain` or
:func:`_launch`. ``_launch`` checks the operands, packs the weights as the
mode's :class:`_Form` says, chooses the Cout block (:func:`n_block`) and calls
the library's one entry for these products, ``km_conv3x3``, naming the form
(FMA, PLAIN, RES, TCONV, TDGRAD; the input gradient is PLAIN with its output
split).
The weight gradient is another kernel behind ``km_conv3x3_weight_grad``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.tracing import span


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


class _ChannelStats(torch.autograd.Function):
    """(mean, mean-square) per channel; the backward keeps only the input in
    its own dtype (no fp32 copy is saved)."""

    @staticmethod
    def forward(ctx, xf):
        ctx.save_for_backward(xf)
        x = xf.float()
        return x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))

    @staticmethod
    def backward(ctx, g_m, g_m2):
        (xf,) = ctx.saved_tensors
        return stats_cotangent(xf, g_m, g_m2).to(xf.dtype)


def stats_cotangent(y, g_m, g_m2):
    """The cotangent that a flat (Z, C, N) tensor ``y``'s per-channel (mean,
    mean-square) pass back to it: ``(g_m + 2 y g_m2) / n`` in fp32, ``n``
    the voxels of a channel."""
    n = float(y.shape[0] * y.shape[2])
    return (g_m.float()[None, :, None] + 2.0 * y.float() * g_m2.float()[None, :, None]) / n


def channel_stats(xf: torch.Tensor):
    """Per-channel fp32 (mean, mean-square) of a flat (Z, C, N) tensor."""
    return _ChannelStats.apply(xf)


def upsample_nearest_flat(xf: torch.Tensor, spatial: Sequence[int],
                          target: Sequence[int]) -> torch.Tensor:
    """Nearest resize of a flat (Z, C, Y*X) tensor from ``spatial`` to
    ``target`` (torch's index rule floor(dst * s / t); x2 repeats)."""
    C = xf.shape[1]
    x4 = xf.reshape(spatial[0], C, spatial[1], spatial[2])
    for axis, s, t in zip((0, 2, 3), spatial, target):
        idx = torch.floor(torch.arange(t, dtype=torch.float32) * (s / t)).long()
        x4 = x4.index_select(axis, idx.to(xf.device))
    return x4.reshape(target[0], C, target[1] * target[2])


def _conv_plain(xf, spatial, w, scale, shift, bias, relu, emit_stats):
    Z, Y, X = spatial
    xc = xf.float()
    if scale is not None:
        xc = xc * scale.float()[None, :, None]
    if shift is not None:
        xc = xc + shift.float()[None, :, None]
    lhs = xc.to(torch.bfloat16).float().reshape(Z, -1, Y, X).permute(1, 0, 2, 3)
    rhs = w.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2)  # OIDHW
    out = F.conv3d(lhs[None], rhs, padding=1)[0]  # (Cout, Z, Y, X)
    if bias is not None:
        out = out + bias.float()[:, None, None, None]
    if relu:
        out = torch.relu(out)
    out = out.permute(1, 0, 2, 3).to(torch.bfloat16).reshape(Z, -1, Y * X)
    return (out, channel_stats(out)) if emit_stats else out


def _full_input(xa, xb, b_lowres, spatial):
    """The conv's whole input [xa, xb] at ``spatial`` (concat and upsample
    materialized)."""
    if xb is None:
        return xa
    if b_lowres:
        Z, Y, X = spatial
        xb = upsample_nearest_flat(xb, (Z // 2, Y // 2, X // 2), spatial)
    return torch.cat([xa, xb], dim=1)


def conv3x3_fused_flat_plain(xf, spatial, w, scale=None, shift=None, bias=None,
                             relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat` (differentiable, with the
    plain input gradient)."""
    return _apply("flat", True, xf, None, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_fused_flat_parts_plain(xa, xb, spatial, w, scale=None, shift=None,
                                   bias=None, relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat_parts` (materializes the concat)."""
    return _apply("parts", True, xa, xb, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_fused_flat_upconv_plain(xa, xb_lo, spatial, w, scale=None, shift=None,
                                    bias=None, relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat_upconv` (materializes the
    upsample and the concat)."""
    return _apply("upconv", True, xa, xb_lo, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_input_grad_plain(g_v, spatial, w, ca=None):
    """Plain PyTorch :func:`conv3x3_input_grad`: an fp32 ``conv3d`` of the
    bf16 cotangent with the flipped, channel-swapped bf16-rounded weights,
    rounded to bf16."""
    return _forward("igrad", True, g_v, None, spatial, w, ca=ca)


def conv3x3_fused_flat_res_plain(xf, spatial, w, scale=None, shift=None, bias=None,
                                 relu=True, emit_stats=False, *, residual):
    """Plain PyTorch :func:`conv3x3_fused_flat_res` (differentiable, with the
    plain input gradient)."""
    return _apply("res", True, xf, None, spatial, w, scale, shift, bias, relu, emit_stats,
                  res=residual)


def conv_transpose3x3s2_flat_plain(x_lo, spatial, wt, bias=None, skip=None, emit_stats=False):
    """Plain PyTorch :func:`conv_transpose3x3s2_flat`: an fp32
    ``conv_transpose3d`` of the bf16 operands, rounded to bf16, plus the skip,
    rounded again (differentiable, with the plain gradients)."""
    return _tconv_apply(True, x_lo, spatial, wt, bias, skip, emit_stats)


def conv_transpose3x3s2_input_grad_plain(g_v, spatial, wt):
    """Plain PyTorch :func:`conv_transpose3x3s2_input_grad`: the fp32 stride-2
    ``conv3d`` of the bf16 cotangent with the bf16-rounded weights (the
    adjoint of ``conv_transpose3d``), rounded to bf16."""
    return _forward("tdgrad", True, g_v, None, spatial, wt)


def _plain(mode, xa, xb, spatial, w, scale, shift, bias, relu, emit_stats, res, ca):
    """The arithmetic of each mode's plain version (:func:`_forward`'s
    operands): fp32 convs, which TF32 would round."""
    if (xb if xa is None else xa).is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("plain conv oracle needs TF32 off: call "
                           "keymorph_tpu_torch.disable_tf32() first")
    if mode == "igrad":
        return _input_grad_plain(xa, spatial, w, ca)
    if mode == "tconv":
        return _tconv_plain(xb, spatial, w, bias, res, emit_stats)
    if mode == "tdgrad":
        return _tconv_input_grad_plain(xa, spatial, w)
    if mode != "res":
        return _conv_plain(_full_input(xa, xb, mode == "upconv", spatial), spatial, w, scale,
                           shift, bias, relu, emit_stats)
    y = _conv_plain(xa, spatial, w, scale, shift, bias, False, False)
    y = (y.float() + res.float()).to(torch.bfloat16)
    if relu:
        y = torch.relu(y)
    return (y, channel_stats(y)) if emit_stats else y


def _tconv_plain(x_lo, spatial, wt, bias, skip, emit_stats):
    Z, Y, X = (int(s) for s in spatial)
    cin, cout = int(wt.shape[0]), int(wt.shape[1])
    lhs = x_lo.float().reshape(Z // 2, cin, Y // 2, X // 2).permute(1, 0, 2, 3)[None]
    b = None if bias is None else bias.float()
    out = F.conv_transpose3d(lhs, wt.to(torch.bfloat16).float(), b, stride=2, padding=1,
                             output_padding=1)[0]
    out = out.permute(1, 0, 2, 3).to(torch.bfloat16).reshape(Z, cout, Y * X)
    if skip is not None:
        out = (out.float() + skip.float()).to(torch.bfloat16)
    return (out, channel_stats(out)) if emit_stats else out


def _tconv_input_grad_plain(g_v, spatial, wt):
    Z, Y, X = (int(s) for s in spatial)
    cout = int(wt.shape[1])
    lhs = g_v.float().reshape(Z, cout, Y, X).permute(1, 0, 2, 3)[None]
    out = F.conv3d(lhs, wt.to(torch.bfloat16).float(), stride=2, padding=1)[0]
    return out.permute(1, 0, 2, 3).to(torch.bfloat16).reshape(Z // 2, -1, (Y // 2) * (X // 2))


def _tconv_weight_grad_plain(x_lo, spatial, g_v):
    """Plain PyTorch :func:`conv_transpose3x3s2_weight_grad`:
    dWt[ci, co, kz, ky, kx] = sum_i x[ci, i] * g_v[co, 2i + k - 1] per axis
    (zero outside), 27 z-batched fp32 products of bf16-valued operands over
    stride-2 views of one padded copy of ``g_v``. Returns (Cin, Cout, 3, 3, 3)
    fp32."""
    _tconv_weight_grad_plain.calls += 1
    Z, Y, X = (int(s) for s in spatial)
    Zh, Yh, Xh = Z // 2, Y // 2, X // 2
    cout = int(g_v.shape[1])
    gp = F.pad(g_v.reshape(Z, cout, Y, X), (1, 1, 1, 1, 0, 0, 1, 1))
    xs = x_lo.float()  # (Zh, Cin, Yh*Xh)
    taps = []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                gs = gp[kz:kz + 2 * Zh:2, :, ky:ky + 2 * Yh:2, kx:kx + 2 * Xh:2]
                gs = gs.float().reshape(Zh, cout, Yh * Xh).transpose(1, 2)
                taps.append(torch.bmm(xs, gs).sum(dim=0))
    return torch.stack(taps).reshape(3, 3, 3, xs.shape[1], cout).permute(3, 4, 0, 1, 2)


def _input_grad_plain(g_v, spatial, w, ca):
    Z, Y, X = spatial
    lhs = g_v.float().reshape(Z, -1, Y, X).permute(1, 0, 2, 3)
    # OIDHW with O = Cin, I = Cout, taps flipped
    rhs = w.to(torch.bfloat16).float().flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    out = F.conv3d(lhs[None], rhs, padding=1)[0]  # (Cin, Z, Y, X)
    out = out.permute(1, 0, 2, 3).to(torch.bfloat16).reshape(Z, -1, Y * X)
    return _split(out, ca)


def _split(g_u, ca):
    if ca is None or ca == g_u.shape[1]:
        return g_u, None
    return g_u[:, :ca].contiguous(), g_u[:, ca:].contiguous()


def _weight_grad_plain(xa, xb, spatial, g_v, scale=None, shift=None, lowres=False):
    """Plain PyTorch :func:`conv3x3_weight_grad`. With u = bf16(a*x + b) over
    the conv's whole input (concat and upsample materialized),
    dW[dz, dy, dx, ci, co] = sum_{z,y,x} u[z+dz-1, ci, y+dy-1, x+dx-1] *
    g_v[z, co, y, x] (zero outside): 27 z-batched fp32 matmuls of bf16-valued
    operands over views of one padded copy of ``u``. Returns (3, 3, 3, Cin,
    Cout) fp32."""
    _weight_grad_plain.calls += 1
    u = _full_input(xa, xb, lowres, spatial).float()
    if scale is not None:
        u = u * scale.float()[None, :, None]
    if shift is not None:
        u = u + shift.float()[None, :, None]
    u = u.to(torch.bfloat16)
    Z, Y, X = spatial
    C = u.shape[1]
    up = F.pad(u.reshape(Z, C, Y, X), (1, 1, 1, 1, 0, 0, 1, 1))
    gf = g_v.float().transpose(1, 2)  # (Z, N, Cout)
    taps = []
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                usl = up[dz:dz + Z, :, dy:dy + Y, dx:dx + X].float().reshape(Z, C, Y * X)
                taps.append(torch.bmm(usl, gf).sum(dim=0))
    return torch.stack(taps).reshape(3, 3, 3, C, -1)


for _f in (conv3x3_fused_flat_plain, conv3x3_fused_flat_parts_plain,
           conv3x3_fused_flat_upconv_plain, conv3x3_input_grad_plain,
           conv3x3_fused_flat_res_plain, conv_transpose3x3s2_flat_plain, _weight_grad_plain,
           conv_transpose3x3s2_input_grad_plain, _tconv_weight_grad_plain):
    _f.calls = 0


# ---------------------------------------------------------------------------
# what the kernel is told: tile geometry, halo linearisation, weight packs
# ---------------------------------------------------------------------------

# km_conv3x3's forms (csrc/conv3d.cu: Mode, FMA): the tensor-core conv, with
# the residual summed in its epilogue, over the zero-dilated half-resolution
# source; the fp32-FMA conv; the tensor-core conv kept at the even voxels
FORM_PLAIN, FORM_RES, FORM_TCONV, FORM_FMA, FORM_TDGRAD = 0, 1, 2, 3, 4
FMA_BELOW = 8        # a forward conv of fewer input channels: the FMA kernel
FMA_TILE = (4, 8, 32)    # its output tile (z, y, x) ...
FMA_COUT_BLOCK = 16      # ... and output channels per block
TZ, MBZ, MROWS = 2, 4, 64  # z slabs per tile, 64-row blocks per slab
NVOX_ALLOC = 1600    # halo voxels one shared-memory stage holds


def n_block(cout: int, form: int = FORM_PLAIN) -> int:
    """Output channels one block of the tensor-core kernel takes (the wgmma
    N): the smallest of 8, 16, 32, 64 that holds ``cout``, else 64; the
    residual and transposed forms and the transposed conv's input gradient
    build 32 and 64 only."""
    sizes = (8, 16, 32) if form == FORM_PLAIN else (32,)
    return next((n for n in sizes if cout <= n), 64)


def tile_geometry(X: int) -> dict:
    """The tensor-core kernel's output tile for a volume ``X`` wide: ``tz`` x
    ``ty`` x ``tx`` outputs, their (tz+2) x ``hy`` x ``hx`` halo tile, and
    ``mstride``, the distance in halo voxels between the first rows of a
    slab's 64-row blocks (``hx``: one block per x row; 64: blocks tile the
    linearised slab and rows on halo columns are masked)."""
    if X > 32:
        tx, ty, mstride = 64, 4, 66
    elif X > 16:
        tx, ty, mstride = 32, 7, 64
    else:
        tx, ty, mstride = 16, 14, 64
    return {"tx": tx, "ty": ty, "tz": TZ, "hx": tx + 2, "hy": ty + 2, "hz": TZ + 2,
            "mstride": mstride}


def n_tiles(spatial, geom=None) -> int:
    """Blocks along the volume (the stats buffer's first axis)."""
    Z, Y, X = spatial
    tz, ty, tx = FMA_TILE if geom is None else (geom["tz"], geom["ty"], geom["tx"])
    return -(-X // tx) * -(-Y // ty) * -(-Z // tz)


def halo_linearisation(geom: dict) -> dict:
    """How the kernel's GEMM rows map onto one tile's halo, in halo voxels
    (index ``(lz * hy + ly) * hx + lx``; a voxel is 16 bytes of one 8-channel
    group):

      * ``tap_offsets`` (27,): tap (dz, dy, dx) reads row + this offset;
      * ``block_starts`` (tz * MBZ,): first row of each 64-row block;
      * ``oz``, ``oy``, ``ox`` (tz * MBZ, 64): the output voxel of each row
        within the tile, and ``valid``: whether it lies inside the tile (rows
        on halo columns are computed and dropped).
    """
    hx, hy = geom["hx"], geom["hy"]
    taps = torch.tensor([(dz * hy + dy) * hx + dx
                         for dz in range(3) for dy in range(3) for dx in range(3)])
    slab = torch.arange(geom["tz"]).repeat_interleave(MBZ)
    lin = (torch.arange(MBZ).repeat(geom["tz"]) * geom["mstride"])[:, None] \
        + torch.arange(MROWS)[None, :]
    oy, ox = lin // hx, lin % hx
    return {"tap_offsets": taps, "block_starts": slab * (hy * hx) + lin[:, 0],
            "oz": slab[:, None].expand_as(lin), "oy": oy, "ox": ox,
            "valid": (ox < geom["tx"]) & (oy < geom["ty"])}


def packed_channels(ca: int, cb: int) -> torch.Tensor:
    """The kernel's K axis per tap: source A's ``ca`` channels padded to a
    multiple of 8, then source B's ``cb`` likewise, the whole padded to 16.
    Returns the conv's input channel at each packed position, -1 for padding."""
    cap, cbp = -(-ca // 8) * 8, -(-cb // 8) * 8
    idx = torch.full((-(-(cap + cbp) // 16) * 16,), -1, dtype=torch.long)
    idx[:ca] = torch.arange(ca)
    idx[cap:cap + cb] = ca + torch.arange(cb)
    return idx


def pack_weights(w: torch.Tensor, ca: int, nblk: int) -> torch.Tensor:
    """``bf16(w)`` (3, 3, 3, Cin, Cout) as the tensor-core kernel's B operand:
    (Cout blocks, 16-channel chunks, 2, 27, nblk, 8), i.e. per block and chunk
    one contiguous slab of K-major core matrices [ci/8][tap][co][ci%8], with
    zeros at padded channels (:func:`packed_channels`) and padded ``co``."""
    cin, cout = int(w.shape[3]), int(w.shape[4])
    idx = packed_channels(ca, cin - ca)
    nb = -(-cout // nblk)
    wb = w.to(torch.bfloat16).reshape(27, cin, cout)
    if len(idx) != cin or nb * nblk != cout:
        keep = idx >= 0
        full = torch.zeros((27, len(idx), nb * nblk), dtype=torch.bfloat16, device=w.device)
        full[:, keep.to(w.device), :cout] = wb[:, idx[keep].to(w.device), :]
        wb = full
    return wb.reshape(27, len(idx) // 16, 2, 8, nb, nblk).permute(4, 1, 2, 0, 5, 3).contiguous()


def pack_weights_grad(w: torch.Tensor, nblk: int) -> torch.Tensor:
    """:func:`pack_weights` of the flipped, channel-swapped weights
    w'[tap, co, ci] = w[26 - tap, ci, co]: the cotangent's Cout channels are
    the K axis (one source), Cin the N axis."""
    return pack_weights(w.flip(0, 1, 2).transpose(3, 4), int(w.shape[4]), nblk)


def pack_weights_fma(w: torch.Tensor) -> torch.Tensor:
    """The FMA kernel's weights: bf16-rounded fp32 (Cin, 27, Cout padded
    to its 16-channel block with zeros)."""
    cin, cout = int(w.shape[3]), int(w.shape[4])
    wk = w.to(torch.bfloat16).float().reshape(27, cin, cout).permute(1, 0, 2)
    return F.pad(wk, (0, -cout % FMA_COUT_BLOCK)).contiguous()


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

# csrc/conv3d.cu's entries: their pointers and ints, then the stream
_ARGTYPES = {"km_conv3x3": (10, 16), "km_conv3x3_weight_grad": (7, 11)}


def _fn():
    lib = _build.library()
    if lib.km_conv3x3.argtypes is None:
        for name, (n_ptr, n_int) in _ARGTYPES.items():
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            f.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vec(v: torch.Tensor, n: int, dev, name: str):
    if v.shape != (n,):
        raise ValueError(f"conv3x3: {name} has shape {tuple(v.shape)}, want ({n},)")
    return v.to(device=dev, dtype=torch.float32).contiguous()


def _aligned(X, lowres, sources):
    """Whether the staging may load 16 bytes along x: X a multiple of 8 (16
    for a half-resolution source) and every source 16-byte aligned."""
    return X % (16 if lowres else 8) == 0 and all(t.data_ptr() % 16 == 0 for t in sources)


def _plan(spatial, lowres, sources):
    """(geometry ints, tile count) of a tensor-core launch."""
    geom = tile_geometry(spatial[2])
    vec = _aligned(spatial[2], lowres, sources)
    return (geom["tx"], geom["ty"], geom["mstride"], int(vec)), n_tiles(spatial, geom)


def _sources(name, xa, xb, b_lowres, spatial, extra=()):
    """Check a conv's sources and its further operands for the kernels:
    ``xa`` (None: the transposed conv, whose one source is ``xb``), ``xb``
    (None, at ``spatial``, or at half resolution with ``b_lowres``) and
    ``extra``, full-resolution tensors of any channel count (None: absent).
    One CUDA device, bf16, contiguous flat, shapes that match ``spatial``.
    Returns (Z, Y, X, Ca, Cb)."""
    Z, Y, X = (int(s) for s in spatial)
    ts = [t for t in (xa, xb, *extra) if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: inputs must be on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: inputs must be bfloat16, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous flat (Z, C, Y*X), "
                             f"got {tuple(t.shape)}")
    if xb is not None and b_lowres and (Z % 2 or Y % 2 or X % 2):
        raise ValueError(f"{name}: spatial {spatial} must be even")
    Ca = 0 if xa is None else int(xa.shape[1])
    Cb = 0 if xb is None else int(xb.shape[1])
    wants = [(xa, (Z, Ca, Y * X)),
             (xb, (Z // 2, Cb, (Y // 2) * (X // 2)) if b_lowres else (Z, Cb, Y * X))]
    wants += [(t, (Z, t.shape[1], Y * X)) for t in extra if t is not None]
    for t, want in wants:
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name}: {tuple(t.shape)} does not match spatial {spatial}: "
                             f"want {want}")
    return Z, Y, X, Ca, Cb


def _affine(scale, shift, cin, dev):
    """The kernels' per-channel affine: both fp32 (Cin,) vectors or neither
    (one given: the other is its identity)."""
    if (scale is None) != (shift is None):
        scale = torch.ones(cin, device=dev) if scale is None else scale
        shift = torch.zeros(cin, device=dev) if shift is None else shift
    return (None if scale is None else _vec(scale, cin, dev, "scale"),
            None if shift is None else _vec(shift, cin, dev, "shift"))


def _pack_tconv(wt, ca, nblk):
    # the SAME conv of the dilated input: taps flipped, (Cin, Cout) last
    return pack_weights(wt.flip(2, 3, 4).permute(2, 3, 4, 0, 1), 0, nblk)


def _pack_tdgrad(wt, ca, nblk):
    # the SAME conv of the cotangent onto the transposed conv's input
    # channels: taps as they are, (Cout, Cin) last
    return pack_weights(wt.permute(2, 3, 4, 1, 0), ca, nblk)


class _Form(NamedTuple):
    """How :func:`_launch` runs one mode of the conv."""
    form: int | None  # km_conv3x3's form; None: FORM_FMA below FMA_BELOW input channels, else PLAIN
    lowres: bool      # the second source is read at half resolution
    axes: tuple       # where the weights hold their taps, the sources' channels, the outputs'
    layout: str       # the weights' shape, for errors
    pack: Callable    # (w, Ca, nblk) -> the tensor-core kernel's B operand


_CONV = _Form(None, False, ((0, 1, 2), 3, 4), "(3, 3, 3, {}, Cout)", pack_weights)
_FORMS = {"flat": _CONV, "parts": _CONV, "upconv": _CONV._replace(lowres=True),
          "res": _CONV._replace(form=FORM_RES),
          "tconv": _Form(FORM_TCONV, True, ((2, 3, 4), 0, 1), "({}, Cout, 3, 3, 3)", _pack_tconv),
          "igrad": _Form(FORM_PLAIN, False, ((0, 1, 2), 4, 3), "(3, 3, 3, Cin, {})",
                         lambda w, ca, nblk: pack_weights_grad(w, nblk)),
          "tdgrad": _Form(FORM_TDGRAD, False, ((2, 3, 4), 1, 0), "(Cin, {}, 3, 3, 3)",
                          _pack_tdgrad)}


def _launch(mode, xa, xb, spatial, w, scale, shift, bias, relu, emit_stats, res, ca):
    """Check one mode's operands, pack its weights and launch it on the
    sources' device: the one path to ``km_conv3x3``, which every product of
    the conv family but the weight gradient takes (operands as
    :func:`_forward` takes them)."""
    name = _KERNELS[mode].__name__
    f = _FORMS[mode]
    Z, Y, X, Ca, Cb = _sources(name, xa, xb, f.lowres, spatial, extra=(res,))
    taps, k, n = f.axes
    Cin = Ca + Cb
    if w.dim() != 5 or tuple(w.shape[a] for a in taps) != (3, 3, 3) or w.shape[k] != Cin:
        raise ValueError(f"{name}: w {tuple(w.shape)} is not {f.layout.format(Cin)}")
    Cout = int(w.shape[n])
    if res is not None and res.shape[1] != Cout:
        raise ValueError(f"{name}: the summed operand {tuple(res.shape)} does not have the "
                         f"{Cout} output channels")
    split = Cout if ca is None else int(ca)
    if not 0 < split <= Cout:
        raise ValueError(f"{name}: split {ca} outside (0, {Cout}]")
    form = f.form
    if form is None:  # the shape rule between the two kernels
        form = FORM_FMA if Cin < FMA_BELOW else FORM_PLAIN
    srcs = [t for t in (xa, xb, res) if t is not None]
    dev = srcs[0].device
    w = w.to(device=dev)
    if form == FORM_FMA:
        geom_args, tiles = (0, 0, 0, 0), n_tiles((Z, Y, X))
        wk = pack_weights_fma(w)
        nblk = int(wk.shape[2])
    else:
        geom_args, tiles = _plan((Z, Y, X), f.lowres, srcs)
        nblk = n_block(Cout, form)
        wk = f.pack(w, Ca, nblk)
    scale_t, shift_t = _affine(scale, shift, Cin, dev)
    bias_t = None if bias is None else _vec(bias, Cout, dev, "bias")
    # TDGRAD keeps the even voxels: its output is at half resolution
    out = (torch.empty((Z // 2, Cout, (Y // 2) * (X // 2)), dtype=torch.bfloat16, device=dev)
           if form == FORM_TDGRAD else
           torch.empty((Z, split, Y * X), dtype=torch.bfloat16, device=dev))
    out_b = (torch.empty((Z, Cout - split, Y * X), dtype=torch.bfloat16, device=dev)
             if split < Cout else None)
    stats = (torch.empty((tiles, Cout, 2), dtype=torch.float32, device=dev)
             if emit_stats else None)
    err = _fn().km_conv3x3(
        _ptr(xa), _ptr(xb), _ptr(scale_t), _ptr(shift_t), wk.data_ptr(), _ptr(bias_t), _ptr(res),
        out.data_ptr(), _ptr(out_b), _ptr(stats), Z, Y, X, Ca, Cb, Cout, split, nblk, form,
        int(f.lowres), int(bool(relu)), *geom_args, tiles, _build.stream_ptr(dev))
    _build.check(err, "km_conv3x3")
    if mode == "igrad":
        return out, out_b
    if not emit_stats:
        return out
    sums = torch.sum(stats, dim=0)  # (Cout, 2)
    n = float(Z * Y * X)
    return out, (sums[:, 0] / n, sums[:, 1] / n)


def _forward(mode, plain, xa, xb, spatial, w, scale=None, shift=None, bias=None, relu=False,
             emit_stats=False, res=None, ca=None):
    """Run one mode of the conv and count it: the plain version (asked for,
    or a CPU tensor), else the kernel. Modes: the forward convs ``flat``,
    ``parts`` and ``upconv`` (sources ``xa``, ``xb``), ``res`` (a block's
    last conv, ``res`` its residual), ``tconv`` (the transposed conv of
    ``xb``, ``res`` its skip, ``w`` in ``ConvTranspose3d``'s layout),
    ``igrad`` (the input gradient of the cotangent ``xa``, split at ``ca``)
    and ``tdgrad`` (the transposed conv's input gradient of the cotangent
    ``xa`` at ``spatial``, ``w`` in ``ConvTranspose3d``'s layout)."""
    if plain or (xb if xa is None else xa).device.type == "cpu":
        _PLAINS[mode].calls += 1
        return _plain(mode, xa, xb, spatial, w, scale, shift, bias, relu, emit_stats, res, ca)
    r = _launch(mode, xa, xb, spatial, w, scale, shift, bias, relu, emit_stats, res, ca)
    _KERNELS[mode].launches += 1
    return r


# ---------------------------------------------------------------------------
# the input gradient (kernel B6)
# ---------------------------------------------------------------------------


def conv3x3_input_grad(g_v, spatial, w, ca=None):
    """Input gradient of the 3x3x3 SAME conv with weights ``w``
    (3, 3, 3, Cin, Cout): ``g_u = conv(pad0(g_v); flip(w) with Cin/Cout
    swapped)``, bf16 operands, fp32 sums, bf16 result.

    Args:
        g_v: flat (Z, Cout, Y*X) bf16 cotangent of the conv's pre-ReLU output.
        spatial: (Z, Y, X).
        ca: split the Cin gradient channels at ``ca`` into two tensors (the
            two sources of a parts / upconv conv); None keeps one tensor.
    Returns:
        (g_ua, g_ub): flat bf16 (Z, ca, Y*X) and (Z, Cin - ca, Y*X), both at
        ``spatial``; ``g_ub`` is None without a split.

    CPU tensors run :func:`conv3x3_input_grad_plain`; CUDA tensors launch the
    tensor-core kernel, whatever the channel counts (the pack pads them).
    """
    return _forward("igrad", False, g_v, None, spatial, w, ca=ca)


conv3x3_input_grad.launches = 0


# ---------------------------------------------------------------------------
# the weight gradient (kernel B9)
# ---------------------------------------------------------------------------

WG_VOX = 256            # output voxels of the weight-gradient kernel's plane tile
WG_PLANE_ALLOC = 340    # halo voxels one staged input plane holds
WG_CO_BLOCK = 64        # cotangent channels a block takes (the wgmma M)
WG_PART_CAP = 32 << 20  # bytes of fp32 partial sums the splits may take together
WG_RUN_COST = 2         # a run's start in planes' worth of work (3 input planes staged)


@functools.lru_cache(maxsize=None)
def weight_grad_plan(spatial, ca: int, cb: int, cout: int, n_sm: int = 132) -> dict:
    """How :func:`conv3x3_weight_grad` cuts its work (``csrc/conv3d.cu``
    checks the geometry against its buffers):

      * the plane tile: ``ty`` x ``tx`` = 256 output voxels, its ``hy`` x
        ``hx`` halo; the volume is ``ntx`` x ``nty`` tiles, ``planes`` =
        ntx * nty * Z tile planes in (tile, z) order;
      * ``cip``: the packed input channels (:func:`packed_channels`),
        ``nchunks`` of 16 (the wgmma N); ``cop``: Cout rounded up to
        ``nco`` blocks of 64 (the wgmma M);
      * ``nsplit`` runs of tile planes, run s = [s * planes // nsplit,
        (s + 1) * planes // nsplit), each a block per (Cout block, chunk):
        the count of full waves over ``n_sm`` SMs (one block each) times a
        run's planes is least, with ``part_bytes`` of fp32 partial sums
        under WG_PART_CAP (one run may exceed it) and every run at least
        one plane.
    """
    Z, Y, X = (int(s) for s in spatial)
    tx = 32 if X > 16 else 16
    ty = WG_VOX // tx
    ntx, nty = -(-X // tx), -(-Y // ty)
    planes = ntx * nty * Z
    cip = len(packed_channels(ca, cb))
    nco = -(-cout // WG_CO_BLOCK)
    cop = nco * WG_CO_BLOCK
    blocks = nco * (cip // 16)
    split_bytes = 27 * cip * cop * 4
    most = max(1, min(WG_PART_CAP // split_bytes, planes))

    def cost(s):
        return -(-blocks * s // n_sm) * (-(-planes // s) + WG_RUN_COST)

    nsplit = min(range(1, most + 1), key=lambda s: (cost(s), s))
    return {"tx": tx, "ty": ty, "hx": tx + 2, "hy": ty + 2, "ntx": ntx, "nty": nty,
            "planes": planes, "cip": cip, "nchunks": cip // 16, "nco": nco, "cop": cop,
            "nsplit": nsplit, "blocks": blocks * nsplit, "part_bytes": nsplit * split_bytes}


def conv3x3_weight_grad(xa, xb, spatial, g_v, scale=None, shift=None, lowres=False):
    """Weight gradient of the fused conv over the sources [xa, xb] (``xb``
    None: flat; at ``spatial``: parts; at half resolution with ``lowres``:
    upconv): dW[dz, dy, dx, ci, co] = sum_{z,y,x} u[z+dz-1, ci, y+dy-1,
    x+dx-1] * g_v[z, co, y, x], u = pad0(bf16(scale * x + shift)), bf16
    operands, fp32 sums.

    Args:
        g_v: flat (Z, Cout, Y*X) bf16 cotangent of the conv's pre-ReLU output.
    Returns:
        (3, 3, 3, Cin, Cout) fp32.

    CPU tensors run :func:`_weight_grad_plain`; CUDA tensors launch the
    tensor-core kernel (:func:`weight_grad_plan`) and the kernel that sums
    its splits in order, whatever the channel counts.
    """
    if g_v.device.type == "cpu":
        return _weight_grad_plain(xa, xb, spatial, g_v, scale, shift, lowres)
    out = _launch_weight_grad("conv3x3_weight_grad", xa, xb, spatial, g_v, scale, shift, lowres,
                              False)
    conv3x3_weight_grad.launches += 1
    return out


def conv_transpose3x3s2_weight_grad(x_lo, spatial, g_v):
    """Weight gradient of :func:`conv_transpose3x3s2_flat`:
    dWt[ci, co, kz, ky, kx] = sum_i x[ci, i] * g_v[co, 2i + k - 1] per axis,
    bf16 operands, fp32 sums.

    Args:
        x_lo: flat (Z/2, Cin, Y/2*X/2) bf16, the transposed conv's input.
        g_v: flat (Z, Cout, Y*X) bf16 cotangent of its output at ``spatial``.
    Returns:
        (Cin, Cout, 3, 3, 3) fp32, ``ConvTranspose3d``'s layout.

    CPU tensors run :func:`_tconv_weight_grad_plain`; CUDA tensors launch
    ``tconv3_wgrad_mma_kernel``: the weight gradient's kernel over the
    zero-dilated input (the forward's SAME conv of it with flipped taps), whose
    products with an all-zero input plane or row are not issued, and
    ``tconv3_wgrad_reduce_kernel``, which sums its splits in order.
    """
    if g_v.device.type == "cpu":
        return _tconv_weight_grad_plain(x_lo, spatial, g_v)
    dw = _launch_weight_grad("conv_transpose3x3s2_weight_grad", None, x_lo, spatial, g_v, None,
                             None, True, True)
    conv_transpose3x3s2_weight_grad.launches += 1
    return dw.flip(0, 1, 2).permute(3, 4, 0, 1, 2)


def _launch_weight_grad(name, xa, xb, spatial, g_v, scale, shift, lowres, dil):
    """``km_conv3x3_weight_grad`` over the sources [xa, xb] (``dil``: ``xa``
    None and ``xb`` at half resolution, zero-dilated). Returns (3, 3, 3, Cin,
    Cout) fp32."""
    Z, Y, X, Ca, Cb = _sources(name, xa, xb, lowres, spatial, extra=(g_v,))
    Cout = int(g_v.shape[1])
    dev = g_v.device
    Cin = Ca + Cb
    scale_t, shift_t = _affine(scale, shift, Cin, dev)
    plan = weight_grad_plan((Z, Y, X), Ca, Cb, Cout, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    vec = _aligned(X, lowres, [t for t in (xa, xb, g_v) if t is not None])
    part = torch.empty((plan["nsplit"], 27, plan["cip"], plan["cop"]), dtype=torch.float32,
                       device=dev)
    out = torch.empty((3, 3, 3, Cin, Cout), dtype=torch.float32, device=dev)
    err = _fn().km_conv3x3_weight_grad(
        _ptr(xa), _ptr(xb), _ptr(scale_t), _ptr(shift_t), g_v.data_ptr(), part.data_ptr(),
        out.data_ptr(), Z, Y, X, Ca, Cb, Cout, int(bool(lowres)), int(bool(dil)), plan["tx"],
        int(vec), plan["nsplit"], _build.stream_ptr(dev))
    _build.check(err, "km_conv3x3_weight_grad")
    return out


conv3x3_weight_grad.launches = conv_transpose3x3s2_weight_grad.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _block_sum2(x, spatial):
    """2x2x2 block sums of a flat (Z, C, Y*X) tensor, in fp32: the transpose
    of the nearest x2 upsample. Returns (Z/2, C, Y/2*X/2) fp32."""
    Z, Y, X = spatial
    C = x.shape[1]
    x7 = x.reshape(Z // 2, 2, C, Y // 2, 2, X // 2, 2)
    return x7.sum(dim=(1, 4, 6), dtype=torch.float32).reshape(Z // 2, C, -1)


class _FusedConv(torch.autograd.Function):
    """relu?(conv(pad0(bf16(a*x + b))) + bias) with optional output stats,
    over one or two sources, or with a residual summed before the ReLU (mode
    ``res``); see the module docstring for the backward."""

    @staticmethod
    def forward(ctx, mode, plain, spatial, relu, emit_stats, xa, xb, w, scale,
                shift, bias, res=None):
        spatial = tuple(int(s) for s in spatial)
        ctx.cfg = (mode, plain, spatial, bool(relu), bool(emit_stats))
        ctx.save_for_backward(xa, xb, w, scale, shift, bias, res)
        r = _forward(mode, plain, xa, xb, spatial, w, scale, shift, bias, relu,
                     emit_stats, res=res)
        if emit_stats:
            return r[0], r[1][0], r[1][1]
        return r

    @staticmethod
    def backward(ctx, g_y, g_m=None, g_m2=None):
        mode, plain, spatial, relu, emit_stats = ctx.cfg
        xa, xb, w, scale, shift, bias, res = ctx.saved_tensors
        Z, Y, X = spatial
        ca = int(xa.shape[1])
        lowres = mode == "upconv"

        y = None
        if relu or emit_stats:
            with span("conv.recompute"):
                y = _forward(mode, plain, xa, xb, spatial, w, scale, shift, bias, relu,
                             False, res=res)
        g = g_y.float()
        if emit_stats:
            g = g + stats_cotangent(y, g_m, g_m2)
        if relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        g_v = g.to(torch.bfloat16).contiguous()
        del g, y

        with span("conv.input_grad"):
            igrad = conv3x3_input_grad_plain if plain else conv3x3_input_grad
            g_ua, g_ub = igrad(g_v, spatial, w, ca)

        # the half-resolution source sees the 2x2x2 block sums of g_u
        gb = None
        if xb is not None:
            gb = _block_sum2(g_ub, spatial) if lowres else g_ub.float()
        ga = g_ua.float()

        # mode, plain, spatial, relu, stats, xa, xb, w, a, b, bias, res
        need = ctx.needs_input_grad
        # the residual's cotangent is g_v: the sum's rounding passes straight through
        g_res = g_v.to(res.dtype) if res is not None and need[11] else None
        sa = scale.float() if scale is not None else None
        g_xa = g_xb = None
        if need[5]:
            g_xa = (ga if sa is None else ga * sa[None, :ca, None]).to(xa.dtype)
        if xb is not None and need[6]:
            g_xb = (gb if sa is None else gb * sa[None, ca:, None]).to(xb.dtype)

        def cat(a, b):
            return a if b is None else torch.cat([a, b])

        g_scale = g_shift = g_bias = g_w = None
        if scale is not None and need[8]:
            g_scale = cat((ga * xa.float()).sum(dim=(0, 2)),
                          None if xb is None else (gb * xb.float()).sum(dim=(0, 2)))
            g_scale = g_scale.to(scale.dtype)
        if shift is not None and need[9]:
            g_shift = cat(ga.sum(dim=(0, 2)),
                          None if xb is None else gb.sum(dim=(0, 2))).to(shift.dtype)
        if bias is not None and need[10]:
            g_bias = g_v.sum(dim=(0, 2), dtype=torch.float32).to(bias.dtype)
        del ga, gb
        if need[7]:
            with span("conv.weight_grad"):
                wgrad = _weight_grad_plain if plain else conv3x3_weight_grad
                g_w = wgrad(xa, xb, spatial, g_v, scale, shift, lowres).to(w.dtype)
        return (None, None, None, None, None, g_xa, g_xb, g_w, g_scale, g_shift,
                g_bias, g_res)


def _apply(mode, plain, xa, xb, spatial, w, scale, shift, bias, relu, emit_stats, res=None):
    r = _FusedConv.apply(mode, plain, spatial, relu, emit_stats, xa, xb, w, scale,
                         shift, bias, res)
    return (r[0], (r[1], r[2])) if emit_stats else r


class _TConv(torch.autograd.Function):
    """The transposed 3^3 stride-2 conv of ``x_lo`` with its bias, summed
    with the skip, with optional output stats. Backward (span
    ``km.unet.tconv.bwd``): the stats cotangents fold into the output's as
    ``(g_mean + 2 y g_msq) / n`` (``y``, the stored output, is saved: the
    decoder block keeps it alive as its residual anyway), rounded to bf16
    (``g_v``); the skip's cotangent is ``g_v`` and the bias's its sum; the
    input gradient and the weight gradient are
    :func:`conv_transpose3x3s2_input_grad` and
    :func:`conv_transpose3x3s2_weight_grad` (or their plain versions)."""

    @staticmethod
    def forward(ctx, plain, spatial, emit_stats, x_lo, wt, bias, skip):
        spatial = tuple(int(s) for s in spatial)
        r = _forward("tconv", plain, None, x_lo, spatial, wt, bias=bias, emit_stats=emit_stats,
                     res=skip)
        y = r[0] if emit_stats else r
        ctx.cfg = (plain, spatial, bool(emit_stats))
        ctx.save_for_backward(x_lo, wt, y if emit_stats else None)
        return (y, r[1][0], r[1][1]) if emit_stats else y

    @staticmethod
    def backward(ctx, g_y, g_m=None, g_m2=None):
        plain, spatial, emit_stats = ctx.cfg
        x_lo, wt, y = ctx.saved_tensors
        need = ctx.needs_input_grad  # plain, spatial, stats, x_lo, wt, bias, skip
        with span("unet.tconv.bwd"):
            g = g_y.float()
            if emit_stats:
                g = g + stats_cotangent(y, g_m, g_m2)
            g_v = g.to(torch.bfloat16).contiguous()
            del g
            g_x = g_w = g_bias = None
            if need[3]:
                g_x = (conv_transpose3x3s2_input_grad_plain if plain
                       else conv_transpose3x3s2_input_grad)(g_v, spatial, wt).to(x_lo.dtype)
            if need[4]:
                g_w = (_tconv_weight_grad_plain if plain
                       else conv_transpose3x3s2_weight_grad)(x_lo, spatial, g_v).to(wt.dtype)
            if need[5]:
                g_bias = g_v.sum(dim=(0, 2), dtype=torch.float32)
            g_skip = g_v if need[6] else None
        return None, None, None, g_x, g_w, g_bias, g_skip


def _tconv_apply(plain, x_lo, spatial, wt, bias, skip, emit_stats):
    r = _TConv.apply(plain, spatial, emit_stats, x_lo, wt, bias, skip)
    return (r[0], (r[1], r[2])) if emit_stats else r


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3x3_fused_flat(xf, spatial, w, scale=None, shift=None, bias=None,
                       relu=True, emit_stats=False):
    """relu?(conv3^3_SAME(pad0(scale*x + shift); w) + bias) on flat
    (Z, Cin, Y*X) bf16 ``xf``; ``spatial`` is (Z, Y, X). Returns flat
    (Z, Cout, Y*X) bf16, and with ``emit_stats`` also (mean, msq) per Cout.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    return _apply("flat", False, xf, None, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_fused_flat_parts(xa, xb, spatial, w, scale=None, shift=None,
                             bias=None, relu=True, emit_stats=False):
    """:func:`conv3x3_fused_flat` over the channel concat [xa, xb] of two
    same-resolution flat volumes, without materializing the concat."""
    return _apply("parts", False, xa, xb, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_fused_flat_upconv(xa, xb_lo, spatial, w, scale=None, shift=None,
                              bias=None, relu=True, emit_stats=False):
    """The decoder's upsample + concat + conv: :func:`conv3x3_fused_flat`
    over [xa, nearest_x2(xb_lo)] at ``spatial``, reading the half-resolution
    ``xb_lo`` (Z/2, Cb, Y/2*X/2) directly (neither the upsample nor the
    concat is materialized)."""
    return _apply("upconv", False, xa, xb_lo, spatial, w, scale, shift, bias, relu,
                  emit_stats)


def conv3x3_fused(x, w, scale=None, shift=None, bias=None, relu=True,
                  emit_stats=False):
    """:func:`conv3x3_fused_flat` on a 4-D (Z, Cin, Y, X) volume; returns
    (Z, Cout, Y, X) bf16 (and the stats). A contiguous 4-D tensor is the
    flat tensor, so this is a view onto the same kernel."""
    Z, C, Y, X = (int(s) for s in x.shape)
    r = conv3x3_fused_flat(x.to(torch.bfloat16).reshape(Z, C, Y * X), (Z, Y, X), w,
                           scale, shift, bias, relu, emit_stats)
    if emit_stats:
        return r[0].reshape(Z, -1, Y, X), r[1]
    return r.reshape(Z, -1, Y, X)


# ---------------------------------------------------------------------------
# the residual U-Nets' forms (models/fast_resunet.py)
# ---------------------------------------------------------------------------


def _forward_only(name, *tensors):
    """Refuse a serving kernel without a backward an input that needs a
    gradient (with grad enabled)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only (serving): call it under torch.no_grad()")


def conv3x3_fused_flat_res(xf, spatial, w, scale=None, shift=None, bias=None, relu=True,
                           emit_stats=False, *, residual):
    """A residual block's last conv with the block's sum and ReLU fused:
    ``relu?(bf16(bf16(conv3^3(pad0(scale*x + shift); w) + bias) + residual))``
    on flat (Z, Cin, Y*X) bf16 ``xf``, ``residual`` flat (Z, Cout, Y*X) bf16
    (required: a conv without one is :func:`conv3x3_fused_flat`'s); with
    ``emit_stats`` also the per-Cout (mean, msq) of the stored output.
    Differentiable (``_FusedConv``: the residual's cotangent is the conv's
    ``g_v``). CPU tensors run the plain version; CUDA tensors launch
    ``conv3x3_res_mma_kernel`` (the tensor-core conv, its epilogue reading
    the residual)."""
    if residual is None:
        raise ValueError("conv3x3_fused_flat_res: a residual is required; a conv without one "
                         "is conv3x3_fused_flat's")
    return _apply("res", False, xf, None, spatial, w, scale, shift, bias, relu, emit_stats,
                  res=residual)


def conv_transpose3x3s2_flat(x_lo, spatial, wt, bias=None, skip=None, emit_stats=False):
    """The residual decoder's upsampling: the transposed 3^3 conv, stride 2,
    padding 1, output padding 1 (``ConvTranspose3d`` weights ``wt`` (Cin,
    Cout, 3, 3, 3)), of flat (Z/2, Cin, Y/2*X/2) bf16 ``x_lo`` to the even
    ``spatial`` (Z, Y, X), bf16 operands, fp32 sums, plus the fp32 ``bias``,
    rounded to bf16; with ``skip`` (flat (Z, Cout, Y*X) bf16) the rounded
    sum with it, rounded again (the decoder's join); with ``emit_stats`` also
    the per-Cout (mean, msq) of the stored output. Differentiable
    (``_TConv``). CPU tensors run the plain version; CUDA tensors launch
    ``tconv3_mma_kernel`` (the tensor-core conv over the zero-dilated input,
    ``csrc/conv3d.cu``)."""
    return _tconv_apply(False, x_lo, spatial, wt, bias, skip, emit_stats)


def conv_transpose3x3s2_input_grad(g_v, spatial, wt):
    """Input gradient of :func:`conv_transpose3x3s2_flat`:
    ``g_x[ci, i] = sum_{k, co} wt[ci, co, k] * g_v[co, 2i + k - 1]`` per axis,
    bf16 operands, fp32 sums, bf16 result.

    Args:
        g_v: flat (Z, Cout, Y*X) bf16 cotangent of the output at ``spatial``.
        wt: (Cin, Cout, 3, 3, 3), ``ConvTranspose3d``'s layout.
    Returns:
        flat (Z/2, Cin, Y/2*X/2) bf16.

    CPU tensors run the plain version; CUDA tensors launch
    ``tconv3_dgrad_mma_kernel``: the tensor-core SAME conv of ``g_v`` onto
    the Cin channels (taps as they are) whose epilogue stores the even
    voxels only; the products of odd output planes, and in tiles a row per
    64-row block (X > 32) of odd rows, are not issued.
    """
    return _forward("tdgrad", False, g_v, None, spatial, wt)


for _f in (conv3x3_fused_flat, conv3x3_fused_flat_parts, conv3x3_fused_flat_upconv,
           conv3x3_fused_flat_res, conv_transpose3x3s2_flat, conv_transpose3x3s2_input_grad):
    _f.launches = 0
del _f

# each mode's kernel wrapper and plain version, which count its launches and calls
_KERNELS = {"flat": conv3x3_fused_flat, "parts": conv3x3_fused_flat_parts,
            "upconv": conv3x3_fused_flat_upconv, "res": conv3x3_fused_flat_res,
            "tconv": conv_transpose3x3s2_flat, "igrad": conv3x3_input_grad,
            "tdgrad": conv_transpose3x3s2_input_grad}
_PLAINS = {"flat": conv3x3_fused_flat_plain, "parts": conv3x3_fused_flat_parts_plain,
           "upconv": conv3x3_fused_flat_upconv_plain, "res": conv3x3_fused_flat_res_plain,
           "tconv": conv_transpose3x3s2_flat_plain, "igrad": conv3x3_input_grad_plain,
           "tdgrad": conv_transpose3x3s2_input_grad_plain}
