"""Fused affine + 3x3x3 SAME conv + bias + ReLU on the flat (Z, C, Y*X)
layout: ``conv3x3_fused_flat`` and its ``_parts`` / ``_upconv`` forms.

Port of ``keymorph_tpu/ops/pallas/conv3d.py`` (kernels B1-B3). The three
public functions keep the JAX package's signatures and layouts:

  * ``xf`` / ``xa`` / ``xb``: flat (Z, C, Y*X) bf16 volumes (one sample);
  * ``w``: (3, 3, 3, Cin, Cout) conv weights (flax ``nn.Conv`` layout);
  * ``scale``/``shift``: optional per-Cin affine applied before the conv
    (the folded GroupNorm), with out-of-volume taps 0 after it;
  * ``bias``: optional per-Cout bias; ``relu``: fused ReLU;
  * ``emit_stats``: also return the per-Cout fp32 (mean, mean-square) of the
    bf16 output, for the next GroupNorm.

One CUDA kernel (``csrc/conv3d.cu``) serves all three. The plain versions
compute keymorph_tpu's ``_conv_xla`` arithmetic: operands rounded to bf16,
lifted to fp32, an fp32 ``conv3d`` (TF32 must be off), output rounded to
bf16. CPU tensors run them; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from keymorph_tpu_torch import _build


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def channel_stats(xf: torch.Tensor):
    """Per-channel fp32 (mean, mean-square) of a flat (Z, C, N) tensor."""
    x = xf.float()
    return x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))


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
    if xf.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("plain conv oracle needs TF32 off: call "
                           "keymorph_tpu_torch.disable_tf32() first")
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


def conv3x3_fused_flat_plain(xf, spatial, w, scale=None, shift=None, bias=None,
                             relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat`."""
    conv3x3_fused_flat_plain.calls += 1
    return _conv_plain(xf, spatial, w, scale, shift, bias, relu, emit_stats)


def conv3x3_fused_flat_parts_plain(xa, xb, spatial, w, scale=None, shift=None,
                                   bias=None, relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat_parts` (materializes the concat)."""
    conv3x3_fused_flat_parts_plain.calls += 1
    return _conv_plain(torch.cat([xa, xb], dim=1), spatial, w, scale, shift,
                       bias, relu, emit_stats)


def conv3x3_fused_flat_upconv_plain(xa, xb_lo, spatial, w, scale=None, shift=None,
                                    bias=None, relu=True, emit_stats=False):
    """Plain PyTorch :func:`conv3x3_fused_flat_upconv` (materializes the
    upsample and the concat)."""
    conv3x3_fused_flat_upconv_plain.calls += 1
    Z, Y, X = spatial
    xb = upsample_nearest_flat(xb_lo, (Z // 2, Y // 2, X // 2), spatial)
    return _conv_plain(torch.cat([xa, xb], dim=1), spatial, w, scale, shift,
                       bias, relu, emit_stats)


for _f in (conv3x3_fused_flat_plain, conv3x3_fused_flat_parts_plain,
           conv3x3_fused_flat_upconv_plain):
    _f.calls = 0


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------


def _fn():
    lib = _build.library()
    f = lib.km_conv3x3
    if f.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 8 + [i] * 9 + [vp]
        f.restype = ctypes.c_int
        lib.km_conv3x3_tiles.argtypes = [i, i, i]
        lib.km_conv3x3_tiles.restype = ctypes.c_int
        lib.km_conv3x3_cout_block.argtypes = []
        lib.km_conv3x3_cout_block.restype = ctypes.c_int
    return lib


def _vec(v: Optional[torch.Tensor], n: int, fill: float, dev, name: str):
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=dev)
    if v.shape != (n,):
        raise ValueError(f"conv3x3: {name} has shape {tuple(v.shape)}, want ({n},)")
    return v.to(device=dev, dtype=torch.float32).contiguous()


def _launch(xa, xb, b_lowres, spatial, w, scale, shift, bias, relu, emit_stats):
    """Check the operands and launch the kernel on ``xa``'s device."""
    Z, Y, X = (int(s) for s in spatial)
    dev = xa.device
    srcs = [xa] if xb is None else [xa, xb]
    for t in srcs:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("conv3x3: inputs must be on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv3x3: inputs must be bfloat16, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"conv3x3: inputs must be contiguous flat (Z, C, Y*X), "
                             f"got {tuple(t.shape)}")
    Ca = int(xa.shape[1])
    if tuple(xa.shape) != (Z, Ca, Y * X):
        raise ValueError(f"conv3x3: xa {tuple(xa.shape)} does not match spatial {spatial}")
    Cb = 0
    if xb is not None:
        Cb = int(xb.shape[1])
        want = ((Z // 2, Cb, (Y // 2) * (X // 2)) if b_lowres else (Z, Cb, Y * X))
        if b_lowres and (Z % 2 or Y % 2 or X % 2):
            raise ValueError(f"conv3x3 upconv: spatial {spatial} must be even")
        if tuple(xb.shape) != want:
            raise ValueError(f"conv3x3: xb {tuple(xb.shape)} is not {want}")
    Cin = Ca + Cb
    if w.shape[:4] != (3, 3, 3, Cin):
        raise ValueError(f"conv3x3: w {tuple(w.shape)} is not (3, 3, 3, {Cin}, Cout)")
    Cout = int(w.shape[4])
    lib = _fn()
    cb = lib.km_conv3x3_cout_block()
    coutp = -(-Cout // cb) * cb
    # bf16-rounded weights, (Cin, 27, Cout) with Cout padded to the block's
    # channel count (zeros) so every block reads whole float4s
    wk = w.to(device=dev).to(torch.bfloat16).float().reshape(27, Cin, Cout)
    wk = F.pad(wk.permute(1, 0, 2), (0, coutp - Cout)).contiguous()
    scale_t = _vec(scale, Cin, 1.0, dev, "scale")
    shift_t = _vec(shift, Cin, 0.0, dev, "shift")
    bias_t = _vec(bias, Cout, 0.0, dev, "bias")
    out = torch.empty((Z, Cout, Y * X), dtype=torch.bfloat16, device=dev)
    stats = None
    if emit_stats:
        stats = torch.empty((lib.km_conv3x3_tiles(Z, Y, X), Cout, 2),
                            dtype=torch.float32, device=dev)
    err = lib.km_conv3x3(
        xa.data_ptr(), xb.data_ptr() if xb is not None else None,
        scale_t.data_ptr(), shift_t.data_ptr(), wk.data_ptr(), bias_t.data_ptr(),
        out.data_ptr(), stats.data_ptr() if stats is not None else None,
        Z, Y, X, Ca, Cb, Cout, coutp, int(b_lowres), int(bool(relu)),
        _build.stream_ptr(dev),
    )
    _build.check(err, "km_conv3x3")
    if not emit_stats:
        return out
    sums = torch.sum(stats, dim=0)  # (Cout, 2)
    n = float(Z * Y * X)
    return out, (sums[:, 0] / n, sums[:, 1] / n)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def conv3x3_fused_flat(xf, spatial, w, scale=None, shift=None, bias=None,
                       relu=True, emit_stats=False):
    """relu?(conv3^3_SAME(pad0(scale*x + shift); w) + bias) on flat
    (Z, Cin, Y*X) bf16 ``xf``; ``spatial`` is (Z, Y, X). Returns flat
    (Z, Cout, Y*X) bf16, and with ``emit_stats`` also (mean, msq) per Cout."""
    if xf.device.type == "cpu":
        return conv3x3_fused_flat_plain(xf, spatial, w, scale, shift, bias, relu,
                                        emit_stats)
    r = _launch(xf, None, False, spatial, w, scale, shift, bias, relu, emit_stats)
    conv3x3_fused_flat.launches += 1
    return r


def conv3x3_fused_flat_parts(xa, xb, spatial, w, scale=None, shift=None,
                             bias=None, relu=True, emit_stats=False):
    """:func:`conv3x3_fused_flat` over the channel concat [xa, xb] of two
    same-resolution flat volumes, without materializing the concat."""
    if xa.device.type == "cpu":
        return conv3x3_fused_flat_parts_plain(xa, xb, spatial, w, scale, shift,
                                              bias, relu, emit_stats)
    r = _launch(xa, xb, False, spatial, w, scale, shift, bias, relu, emit_stats)
    conv3x3_fused_flat_parts.launches += 1
    return r


def conv3x3_fused_flat_upconv(xa, xb_lo, spatial, w, scale=None, shift=None,
                              bias=None, relu=True, emit_stats=False):
    """The decoder's upsample + concat + conv: :func:`conv3x3_fused_flat`
    over [xa, nearest_x2(xb_lo)] at ``spatial``, reading the half-resolution
    ``xb_lo`` (Z/2, Cb, Y/2*X/2) directly (neither the upsample nor the
    concat is materialized)."""
    if xa.device.type == "cpu":
        return conv3x3_fused_flat_upconv_plain(xa, xb_lo, spatial, w, scale, shift,
                                               bias, relu, emit_stats)
    r = _launch(xa, xb_lo, True, spatial, w, scale, shift, bias, relu, emit_stats)
    conv3x3_fused_flat_upconv.launches += 1
    return r


for _f in (conv3x3_fused_flat, conv3x3_fused_flat_parts, conv3x3_fused_flat_upconv):
    _f.launches = 0
del _f
