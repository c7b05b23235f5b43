"""The residual U-Nets' one-pass kernels on the flat (Z, C, Y*X) layout:
``lift1x1_flat`` (a block's 1x1 lift with its bias and output statistics),
``scse_gate_flat`` (the concurrent scSE gate) and ``maxpool2_flat`` (the
encoders' 2x max-pool), and their plain versions.

The lift is the block's ``conv1`` where the widths change: bf16 operands, an
fp32 sum and the bias, one rounding to bf16, as the bf16 ``Conv3d`` module
computes it, plus the per-channel fp32 (mean, mean-square) of the stored
values for the next GroupNorm.

The gate (Roy, Navab and Wachinger, MICCAI 2018; ``models/unet.py``'s
``ChannelSpatialSE``) is ``max(x * g_c, x * g_s)``: a channel gate g_c (C,)
from the volume's per-channel mean through fc1 -> ReLU -> fc2 -> sigmoid, and
a spatial gate g_s per voxel, the sigmoid of a 1x1 conv C -> 1. The kernel
(``csrc/resblock.cu``) reads the block output once, forms g_s, and writes the
gated values once, in the bf16 module's rounding order; the squeeze comes
from the caller (the stats the block's last conv emits) and the MLP on (C,)
is the module's own ``ChannelSE.gate``.

All are forward only: the residual U-Nets train through their modules, and
the DoubleConv executor pools through ``maxpool2_amax``, the differentiable
reshape-and-``amax``, where a gradient is needed. CPU tensors run the plain
versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.cuda.conv3d import _forward_only


SLAB_ELEMS = 1 << 26  # fp32 elements a slab of the plain lift holds


def _lib():
    lib = _build.library()
    if lib.km_scse_gate.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.km_scse_gate.argtypes = [vp] * 4 + [i] * 2 + [ctypes.c_longlong, vp]
        lib.km_scse_gate.restype = ctypes.c_int
        lib.km_lift1x1.argtypes = [vp] * 5 + [i] * 4 + [ctypes.c_longlong, vp]
        lib.km_lift1x1.restype = ctypes.c_int
        lib.km_maxpool2.argtypes = [vp] * 2 + [i] * 4 + [vp]
        lib.km_maxpool2.restype = ctypes.c_int
    return lib


def lift1x1_flat_plain(xf, w, b):
    """Plain PyTorch :func:`lift1x1_flat`: an fp32 matmul of the bf16 values
    in Z-slabs (no fp32 tensor of the whole output), the stats from the
    rounded slabs."""
    lift1x1_flat_plain.calls += 1
    Z, cin, N = xf.shape
    wf = w.to(torch.bfloat16).float()
    bf = b.to(torch.bfloat16).float()[:, None]
    cout = wf.shape[0]
    out = torch.empty((Z, cout, N), dtype=torch.bfloat16, device=xf.device)
    s1 = torch.zeros(cout, dtype=torch.float32, device=xf.device)
    s2 = torch.zeros_like(s1)
    n = max(1, SLAB_ELEMS // (cout * N))
    for z0 in range(0, Z, n):
        y = (torch.matmul(wf, xf[z0:z0 + n].float()) + bf).to(torch.bfloat16)
        out[z0:z0 + n] = y
        f = y.float()
        s1 += f.sum(dim=(0, 2))
        s2 += (f * f).sum(dim=(0, 2))
    count = float(Z * N)
    return out, (s1 / count, s2 / count)


def lift1x1_flat(xf, w, b):
    """The 1x1 conv ``w`` (Cout, Cin) with bias ``b`` (Cout,) of flat
    (Z, Cin, Y*X) bf16 ``xf``: ``bf16(bf16(w) @ x + bf16(b))`` with fp32 sums.
    Returns (out (Z, Cout, Y*X) bf16, (mean, mean-square) per Cout in fp32)."""
    _forward_only("lift1x1_flat", xf, w, b)
    if xf.device.type == "cpu":
        return lift1x1_flat_plain(xf, w, b)
    if xf.dtype != torch.bfloat16 or xf.dim() != 3 or not xf.is_contiguous():
        raise ValueError(f"lift1x1_flat: want a contiguous flat bf16 (Z, Cin, Y*X), got "
                         f"{xf.dtype} {tuple(xf.shape)}")
    Z, cin, N = (int(s) for s in xf.shape)
    if w.dim() != 2 or w.shape[1] != cin or b.shape != (w.shape[0],):
        raise ValueError(f"lift1x1_flat: w {tuple(w.shape)}, b {tuple(b.shape)} for Cin {cin}")
    cout = int(w.shape[0])
    coutp = -(-cout // 8) * 8
    # the kernel's weights: transposed (Cin, Cout) and, with the bias,
    # zero-padded to a multiple of 8 channels
    wk = F.pad(w.to(device=xf.device, dtype=torch.bfloat16).float().t(), (0, coutp - cout))
    bk = F.pad(b.to(device=xf.device, dtype=torch.bfloat16).float(), (0, coutp - cout))
    wk, bk = wk.contiguous(), bk.contiguous()
    out = torch.empty((Z, cout, N), dtype=torch.bfloat16, device=xf.device)
    stats = torch.empty((-(-N // 1024) * Z, cout, 2), dtype=torch.float32, device=xf.device)
    err = _lib().km_lift1x1(xf.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                            stats.data_ptr(), Z, cin, cout, coutp, N,
                            _build.stream_ptr(xf.device))
    _build.check(err, "km_lift1x1")
    lift1x1_flat.launches += 1
    sums = stats.sum(dim=0)
    count = float(Z * N)
    return out, (sums[:, 0] / count, sums[:, 1] / count)


def maxpool2_amax(xf, spatial):
    """2x max-pool (VALID, floor) of a flat (Z, C, Y*X) tensor by reshape
    and ``amax``, uncounted. Differentiable: its backward splits the gradient
    evenly among tied maxima (every all-zero window after a ReLU is such a
    tie), as keymorph_tpu's ``_maxpool2_rw_bwd`` does."""
    Z, Y, X = spatial
    C = xf.shape[1]
    Zh, Yh, Xh = Z // 2, Y // 2, X // 2
    x4 = xf.reshape(Z, C, Y, X)[: 2 * Zh, :, : 2 * Yh, : 2 * Xh]
    p = x4.reshape(Zh, 2, C, Yh, 2, Xh, 2).amax(dim=(1, 4, 6))
    return p.reshape(Zh, C, Yh * Xh).contiguous(), (Zh, Yh, Xh)


def maxpool2_flat_plain(xf, spatial):
    """Plain PyTorch :func:`maxpool2_flat`: :func:`maxpool2_amax`, counted."""
    maxpool2_flat_plain.calls += 1
    return maxpool2_amax(xf, spatial)


def maxpool2_flat(xf, spatial):
    """2x max-pool (VALID, floor) of a flat (Z, C, Y*X) bf16 tensor at
    ``spatial``: (pooled flat tensor, its spatial size). NaN propagates."""
    _forward_only("maxpool2_flat", xf)
    if xf.device.type == "cpu":
        return maxpool2_flat_plain(xf, spatial)
    Z, Y, X = (int(d) for d in spatial)
    C = int(xf.shape[1])
    if xf.dtype != torch.bfloat16 or not xf.is_contiguous() or tuple(xf.shape) != (Z, C, Y * X):
        raise ValueError(f"maxpool2_flat: want a contiguous bf16 ({Z}, C, {Y * X}), got "
                         f"{xf.dtype} {tuple(xf.shape)}")
    Zh, Yh, Xh = Z // 2, Y // 2, X // 2
    out = torch.empty((Zh, C, Yh * Xh), dtype=torch.bfloat16, device=xf.device)
    err = _lib().km_maxpool2(xf.data_ptr(), out.data_ptr(), Z, C, Y, X,
                             _build.stream_ptr(xf.device))
    _build.check(err, "km_maxpool2")
    maxpool2_flat.launches += 1
    return out, (Zh, Yh, Xh)


def scse_gate_flat_plain(xf, se, mean=None):
    """The module ``se`` (a ``ChannelSpatialSE``) on the flat (Z, C, Y*X)
    tensor, viewed as (1, C, Z, 1, Y*X); ``mean`` is not used (the module
    takes its own)."""
    scse_gate_flat_plain.calls += 1
    Z, C, N = xf.shape
    y = se(xf.permute(1, 0, 2)[None, :, :, None, :])
    return y[0, :, :, 0, :].permute(1, 0, 2).contiguous()


def scse_gate_flat(xf, se, mean=None):
    """The scSE gate ``se`` (a bf16 ``ChannelSpatialSE``) of flat (Z, C,
    Y*X) bf16 ``xf``; ``mean`` is its fp32 per-channel mean (C,) if the
    caller holds it (a conv's emitted stats), else it is taken here. CPU
    tensors run the plain version; CUDA tensors launch ``scse_gate_kernel``."""
    _forward_only("scse_gate_flat", xf, *se.parameters())
    if xf.device.type == "cpu":
        return scse_gate_flat_plain(xf, se, mean)
    if xf.dtype != torch.bfloat16 or xf.dim() != 3 or not xf.is_contiguous():
        raise ValueError(f"scse_gate_flat: want a contiguous flat bf16 (Z, C, Y*X), got "
                         f"{xf.dtype} {tuple(xf.shape)}")
    Z, C, N = (int(s) for s in xf.shape)
    if mean is None:
        mean = torch.sum(xf, dim=(0, 2), dtype=torch.float32) / float(Z * N)
    g_c = se.cSE.gate(mean.float()[None])[0].float().contiguous()
    conv = se.sSE.conv
    # the spatial gate's 1x1 weights and its bias, rounded as the module's conv
    ws = torch.cat([conv.weight.reshape(C), conv.bias.reshape(1)]).to(
        device=xf.device, dtype=torch.bfloat16).float().contiguous()
    out = torch.empty_like(xf)
    err = _lib().km_scse_gate(xf.data_ptr(), g_c.data_ptr(), ws.data_ptr(), out.data_ptr(), Z, C, N,
                           _build.stream_ptr(xf.device))
    _build.check(err, "km_scse_gate")
    scse_gate_flat.launches += 1
    return out


scse_gate_flat.launches = lift1x1_flat.launches = maxpool2_flat.launches = 0
scse_gate_flat_plain.calls = lift1x1_flat_plain.calls = maxpool2_flat_plain.calls = 0
