"""The residual U-Nets' one-pass kernels on the flat (Z, C, Y*X) layout:
``lift1x1_flat`` (a block's 1x1 lift with its bias and output statistics),
``scse_gate_flat`` (the concurrent scSE gate) with ``scse_gate_bwd`` (its
backward) and ``maxpool2_flat`` (the encoders' 2x max-pool), and their plain
versions.

The lift is the block's ``conv1`` where the widths change: bf16 operands, an
fp32 sum and the bias, one rounding to bf16, as the bf16 ``Conv3d`` module
computes it, plus the per-channel fp32 (mean, mean-square) of the stored
values for the next GroupNorm. It is differentiable (``_Lift``); its backward
(span ``km.unet.residual.bwd``) folds the stats cotangents into the output's,
rounds that to bf16 (``g_v``) and takes fp32 products of the bf16 values
(``torch.matmul``, TF32 off): ``g_x = bf16(W^T g_v)``, ``g_W = g_v x^T``,
``g_b = sum g_v``.

The gate (Roy, Navab and Wachinger, MICCAI 2018; ``models/unet.py``'s
``ChannelSpatialSE``) is ``max(x * g_c, x * g_s)``: a channel gate g_c (C,)
from the volume's per-channel mean through fc1 -> ReLU -> fc2 -> sigmoid, and
a spatial gate g_s per voxel, the sigmoid of a 1x1 conv C -> 1. The kernel
(``csrc/resblock.cu``) reads the block output once, forms g_s, and writes the
gated values once, in the bf16 module's rounding order; the squeeze comes
from the caller (the stats the block's last conv emits) and the MLP on (C,)
is the module's own ``ChannelSE.gate``. It is differentiable on the card
(``_ScseGate``, span ``km.unet.se.bwd``): ``scse_gate_bwd`` is one pass over
the output's cotangent and the block output (the input gradient, and the
per-channel sums for g_c and the spatial gate's weights and bias); the MLP on
(C,) runs under autograd as the module's, whose backward hands the squeeze
its cotangent, which reaches the block output through the stats it came
from. Ties of the two gated values split the gradient evenly, as
``torch.maximum``'s autograd.

The pool is forward only: where a gradient is needed the executors pool
through ``maxpool2_amax``, the differentiable reshape-and-``amax``. CPU
tensors run the plain versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.cuda.conv3d import _forward_only, stats_cotangent
from keymorph_tpu_torch.tracing import span


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
        lib.km_scse_gate_bwd.argtypes = [vp] * 6 + [i] * 3 + [ctypes.c_longlong, vp]
        lib.km_scse_gate_bwd.restype = ctypes.c_int
    return lib


def lift1x1_flat_plain(xf, w, b):
    """Plain PyTorch :func:`lift1x1_flat`: an fp32 matmul of the bf16 values
    in Z-slabs (no fp32 tensor of the whole output), the stats from the
    rounded slabs (differentiable, with the same backward)."""
    return _lift_apply(True, xf, w, b)


def _lift_plain(xf, w, b):
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
    Returns (out (Z, Cout, Y*X) bf16, (mean, mean-square) per Cout in fp32).
    Differentiable (``_Lift``). CPU tensors run the plain version; CUDA
    tensors launch ``lift1x1_kernel``."""
    return _lift_apply(False, xf, w, b)


def _lift_kernel(xf, w, b):
    if xf.device.type == "cpu":
        return _lift_plain(xf, w, b)
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


class _Lift(torch.autograd.Function):
    """The lift with its output stats; see the module docstring for the
    backward. The output is saved for the stats term: the block keeps it
    alive as its residual anyway."""

    @staticmethod
    def forward(ctx, plain, xf, w, b):
        out, (mean, msq) = (_lift_plain if plain else _lift_kernel)(xf, w, b)
        ctx.save_for_backward(xf, w, out)
        return out, mean, msq

    @staticmethod
    def backward(ctx, g_out, g_m, g_m2):
        xf, w, out = ctx.saved_tensors
        need = ctx.needs_input_grad  # plain, xf, w, b
        with span("unet.residual.bwd"):
            g = g_out.float() + stats_cotangent(out, g_m, g_m2)
            g_v = g.to(torch.bfloat16).float()
            del g
            g_x = g_w = g_b = None
            if need[1]:
                wb = w.to(torch.bfloat16).float().t()  # (Cin, Cout)
                g_x = torch.matmul(wb, g_v).to(xf.dtype)
            if need[2]:
                g_w = torch.bmm(g_v, xf.float().transpose(1, 2)).sum(dim=0).to(w.dtype)
            if need[3]:
                g_b = g_v.sum(dim=(0, 2))
        return None, g_x, g_w, g_b


def _lift_apply(plain, xf, w, b):
    out, mean, msq = _Lift.apply(plain, xf, w, b)
    return out, (mean, msq)


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
    ``spatial``: (pooled flat tensor, its spatial size). NaN propagates.
    Forward only (:func:`maxpool2_amax` is the differentiable pool)."""
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


def _spatial_operands(se, C, dev):
    """The spatial gate's 1x1 weights and its bias (C + 1,), rounded as the
    module's conv."""
    conv = se.sSE.conv
    return torch.cat([conv.weight.reshape(C), conv.bias.reshape(1)]).to(
        device=dev, dtype=torch.bfloat16).float()


def _gate_kernel(xf, g_c, ws):
    if xf.dtype != torch.bfloat16 or xf.dim() != 3 or not xf.is_contiguous():
        raise ValueError(f"scse_gate_flat: want a contiguous flat bf16 (Z, C, Y*X), got "
                         f"{xf.dtype} {tuple(xf.shape)}")
    Z, C, N = (int(s) for s in xf.shape)
    g_c, ws = g_c.float().contiguous(), ws.float().contiguous()
    out = torch.empty_like(xf)
    err = _lib().km_scse_gate(xf.data_ptr(), g_c.data_ptr(), ws.data_ptr(), out.data_ptr(), Z, C, N,
                              _build.stream_ptr(xf.device))
    _build.check(err, "km_scse_gate")
    scse_gate_flat.launches += 1
    return out


def scse_gate_flat(xf, se, mean=None):
    """The scSE gate ``se`` (a bf16 ``ChannelSpatialSE``) of flat (Z, C,
    Y*X) bf16 ``xf``; ``mean`` is its fp32 per-channel mean (C,) if the
    caller holds it (a conv's emitted stats, which then take the squeeze's
    cotangent), else it is taken here. CPU tensors run the plain version (the
    module, under its own autograd); CUDA tensors launch ``scse_gate_kernel``
    on the channel gate from the module's ``ChannelSE.gate`` (autograd's, on
    (C,)) through ``_ScseGate``, whose backward launches
    ``scse_gate_bwd_kernel``."""
    if xf.device.type == "cpu":
        return scse_gate_flat_plain(xf, se, mean)
    Z, C, N = xf.shape
    if mean is None:
        mean = torch.sum(xf, dim=(0, 2), dtype=torch.float32) / float(Z * N)
    return _ScseGate.apply(xf, se.cSE.gate(mean.float()[None])[0],
                           _spatial_operands(se, C, xf.device))


class _ScseGate(torch.autograd.Function):
    """:func:`scse_gate_flat`'s pass on the card, over the block output, the
    channel gate and the spatial gate's operands; see the module docstring
    for the backward."""

    @staticmethod
    def forward(ctx, xf, g_c, ws):
        ctx.save_for_backward(xf, g_c, ws)
        return _gate_kernel(xf, g_c, ws)

    @staticmethod
    def backward(ctx, g_out):
        xf, g_c, ws = ctx.saved_tensors
        with span("unet.se.bwd"):
            g_x, g_gc, g_ws = scse_gate_bwd(xf, g_c.float(), ws, g_out.contiguous())
        return g_x, g_gc, g_ws


def scse_gate_bwd_plain(xf, g_c, ws, g):
    """Plain PyTorch :func:`scse_gate_bwd`: the same arithmetic in fp32 over
    the whole volume."""
    scse_gate_bwd_plain.calls += 1
    Z, C, N = xf.shape
    x = xf.float()
    s = torch.einsum("c,zcn->zn", ws[:C], x)
    ss = (s + ws[C]).to(torch.bfloat16).float()
    gs = torch.sigmoid(ss).to(torch.bfloat16).float()[:, None]  # (Z, 1, N)
    a = (x * g_c[None, :, None]).to(torch.bfloat16).float()
    b = (x * gs).to(torch.bfloat16).float()
    wc = (a > b).float() + 0.5 * (a == b).float()  # torch.maximum's split of ties
    go = g.float()
    d_gs = (go * (1.0 - wc) * x).sum(dim=1, keepdim=True)
    d_ss = d_gs * gs * (1.0 - gs)  # (Z, 1, N)
    g_x = go * wc * g_c[None, :, None] + go * (1.0 - wc) * gs + ws[:C][None, :, None] * d_ss
    g_gc = (go * wc * x).sum(dim=(0, 2))
    g_ws = torch.cat([(d_ss * x).sum(dim=(0, 2)), d_ss.sum().reshape(1)])
    return g_x.to(torch.bfloat16), g_gc, g_ws


def scse_gate_bwd(xf, g_c, ws, g):
    """Backward of the gate's pass ``out = max(bf16(x g_c), bf16(x g_s))``,
    ``g_s = bf16(sigmoid(bf16(ws[:C] . x + ws[C])))``, for the output's
    cotangent ``g``, every rounding passed straight through and ties split
    evenly.

    Args:
        xf, g: flat (Z, C, Y*X) bf16, the block output and the cotangent.
        g_c: (C,) fp32 channel gate; ws: (C + 1,) fp32, the spatial gate's
            bf16-rounded weights and bias (the forward's operands).
    Returns:
        (g_x flat bf16, g_gc (C,) fp32, g_ws (C + 1,) fp32).

    CPU tensors run the plain version; CUDA tensors launch
    ``scse_gate_bwd_kernel``: one read of ``x`` and ``g`` from device memory
    and one write of ``g_x``, each block's per-channel partial sums added in
    block order afterwards (no atomics).
    """
    if xf.device.type == "cpu":
        return scse_gate_bwd_plain(xf, g_c, ws, g)
    for t in (xf, g):
        if t.dtype != torch.bfloat16 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"scse_gate_bwd: want contiguous flat bf16 (Z, C, Y*X), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if g.shape != xf.shape or g_c.shape != (xf.shape[1],) or ws.shape != (xf.shape[1] + 1,):
        raise ValueError(f"scse_gate_bwd: x {tuple(xf.shape)}, g {tuple(g.shape)}, "
                         f"g_c {tuple(g_c.shape)}, ws {tuple(ws.shape)}")
    Z, C, N = (int(s) for s in xf.shape)
    blocks = -(-N // 256)
    g_c, ws = g_c.float().contiguous(), ws.float().contiguous()
    g_x = torch.empty_like(xf)
    part = torch.empty((Z * blocks, 2 * C + 1), dtype=torch.float32, device=xf.device)
    err = _lib().km_scse_gate_bwd(xf.data_ptr(), g.data_ptr(), g_c.data_ptr(), ws.data_ptr(),
                                  g_x.data_ptr(), part.data_ptr(), Z, C, blocks, N,
                                  _build.stream_ptr(xf.device))
    _build.check(err, "km_scse_gate_bwd")
    scse_gate_bwd.launches += 1
    sums = part.sum(dim=0)
    return g_x, sums[:C], sums[C:]


scse_gate_flat.launches = lift1x1_flat.launches = maxpool2_flat.launches = 0
scse_gate_bwd.launches = 0
scse_gate_flat_plain.calls = lift1x1_flat_plain.calls = maxpool2_flat_plain.calls = 0
scse_gate_bwd_plain.calls = 0
