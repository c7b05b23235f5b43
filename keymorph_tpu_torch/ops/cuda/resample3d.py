"""Trilinear / nearest warp from ``ij``-ordered planes: ``warp_planes`` and
its gradient.

Port of ``keymorph_tpu/ops/pallas/resample3d.py:warp_planes`` (kernel B5)
and of its gradient to the planes (kernel B8, ``_grad_kernel`` with the
``_chain_planes`` chain). The CUDA kernels are in ``csrc/resample3d.cu``.
The plain forward :func:`warp_planes_plain` is
:func:`keymorph_tpu_torch.ops.planes.grid_sample_planes`; the plain gradient
:func:`warp_planes_grad_plain` is the same closed form as the kernel, not
PyTorch's autograd through the gather: ``torch.clamp`` passes the whole
gradient at an exact clamp tie where keymorph_tpu (``jnp.clip``) passes
half. CPU tensors run the plain versions through the same
``torch.autograd.Function``.

On CUDA tensors every shape takes the kernels' one path (4 voxels a thread,
256 apart, the ragged end masked; no access needs more than 4-byte
alignment, so a planes view at any storage offset is served as it is); the
wrapper refuses 2^31 or more voxels a channel (32-bit offsets).

The gradient to the image is no kernel of keymorph_tpu either (its XLA VJP):
when the image requires a gradient it is an ``index_add_`` of the eight
weighted corners. A training step never asks for it.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.planes import grid_sample_planes, unnormalize

_MODES = ("bilinear", "nearest")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def warp_planes_plain(img: torch.Tensor, planes: torch.Tensor, mode: str = "bilinear"):
    """Plain PyTorch ``warp_planes`` (the gather formulation), differentiable
    with :func:`warp_planes_grad_plain` as its gradient to the planes."""
    if mode not in _MODES:
        raise ValueError(f"warp_planes: mode {mode!r} not in {_MODES}")
    return _WarpPlanes.apply(img, planes, mode, True)


def _corners(img, planes):
    """Clamped voxel coordinates' floor indices, fractions and the flat
    offsets of the 8 corners (cz, cy, cx in product order), each (B, N)."""
    B = img.shape[0]
    spatial = img.shape[2:]
    v = [unnormalize(planes[:, a].float().reshape(B, -1), spatial[a]) for a in range(3)]
    lo = [torch.floor(c) for c in v]
    frac = [c - f for c, f in zip(v, lo)]
    lo = [f.long() for f in lo]
    strides = (spatial[1] * spatial[2], spatial[2], 1)
    offs = []
    for corner in itertools.product((0, 1), repeat=3):
        offs.append(sum(torch.clamp(lo[a] + corner[a], max=spatial[a] - 1) * strides[a]
                        for a in range(3)))
    return frac, offs


def _chain(planes, spatial):
    """d clamp(unnormalize(p)) / dp per axis, (B, 3, N): S_a / 2 inside the
    border, half of it at an exact clamp tie, 0 outside (``jnp.clip``)."""
    B = planes.shape[0]
    out = []
    for a in range(3):
        s = float(spatial[a])
        v = ((planes[:, a].float().reshape(B, -1) + 1.0) * s - 1.0) / 2.0
        mask = torch.where((v < 0.0) | (v > s - 1.0), 0.0,
                           torch.where((v == 0.0) | (v == s - 1.0), 0.5, 1.0))
        out.append(mask * (s * 0.5))
    return torch.stack(out, dim=1)


def warp_planes_grad_plain(img, planes, g):
    """Plain PyTorch gradient of the trilinear warp to the planes, in closed
    form: per axis sum_c g[c] * sum over the other axes' corner weights of
    (img[hi_a] - img[lo_a]) with hi_a = min(lo_a + 1, S_a - 1), times the
    clamp-and-unnormalize chain. (B, 3, D, H, W) fp32."""
    warp_planes_grad_plain.calls += 1
    B, C = img.shape[:2]
    frac, offs = _corners(img, planes)
    flat = img.reshape(B, C, -1).float()
    v = [torch.gather(flat, 2, o[:, None, :].expand(B, C, -1)) for o in offs]  # k = 4cz+2cy+cx
    (tz, ty, tx) = (f[:, None, :] for f in frac)
    uz, uy, ux = 1.0 - tz, 1.0 - ty, 1.0 - tx
    dz = uy * (ux * (v[4] - v[0]) + tx * (v[5] - v[1])) + ty * (ux * (v[6] - v[2]) + tx * (v[7] - v[3]))
    dy = uz * (ux * (v[2] - v[0]) + tx * (v[3] - v[1])) + tz * (ux * (v[6] - v[4]) + tx * (v[7] - v[5]))
    dx = uz * (uy * (v[1] - v[0]) + ty * (v[3] - v[2])) + tz * (uy * (v[5] - v[4]) + ty * (v[7] - v[6]))
    gf = g.reshape(B, C, -1).float()
    gv = torch.stack([(gf * d).sum(dim=1) for d in (dz, dy, dx)], dim=1)  # (B, 3, N)
    return (gv * _chain(planes, img.shape[2:])).reshape(planes.shape)


warp_planes_plain.calls = 0
warp_planes_grad_plain.calls = 0


def _image_grad(img, planes, g, mode):
    """Gradient of the warp to the image (plain PyTorch): scatter-add of the
    cotangent to the 8 weighted corners (to the one rounded voxel for
    nearest)."""
    B, C = img.shape[:2]
    spatial = img.shape[2:]
    gf = g.reshape(B, C, -1).float()
    out = torch.zeros((B, C, img[0, 0].numel()), dtype=torch.float32, device=img.device)
    if mode == "nearest":
        strides = (spatial[1] * spatial[2], spatial[2], 1)
        idx = sum(torch.clamp(torch.round(unnormalize(planes[:, a].float().reshape(B, -1),
                                                      spatial[a])), 0, spatial[a] - 1).long()
                  * strides[a] for a in range(3))
        out.scatter_add_(2, idx[:, None, :].expand(B, C, -1), gf)
        return out.reshape(img.shape).to(img.dtype)
    frac, offs = _corners(img, planes)
    for k, corner in enumerate(itertools.product((0, 1), repeat=3)):
        w = torch.ones_like(frac[0])
        for a in range(3):
            w = w * (frac[a] if corner[a] else (1.0 - frac[a]))
        out.scatter_add_(2, offs[k][:, None, :].expand(B, C, -1), gf * w[:, None])
    return out.reshape(img.shape).to(img.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


# The kernels index within one channel in 32 bits (source and output alike).
MAX_CHANNEL_VOXELS = 2 ** 31 - 1


def _check(name, img, planes):
    """The sizes (B, C, Z, Y, X, D, H, W) of a warp the kernels take: fewer
    than 2^31 voxels a channel, on one CUDA device, float32, contiguous, any
    B (the kernels walk the batch past the grid's 65535 rows)."""
    if img.dim() != 5 or planes.dim() != 5 or planes.shape[1] != 3:
        raise ValueError(f"{name}: img {tuple(img.shape)} / planes "
                         f"{tuple(planes.shape)} are not (B, C, Z, Y, X) / (B, 3, D, H, W)")
    if planes.shape[0] != img.shape[0]:
        raise ValueError(f"{name}: img and planes batch sizes differ")
    for what, t in (("img", img), ("planes", planes)):
        if math.prod(t.shape[2:]) > MAX_CHANNEL_VOXELS:
            raise ValueError(f"{name}: {what} has {math.prod(t.shape[2:])} voxels a channel, "
                             f"2^31 or more (the kernel's offsets are 32-bit)")
    if img.device != planes.device or img.device.type != "cuda":
        raise ValueError(f"{name}: img and planes must be on one CUDA device")
    if img.dtype != torch.float32 or planes.dtype != torch.float32:
        raise TypeError(f"{name}: img and planes must be float32")
    if not (img.is_contiguous() and planes.is_contiguous()):
        raise ValueError(f"{name}: img and planes must be contiguous")
    return tuple(int(s) for s in img.shape) + tuple(int(s) for s in planes.shape[2:])


def _warp_launch(img, planes, mode):
    B, C, Z, Y, X, D, H, W = _check("warp_planes", img, planes)
    out = torch.empty((B, C, D, H, W), dtype=torch.float32, device=img.device)
    err = _fn().km_warp_planes(img.data_ptr(), planes.data_ptr(), out.data_ptr(),
                               B, C, Z, Y, X, D, H, W, int(mode == "nearest"),
                               _build.stream_ptr(img.device))
    _build.check(err, "km_warp_planes")
    warp_planes.launches += 1
    return out


def warp_planes_grad(img: torch.Tensor, planes: torch.Tensor, g: torch.Tensor):
    """Gradient of the trilinear ``warp_planes(img, planes)`` to ``planes``
    for the output cotangent ``g`` (B, C, D, H, W): (B, 3, D, H, W) fp32,
    with keymorph_tpu's border convention (0 outside, half at an exact clamp
    tie, exactly 0 along an axis at its top edge). CPU tensors run
    :func:`warp_planes_grad_plain`; CUDA tensors launch the kernel."""
    if img.device.type == "cpu":
        return warp_planes_grad_plain(img, planes, g)
    B, C, Z, Y, X, D, H, W = _check("warp_planes_grad", img, planes)
    if g.device != img.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (B, C, D, H, W) or not g.is_contiguous():
        raise ValueError(f"warp_planes_grad: g {tuple(g.shape)} {g.dtype} is not a "
                         f"contiguous float32 {(B, C, D, H, W)} tensor on {img.device}")
    out = torch.empty((B, 3, D, H, W), dtype=torch.float32, device=img.device)
    err = _fn().km_warp_planes_grad(img.data_ptr(), g.data_ptr(), planes.data_ptr(),
                                    out.data_ptr(), B, C, Z, Y, X, D, H, W,
                                    _build.stream_ptr(img.device))
    _build.check(err, "km_warp_planes_grad")
    warp_planes_grad.launches += 1
    return out


warp_planes_grad.launches = 0


class _WarpPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, planes, mode, plain):
        ctx.mode, ctx.plain = mode, plain
        ctx.save_for_backward(img, planes)
        if plain or img.device.type == "cpu":
            warp_planes_plain.calls += 1
            return grid_sample_planes(img, planes, mode=mode)
        return _warp_launch(img, planes, mode)

    @staticmethod
    def backward(ctx, g):
        img, planes = ctx.saved_tensors
        g = g.contiguous()
        g_img = g_planes = None
        if ctx.needs_input_grad[0]:
            g_img = _image_grad(img, planes, g, ctx.mode)
        if ctx.needs_input_grad[1] and ctx.mode == "bilinear":  # nearest: zero
            if ctx.plain or g.device.type == "cpu":
                g_planes = warp_planes_grad_plain(img, planes, g)
            else:
                g_planes = warp_planes_grad(img, planes, g.float())
            g_planes = g_planes.to(planes.dtype)
        return g_img, g_planes, None, None


def warp_planes(img: torch.Tensor, planes: torch.Tensor, mode: str = "bilinear"):
    """Warp ``img`` (B, C, Z, Y, X) at ``planes`` (B, 3, D, H, W).

    Border padding, ``align_corners=False``; ``mode`` is "bilinear"
    (trilinear) or "nearest" (round half to even). Returns (B, C, D, H, W).
    Differentiable in ``planes`` (trilinear; nearest has zero gradient) and
    in ``img``. CPU tensors run :func:`warp_planes_plain`; CUDA tensors
    launch the kernel.
    """
    if mode not in _MODES:
        raise ValueError(f"warp_planes: mode {mode!r} not in {_MODES}")
    return _WarpPlanes.apply(img, planes, mode, False)


warp_planes.launches = 0


def _fn():
    lib = _build.library()
    f = lib.km_warp_planes
    if f.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp] + [i] * 9 + [vp]
        f.restype = ctypes.c_int
        lib.km_warp_planes_grad.argtypes = [vp, vp, vp, vp] + [i] * 8 + [vp]
        lib.km_warp_planes_grad.restype = ctypes.c_int
    return lib
