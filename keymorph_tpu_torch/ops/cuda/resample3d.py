"""Trilinear / nearest warp from ``ij``-ordered planes: ``warp_planes``.

Port of ``keymorph_tpu/ops/pallas/resample3d.py:warp_planes`` (kernel B5).
The CUDA kernel is ``csrc/resample3d.cu``; the plain PyTorch version
:func:`warp_planes_plain` is :func:`keymorph_tpu_torch.ops.planes.grid_sample_planes`
and is what CPU tensors run.
"""

from __future__ import annotations

import ctypes

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.ops.planes import grid_sample_planes

_MODES = ("bilinear", "nearest")


def warp_planes_plain(img: torch.Tensor, planes: torch.Tensor, mode: str = "bilinear"):
    """Plain PyTorch ``warp_planes`` (the gather formulation)."""
    warp_planes_plain.calls += 1
    return grid_sample_planes(img, planes, mode=mode)


warp_planes_plain.calls = 0


def warp_planes(img: torch.Tensor, planes: torch.Tensor, mode: str = "bilinear"):
    """Warp ``img`` (B, C, Z, Y, X) at ``planes`` (B, 3, D, H, W).

    Border padding, ``align_corners=False``; ``mode`` is "bilinear"
    (trilinear) or "nearest" (round half to even). Returns (B, C, D, H, W).
    CPU tensors run :func:`warp_planes_plain`; CUDA tensors launch the kernel.
    """
    if mode not in _MODES:
        raise ValueError(f"warp_planes: mode {mode!r} not in {_MODES}")
    if img.device.type == "cpu":
        return warp_planes_plain(img, planes, mode)
    if img.dim() != 5 or planes.dim() != 5 or planes.shape[1] != 3:
        raise ValueError(f"warp_planes: img {tuple(img.shape)} / planes "
                         f"{tuple(planes.shape)} are not (B, C, Z, Y, X) / (B, 3, D, H, W)")
    B, C, Z, Y, X = (int(s) for s in img.shape)
    D, H, W = (int(s) for s in planes.shape[2:])
    if planes.shape[0] != B:
        raise ValueError("warp_planes: img and planes batch sizes differ")
    if img.device != planes.device or img.device.type != "cuda":
        raise ValueError("warp_planes: img and planes must be on one CUDA device")
    if img.dtype != torch.float32 or planes.dtype != torch.float32:
        raise TypeError("warp_planes: img and planes must be float32")
    if not (img.is_contiguous() and planes.is_contiguous()):
        raise ValueError("warp_planes: img and planes must be contiguous")
    if B > 65535:
        raise ValueError(f"warp_planes: B={B} > 65535")
    out = torch.empty((B, C, D, H, W), dtype=torch.float32, device=img.device)
    lib = _fn()
    err = lib.km_warp_planes(img.data_ptr(), planes.data_ptr(), out.data_ptr(),
                             B, C, Z, Y, X, D, H, W, int(mode == "nearest"),
                             _build.stream_ptr(img.device))
    _build.check(err, "km_warp_planes")
    warp_planes.launches += 1
    return out


warp_planes.launches = 0


def _fn():
    lib = _build.library()
    f = lib.km_warp_planes
    if f.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp] + [i] * 9 + [vp]
        f.restype = ctypes.c_int
    return lib
