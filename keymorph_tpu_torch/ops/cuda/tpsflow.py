"""Dense TPS flow planes at the identity grid: ``tps_planes``.

Port of ``keymorph_tpu/ops/pallas/tpsflow.py:tps_planes`` (kernel B4,
identity-grid mode). The CUDA kernel is ``csrc/tpsflow.cu``; the plain
PyTorch version :func:`tps_planes_plain` computes the same function in
chunks of grid points and is what CPU tensors run.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.transforms import solvers

_MAX_T = 2048  # 6*T fp32 control values must fit the 48 KB static smem budget


def _steps(spatial):
    """Per-axis identity-grid step 2/(S-1) in fp32 (0 for a size-1 axis)."""
    return [float(torch.tensor(2.0 / (s - 1) if s > 1 else 0.0,
                               dtype=torch.float32)) for s in spatial]


def tps_planes_plain(theta: torch.Tensor, ctrl: torch.Tensor, spatial: Sequence[int]):
    """Plain PyTorch ``tps_planes``: the spline (``solvers.tps_eval_chunked``)
    at the identity grid ``idx * (2/(S-1)) - 1`` (ij order), returned
    plane-major (B, 3, D, H, W) fp32."""
    tps_planes_plain.calls += 1
    D, H, W = (int(s) for s in spatial)
    B = theta.shape[0]
    sd, sh, sw = _steps((D, H, W))
    n = torch.arange(D * H * W, device=theta.device)
    pts = torch.stack([(n // (H * W)).float() * sd - 1.0,
                       ((n // W) % H).float() * sh - 1.0,
                       (n % W).float() * sw - 1.0], dim=-1)
    moved = solvers.tps_eval_chunked(theta, ctrl, pts.expand(B, -1, 3))
    return moved.transpose(1, 2).reshape(B, 3, D, H, W)


tps_planes_plain.calls = 0


def tps_planes(theta: torch.Tensor, ctrl: torch.Tensor, spatial: Sequence[int]):
    """``ij``-ordered flow planes (B, 3, D, H, W) of a fitted TPS at the
    identity grid: ``moveaxis(tps_eval(theta, ctrl, flat_norm_grid), -1, 1)``
    without a points tensor.

    Args:
        theta: (B, T+4, 3) fp32 from :func:`solvers.fit_tps`.
        ctrl: (B, T, 3) fp32 control points the spline was fitted with.
        spatial: (D, H, W).

    CPU tensors run :func:`tps_planes_plain`; CUDA tensors launch the kernel.
    """
    if theta.device.type == "cpu":
        return tps_planes_plain(theta, ctrl, spatial)
    D, H, W = (int(s) for s in spatial)
    B, T, d = ctrl.shape
    if d != 3 or theta.shape != (B, T + 4, 3):
        raise ValueError(f"tps_planes: theta {tuple(theta.shape)} / ctrl "
                         f"{tuple(ctrl.shape)} are not (B, T+4, 3) / (B, T, 3)")
    if theta.device != ctrl.device or theta.device.type != "cuda":
        raise ValueError("tps_planes: theta and ctrl must be on one CUDA device")
    if theta.dtype != torch.float32 or ctrl.dtype != torch.float32:
        raise TypeError("tps_planes: theta and ctrl must be float32")
    if not (theta.is_contiguous() and ctrl.is_contiguous()):
        raise ValueError("tps_planes: theta and ctrl must be contiguous")
    if T > _MAX_T or B > 65535:
        raise ValueError(f"tps_planes: T={T} > {_MAX_T} or B={B} > 65535")
    out = torch.empty((B, 3, D, H, W), dtype=torch.float32, device=theta.device)
    lib = _fn()
    sd, sh, sw = _steps((D, H, W))
    err = lib.km_tps_planes(theta.data_ptr(), ctrl.data_ptr(), out.data_ptr(),
                            B, T, D, H, W, sd, sh, sw,
                            _build.stream_ptr(theta.device))
    _build.check(err, "km_tps_planes")
    tps_planes.launches += 1
    return out


tps_planes.launches = 0


def _fn():
    lib = _build.library()
    f = lib.km_tps_planes
    if f.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, vp, i, i, i, i, i, fl, fl, fl, vp]
        f.restype = ctypes.c_int
    return lib
