"""``ij``-ordered coordinate planes: the affine flow as planes, the plain
warp, and the affine register-and-warp path.

Port of ``keymorph_tpu/ops/planes.py``. The warp's semantics are
``torch.nn.functional.grid_sample(mode, padding_mode="border",
align_corners=False)`` on ``ij``-ordered coordinate planes:

  * unnormalize ``v = ((p + 1) * N - 1) / 2`` and clip to [0, N-1];
  * trilinear: 8 corners (clamped), weights multiplied in axis order;
  * nearest: round half to even.

This gather formulation is the plain version of the warp kernel
(``ops/cuda/resample3d.py``), the oracle it is tested against.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch


def affine_flow_planes(inverse_matrix: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    """``ij``-ordered coordinate planes of an affine registration, straight
    from the matrix: plane a is ``m[a, 0] z + m[a, 1] y + m[a, 2] x + m[a, 3]``
    on the linspace(-1, 1) axes, broadcast per axis (no (B, N, 3) grid is
    written and flipped).

    Args:
        inverse_matrix: (B, 4, 4) fixed -> moving matrix.
        spatial: (D, H, W).
    Returns:
        (B, 3, D, H, W) fp32 planes.
    """
    D, H, W = (int(s) for s in spatial)
    m = inverse_matrix.float()
    dev = m.device
    zz = torch.linspace(-1.0, 1.0, D, device=dev)[:, None, None]
    yy = torch.linspace(-1.0, 1.0, H, device=dev)[None, :, None]
    xx = torch.linspace(-1.0, 1.0, W, device=dev)[None, None, :]
    c = m[:, :3, :, None, None, None]  # (B, 3, 4, 1, 1, 1)
    return c[:, :, 0] * zz + c[:, :, 1] * yy + c[:, :, 2] * xx + c[:, :, 3]


def affine_register_warp(inverse_matrix: torch.Tensor, img_m: torch.Tensor,
                         out_spatial: Optional[Sequence[int]] = None, mode: str = "bilinear"):
    """Affine/rigid serving path: :func:`affine_flow_planes`, then the warp
    (``ops.cuda.resample3d.warp_planes``: the kernel on CUDA tensors).
    Returns (warped (B, C, *out_spatial), planes)."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    out_spatial = tuple(out_spatial or img_m.shape[2:])
    planes = affine_flow_planes(inverse_matrix, out_spatial)
    return resample3d.warp_planes(img_m, planes, mode), planes


def planes_to_grid(planes: torch.Tensor) -> torch.Tensor:
    """(B, 3, *S) ``ij`` planes -> (B, *S, 3) ``xy`` grid (the reference
    contract)."""
    return torch.flip(torch.movedim(planes, 1, -1), dims=(-1,))


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """align_corners=False: [-1, 1] -> voxel, then border clip to [0, N-1]."""
    v = ((coord + 1.0) * size - 1.0) / 2.0
    return torch.clamp(v, 0.0, size - 1.0)


def grid_sample_planes(img: torch.Tensor, planes: torch.Tensor,
                       mode: str = "bilinear") -> torch.Tensor:
    """Trilinear/nearest sampling from ``ij``-ordered coordinate planes.

    Args:
        img: (B, C, Z, Y, X).
        planes: (B, 3, D, H, W) normalized coords; plane a indexes axis a.
        mode: "bilinear" (trilinear) or "nearest".
    Returns:
        (B, C, D, H, W) in img's dtype (computed in fp32).
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode}")
    B, C = img.shape[:2]
    spatial = img.shape[2:]
    out_spatial = planes.shape[2:]
    coords = [unnormalize(planes[:, a].float().reshape(B, -1), spatial[a])
              for a in range(3)]
    img_flat = img.reshape(B, C, -1).float()
    strides = (spatial[1] * spatial[2], spatial[2], 1)

    def gather(idx):  # idx (B, N) int64 -> (B, C, N)
        return torch.gather(img_flat, 2, idx[:, None, :].expand(B, C, -1))

    if mode == "nearest":
        idx = sum(
            torch.clamp(torch.round(coords[a]), 0, spatial[a] - 1).long() * strides[a]
            for a in range(3)
        )
        return gather(idx).reshape(B, C, *out_spatial).to(img.dtype)

    lo = [torch.floor(c) for c in coords]
    frac = [c - f for c, f in zip(coords, lo)]
    lo = [f.long() for f in lo]
    out = torch.zeros((B, C, coords[0].shape[1]), dtype=torch.float32,
                      device=img.device)
    for corner in itertools.product((0, 1), repeat=3):
        idx = 0
        w = torch.ones_like(coords[0])
        for a in range(3):
            idx = idx + torch.clamp(lo[a] + corner[a], 0, spatial[a] - 1) * strides[a]
            w = w * (frac[a] if corner[a] else (1.0 - frac[a]))
        out = out + gather(idx) * w[:, None]
    return out.reshape(B, C, *out_spatial).to(img.dtype)
