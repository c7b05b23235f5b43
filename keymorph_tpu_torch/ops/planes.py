"""Plane-based resampling: the plain warp.

Port of ``keymorph_tpu/ops/planes.py:grid_sample_planes``. Semantics are
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

import torch


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
