"""Coordinate-space conversions and grid builders (fp32).

Port of ``keymorph_tpu/ops/coords.py`` (norm and voxel spaces; the
real-world conversions are not ported yet).

Spaces:
  * norm  — [-1, 1] per axis, ``ij`` ordering (first volume axis first);
            -1 <-> -0.5 voxel and +1 <-> N-0.5 voxel (``align_corners=False``).
  * voxel — continuous voxel indices in [-0.5, N-0.5].
"""

from __future__ import annotations

from typing import Sequence

import torch


def convert_points_norm2voxel(points: torch.Tensor, grid_sizes) -> torch.Tensor:
    """[-1, 1] points (..., dim) -> continuous voxel coordinates."""
    sizes = torch.as_tensor(grid_sizes, dtype=points.dtype, device=points.device)
    return (points + 1.0) * sizes / 2.0 - 0.5


def convert_points_voxel2norm(points: torch.Tensor, grid_sizes) -> torch.Tensor:
    """Continuous voxel coordinates (..., dim) -> [-1, 1]."""
    sizes = torch.as_tensor(grid_sizes, dtype=points.dtype, device=points.device)
    return 2.0 * (points + 0.5) / sizes - 1.0


def uniform_norm_grid(spatial_shape: Sequence[int], device=None,
                      dtype=torch.float32) -> torch.Tensor:
    """Meshgrid of ``ij``-ordered points, each axis ``linspace(-1, 1, N)``.

    Endpoints are inclusive: the flow-field evaluation convention, even
    though the resampler is ``align_corners=False`` (replicated from
    keymorph_tpu for parity). Returns (*spatial_shape, dim).
    """
    axes = [torch.linspace(-1.0, 1.0, int(s), device=device, dtype=dtype)
            for s in spatial_shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def flat_norm_grid(spatial_shape: Sequence[int], device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """:func:`uniform_norm_grid` flattened to (1, prod(shape), dim)."""
    dim = len(spatial_shape)
    return uniform_norm_grid(spatial_shape, device, dtype).reshape(1, -1, dim)


def apply_matrix(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (B, d or d+1, d+1) affine matrix to (B, N, d) points (fp32)."""
    d = points.shape[-1]
    m = matrix.float()
    return points.float() @ m[..., :d, :d].transpose(-1, -2) + m[..., None, :d, d]
