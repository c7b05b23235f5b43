"""Coordinate-space conversions and grid builders (fp32).

Port of ``keymorph_tpu/ops/coords.py``.

Spaces:
  * norm  — [-1, 1] per axis, ``ij`` ordering (first volume axis first);
            -1 <-> -0.5 voxel and +1 <-> N-0.5 voxel (``align_corners=False``).
  * voxel — continuous voxel indices in [-0.5, N-0.5].
  * real  — scanner (world) coordinates in millimetres, through a NIfTI-style
            (d+1, d+1) voxel -> world affine.

The real-world conversions take batched affines (B, d+1, d+1) and points
(B, N, d). Inverting an affine uses ``torch.linalg.inv_ex``: ``inv`` checks
for a singular matrix by synchronizing the host with the card.
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


def homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append a trailing 1: (..., N, d) -> (..., N, d+1)."""
    ones = torch.ones((*points.shape[:-1], 1), dtype=points.dtype, device=points.device)
    return torch.cat([points, ones], dim=-1)


def convert_points_voxel2real(points: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Voxel coordinates (B, N, d) -> real-world, through the (B, d+1, d+1)
    voxel -> world ``affine``."""
    return (homogeneous(points) @ affine.to(points.dtype).transpose(-1, -2))[..., :-1]


def convert_points_real2voxel(points: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Real-world points (B, N, d) -> voxel coordinates, through the inverse
    of the (B, d+1, d+1) voxel -> world ``affine``."""
    inv = torch.linalg.inv_ex(affine.to(points.dtype))[0]
    return (homogeneous(points) @ inv.transpose(-1, -2))[..., :-1]


def convert_points_norm2real(points, affine, grid_sizes):
    """norm -> voxel -> real."""
    return convert_points_voxel2real(convert_points_norm2voxel(points, grid_sizes), affine)


def convert_points_real2norm(points, affine, grid_sizes):
    """real -> voxel -> norm."""
    return convert_points_voxel2norm(convert_points_real2voxel(points, affine), grid_sizes)


def convert_flow_voxel2norm(flow: torch.Tensor, dim_sizes) -> torch.Tensor:
    """Dense flow in voxel units (..., dim) -> [-1, 1] along the last axis;
    ``flow[..., i]`` indexes the axis of size ``dim_sizes[i]``."""
    sizes = torch.as_tensor(dim_sizes, dtype=flow.dtype, device=flow.device)
    return 2.0 * (flow + 0.5) / sizes - 1.0


def uniform_voxel_grid(spatial_shape: Sequence[int], device=None) -> torch.Tensor:
    """Integer meshgrid of voxel indices, ``ij`` ordering:
    (*spatial_shape, dim) fp32."""
    axes = [torch.arange(int(s), device=device, dtype=torch.float32) for s in spatial_shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


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
