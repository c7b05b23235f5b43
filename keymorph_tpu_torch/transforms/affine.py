"""Affine transform primitive: dense flow-field generation (2D and 3D) and
the matrix container.

Port of ``keymorph_tpu/transforms/affine.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from keymorph_tpu_torch.ops import coords


def affine_flow(inverse_matrix: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """Dense ``xy``-ordered sampling grid of an affine registration: the
    fixed -> moving (inverse) matrix at every point of the ``ij``
    linspace(-1, 1) meshgrid, last axis flipped to ``xy`` for the resampler.

    Args:
        inverse_matrix: (B, d+1, d+1) fixed -> moving matrix.
        spatial_shape: output spatial sizes, length d.
    Returns:
        (B, *spatial_shape, d) grid in [-1, 1], ``xy``-ordered.
    """
    d = len(spatial_shape)
    B = inverse_matrix.shape[0]
    grid = coords.flat_norm_grid(spatial_shape, device=inverse_matrix.device)
    moved = coords.apply_matrix(inverse_matrix, grid.expand(B, -1, d))
    return torch.flip(moved.reshape(B, *spatial_shape, d), dims=(-1,))


class AffineTransform:
    """Matrix container keeping the forward and inverse matrices consistent:
    ``transform_matrix`` maps moving -> fixed points, and
    ``inverse_transform_matrix`` (fixed -> moving) builds the sampling grid.
    Give exactly one of ``matrix`` and ``inverse_matrix`` (B, d+1, d+1)."""

    def __init__(self, matrix=None, inverse_matrix=None, dim: int = 3):
        self.dim = dim
        if matrix is not None and inverse_matrix is None:
            self.transform_matrix = torch.as_tensor(matrix).float()
            self.inverse_transform_matrix = torch.linalg.inv_ex(self.transform_matrix)[0]
        elif matrix is None and inverse_matrix is not None:
            self.inverse_transform_matrix = torch.as_tensor(inverse_matrix).float()
            self.transform_matrix = torch.linalg.inv_ex(self.inverse_transform_matrix)[0]
        else:
            raise ValueError("Provide exactly one of matrix or inverse_matrix")

    def affine_grid(self, grid_shape) -> torch.Tensor:
        """``ij``-ordered transformed grid; ``grid_shape`` is (B, C, *S)."""
        return torch.flip(self.get_flow_field(grid_shape), dims=(-1,))

    def get_flow_field(self, grid_shape, **kwargs) -> torch.Tensor:
        """``xy``-ordered sampling grid for ``align_img``; ``grid_shape`` is
        (B, C, *S)."""
        return affine_flow(self.inverse_transform_matrix, tuple(grid_shape[2:]))

    def get_forward_transformed_points(self, points: torch.Tensor) -> torch.Tensor:
        """p_f = A p_m."""
        return coords.apply_matrix(self.transform_matrix, points)

    def get_inverse_transformed_points(self, points: torch.Tensor) -> torch.Tensor:
        """p_m = A^-1 p_f."""
        return coords.apply_matrix(self.inverse_transform_matrix, points)
