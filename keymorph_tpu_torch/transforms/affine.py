"""Affine transform primitive: dense flow-field generation (3D).

Port of ``keymorph_tpu/transforms/affine.py:affine_flow``.
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
        inverse_matrix: (B, 4, 4) fixed -> moving matrix.
        spatial_shape: (D, H, W).
    Returns:
        (B, D, H, W, 3) grid in [-1, 1], ``xy``-ordered.
    """
    if len(spatial_shape) != 3:
        raise NotImplementedError("affine_flow: only 3D volumes are ported "
                                  "(ROADMAP A9, 2D pipeline)")
    B = inverse_matrix.shape[0]
    grid = coords.flat_norm_grid(spatial_shape, device=inverse_matrix.device)
    moved = coords.apply_matrix(inverse_matrix, grid.expand(B, -1, 3))
    return torch.flip(moved.reshape(B, *spatial_shape, 3), dims=(-1,))
