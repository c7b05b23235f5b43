"""Image warping entry points (3D): ``align_planes``, ``align_img``,
``grid_sample``.

Port of the 3D part of ``keymorph_tpu/ops/resample.py``. All three run the
warp kernel wrapper :func:`keymorph_tpu_torch.ops.cuda.resample3d.warp_planes`
(plain version on CPU tensors); the grid forms first turn the ``xy``-ordered
grid into ``ij`` planes with ``flip(moveaxis(grid, -1, 1), 1)``.
"""

from __future__ import annotations

import torch

from keymorph_tpu_torch.ops.cuda import resample3d


def grid_to_planes(grid: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, 3) ``xy`` grid -> (B, 3, D, H, W) ``ij`` planes."""
    return torch.flip(torch.movedim(grid, -1, 1), dims=(1,)).contiguous()


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear"):
    """Sample (B, C, Z, Y, X) ``img`` at an ``xy``-ordered normalized grid
    (B, D, H, W, 3): ``torch.nn.functional.grid_sample`` semantics with
    ``padding_mode="border"``, ``align_corners=False``."""
    if grid.shape[-1] != 3 or img.dim() != 5:
        raise NotImplementedError(
            "grid_sample: only 3D volumes are ported (ROADMAP A9, 2D pipeline)"
        )
    return resample3d.warp_planes(img, grid_to_planes(grid.float()), mode)


def align_img(grid: torch.Tensor, x: torch.Tensor, mode: str = "bilinear"):
    """Warp image ``x`` with sampling grid ``grid`` (reference argument order)."""
    return grid_sample(x, grid, mode=mode)


def align_planes(planes: torch.Tensor, x: torch.Tensor, mode: str = "bilinear"):
    """Warp image ``x`` from ``ij``-ordered coordinate planes (B, 3, D, H, W);
    equals ``align_img`` on the ``xy`` grid ``flip(moveaxis(planes, 1, -1), -1)``."""
    return resample3d.warp_planes(x, planes, mode)
