"""Image warping entry points (3D): ``align_planes``, ``align_img``,
``grid_sample``, and the displacement <-> flow converters.

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


def displacement2flow(displacement_field: torch.Tensor) -> torch.Tensor:
    """Voxel-unit displacement field (N, D, H, W, 3), last axis ``xy``, ->
    [-1, 1] sampling flow, with the reference's (size - 1) normalization and
    inclusive-linspace identity grid."""
    s0, s1, s2 = displacement_field.shape[1:-1]
    dt, dev = displacement_field.dtype, displacement_field.device
    c0, c1, c2 = torch.meshgrid(*[torch.linspace(-1, 1, int(s), device=dev, dtype=dt)
                                  for s in (s0, s1, s2)], indexing="ij")
    grid = torch.stack([c2, c1, c0], dim=-1)[None]
    sizes = torch.tensor([s0, s1, s2], dtype=dt, device=dev)
    return grid + 2.0 * displacement_field / (sizes - 1.0)


def flow2displacement(flow: torch.Tensor) -> torch.Tensor:
    """[-1, 1] sampling flow (N, D, H, W, 3) -> (N, 3, D, H, W) displacement
    in voxel units."""
    flow = torch.movedim(flow, -1, 1)
    spatial = flow.shape[2:]
    sizes = torch.tensor(spatial, dtype=flow.dtype, device=flow.device).reshape(1, 3, 1, 1, 1)
    pix = (flow + 1.0) / 2.0 * (sizes - 1.0)
    grid = torch.stack(torch.meshgrid(*[torch.arange(int(s), dtype=flow.dtype, device=flow.device)
                                        for s in spatial], indexing="ij"), dim=0)[None]
    return pix - grid


def displacement2pytorchflow(displacement_field: torch.Tensor) -> torch.Tensor:
    """Reference-API alias of :func:`displacement2flow`."""
    return displacement2flow(displacement_field)


def pytorchflow2displacement(flow: torch.Tensor) -> torch.Tensor:
    """Reference-API alias of :func:`flow2displacement`."""
    return flow2displacement(flow)
