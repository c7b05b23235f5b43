"""Image warping entry points: ``align_planes``, ``align_img``,
``grid_sample``, and the displacement <-> flow converters.

Port of ``keymorph_tpu/ops/resample.py``. In 3D all three run the warp
kernel wrapper :func:`keymorph_tpu_torch.ops.cuda.resample3d.warp_planes`
(plain version on CPU tensors); the grid forms first turn the ``xy``-ordered
grid into ``ij`` planes with ``flip(moveaxis(grid, -1, 1), 1)``. A 2D grid
goes to :func:`grid_sample_2d`, the corner-gather formula keymorph_tpu uses
for every warp its kernel does not take: the route is chosen by the grid's
dimension alone.
"""

from __future__ import annotations

import itertools

import torch

from keymorph_tpu_torch.ops.cuda import resample3d
from keymorph_tpu_torch.tracing import span


def grid_to_planes(grid: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, 3) ``xy`` grid -> (B, 3, D, H, W) ``ij`` planes."""
    return torch.flip(torch.movedim(grid, -1, 1), dims=(1,)).contiguous()


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """``align_corners=False``: [-1, 1] -> pixel, then the border clip to
    [0, N - 1] (``maximum``/``minimum``, whose gradient halves at a tie as
    ``jnp.clip``'s does)."""
    v = ((coord + 1.0) * size - 1.0) / 2.0
    lo = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo), lo + (size - 1.0))


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear"):
    """Sample (B, C, H, W) ``img`` at an ``xy``-ordered normalized grid
    (B, *S, 2) by gathering the 4 (bilinear) or 1 (nearest, round half to
    even) corners of a flattened image. ``torch.nn.functional.grid_sample``
    semantics with ``padding_mode="border"``, ``align_corners=False``;
    computed in ``promote(img.dtype, float32)`` and returned in img's dtype.
    Differentiable in ``img`` and ``grid``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode}")
    B, C, H, W = img.shape
    spatial = (H, W)
    out_spatial = grid.shape[1:-1]
    cdt = torch.promote_types(img.dtype, torch.float32)
    grid = grid.to(cdt)
    # xy -> ij: axis k of the image is indexed by grid[..., 1 - k]
    coords = [_unnormalize(grid[..., 1 - k], spatial[k]) for k in range(2)]
    flat = img.reshape(B, C, H * W).to(cdt)

    def gather(idx):
        idx = idx.reshape(B, 1, -1).expand(B, C, -1)
        return torch.gather(flat, 2, idx).reshape(B, C, *out_spatial)

    if mode == "nearest":
        idx = sum(torch.clamp(torch.round(coords[k]), 0, spatial[k] - 1).long()
                  * (W if k == 0 else 1) for k in range(2))
        return gather(idx).to(img.dtype)

    lo = [torch.floor(c) for c in coords]
    frac = [c - f for c, f in zip(coords, lo)]
    lo = [f.long() for f in lo]
    out = torch.zeros((B, C, *out_spatial), dtype=cdt, device=img.device)
    for corner in itertools.product((0, 1), repeat=2):
        idx = 0
        w = torch.ones_like(coords[0])
        for k in range(2):
            ck = torch.clamp(lo[k] + corner[k], 0, spatial[k] - 1)
            idx = idx + ck * (W if k == 0 else 1)
            w = w * (frac[k] if corner[k] else (1.0 - frac[k]))
        out = out + gather(idx) * w[:, None]
    return out.to(img.dtype)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear"):
    """Sample ``img`` (B, C, H, W) or (B, C, Z, Y, X) at an ``xy``-ordered
    normalized grid (B, *S, d): ``torch.nn.functional.grid_sample``
    semantics with ``padding_mode="border"``, ``align_corners=False``. A 3D
    grid runs the warp kernel's wrapper, a 2D one :func:`grid_sample_2d`."""
    d = grid.shape[-1]
    if img.dim() != d + 2:
        raise ValueError(f"img rank {img.dim()} vs grid dim {d}")
    if d == 2:
        return grid_sample_2d(img, grid, mode)
    if d != 3:
        raise ValueError(f"grid_sample: 2D or 3D grids only, got dim {d}")
    return resample3d.warp_planes(img, grid_to_planes(grid.float()), mode)


def align_img(grid: torch.Tensor, x: torch.Tensor, mode: str = "bilinear"):
    """Warp image ``x`` with sampling grid ``grid`` (reference argument order)."""
    with span("warp"):
        return grid_sample(x, grid, mode=mode)


def align_planes(planes: torch.Tensor, x: torch.Tensor, mode: str = "bilinear"):
    """Warp image ``x`` from ``ij``-ordered coordinate planes (B, 3, D, H, W);
    equals ``align_img`` on the ``xy`` grid ``flip(moveaxis(planes, 1, -1), -1)``."""
    with span("warp"):
        return resample3d.warp_planes(x, planes, mode)


def _require_3d_field(field: torch.Tensor, name: str):
    # keymorph_tpu's converters unpack three spatial sizes
    if field.dim() != 5 or field.shape[-1] != 3:
        raise ValueError(f"{name}: a (N, D, H, W, 3) field only (3D), got "
                         f"shape {tuple(field.shape)}")


def displacement2flow(displacement_field: torch.Tensor) -> torch.Tensor:
    """Voxel-unit displacement field (N, D, H, W, 3), last axis ``xy``, ->
    [-1, 1] sampling flow, with the reference's (size - 1) normalization and
    inclusive-linspace identity grid. 3D only, as in keymorph_tpu."""
    _require_3d_field(displacement_field, "displacement2flow")
    s0, s1, s2 = displacement_field.shape[1:-1]
    dt, dev = displacement_field.dtype, displacement_field.device
    c0, c1, c2 = torch.meshgrid(*[torch.linspace(-1, 1, int(s), device=dev, dtype=dt)
                                  for s in (s0, s1, s2)], indexing="ij")
    grid = torch.stack([c2, c1, c0], dim=-1)[None]
    sizes = torch.tensor([s0, s1, s2], dtype=dt, device=dev)
    return grid + 2.0 * displacement_field / (sizes - 1.0)


def flow2displacement(flow: torch.Tensor) -> torch.Tensor:
    """[-1, 1] sampling flow (N, D, H, W, 3) -> (N, 3, D, H, W) displacement
    in voxel units. 3D only, as in keymorph_tpu."""
    _require_3d_field(flow, "flow2displacement")
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
