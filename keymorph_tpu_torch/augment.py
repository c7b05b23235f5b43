"""On-device affine augmentation (2D and 3D). Port of ``keymorph_tpu/augment.py``.

Parameter sampling, matrix composition, flow generation and the warp are all
tensor code on the images' device, with an explicit ``torch.Generator``.

Matrix composition: ``M = Shear @ Scale @ Translate @ Rotation`` with
``Rotation = R3 @ R2 @ R1``. Images are warped through the INVERSE matrix's
flow; points are pushed through the forward matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from keymorph_tpu_torch.ops.coords import apply_matrix
from keymorph_tpu_torch.ops.resample import align_img
from keymorph_tpu_torch.transforms.affine import affine_flow

DEFAULT_MAX_PARAMS = (0.2, 0.2, 3.1416, 0.1)


def build_affine_matrix_2d(scale, offset, theta, shear) -> torch.Tensor:
    """(B, 2), (B, 2), (B, 1), (B, 2) -> (B, 3, 3)."""
    B = scale.shape[0]
    dev = scale.device

    def eye():
        return torch.eye(3, device=dev).repeat(B, 1, 1)

    Ms = torch.diag_embed(torch.cat([scale.float(), torch.ones((B, 1), device=dev)], dim=1))
    Mt = eye()
    Mt[:, :2, 2] = offset.float()
    c, s = torch.cos(theta[:, 0].float()), torch.sin(theta[:, 0].float())
    Mr = eye()
    Mr[:, 0, 0] = c
    Mr[:, 0, 1] = -s
    Mr[:, 1, 0] = s
    Mr[:, 1, 1] = c
    Mz = eye()
    Mz[:, 0, 1] = shear[:, 0].float()
    Mz[:, 1, 0] = shear[:, 1].float()
    return Mz @ (Ms @ (Mt @ Mr))


def build_affine_matrix_3d(scale, offset, theta, shear) -> torch.Tensor:
    """(B, 3), (B, 3), (B, 3), (B, 6) -> (B, 4, 4)."""
    B = scale.shape[0]
    dev = scale.device

    def eye():
        return torch.eye(4, device=dev).repeat(B, 1, 1)

    Ms = torch.diag_embed(torch.cat([scale.float(), torch.ones((B, 1), device=dev)], dim=1))
    Mt = eye()
    Mt[:, :3, 3] = offset.float()

    def rot(i):
        c, s = torch.cos(theta[:, i].float()), torch.sin(theta[:, i].float())
        m = eye()
        a, b = [(1, 2), (0, 2), (0, 1)][i]
        m[:, a, a] = c
        m[:, b, b] = c
        sign = 1.0 if i == 1 else -1.0
        m[:, a, b] = sign * s
        m[:, b, a] = -sign * s
        return m

    Mr = rot(2) @ (rot(1) @ rot(0))
    Mz = eye()
    for k, (r, c) in enumerate(((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))):
        Mz[:, r, c] = shear[:, k].float()
    return Mz @ (Ms @ (Mt @ Mr))


def build_affine_matrix(params, dim: int = 3) -> torch.Tensor:
    return (build_affine_matrix_2d if dim == 2 else build_affine_matrix_3d)(*params)


def _param_widths(dim: int):
    """Widths of (scale, offset, theta, shear) for a ``dim``-D transform."""
    return (2, 2, 1, 2) if dim == 2 else (3, 3, 3, 6)


def sample_affine_params(generator: Optional[torch.Generator], batch_size: int,
                         dim: int = 3,
                         max_random_params: Tuple[float, float, float, float] = DEFAULT_MAX_PARAMS,
                         scale_params: float = 1.0, device=None):
    """Random (scale, offset, theta, shear): scale in 1 +- s, the others in
    +- their maximum; ``scale_params`` is the affine-slope ramp factor."""
    s, o, a, z = (p * float(scale_params) for p in max_random_params)
    gdev = generator.device if generator is not None else "cpu"

    def uniform(n, lo, hi):
        u = torch.rand((batch_size, n), generator=generator, device=gdev).to(device)
        return lo + (hi - lo) * u

    ns, no, na, nz = _param_widths(dim)
    return (uniform(ns, 1 - s, 1 + s), uniform(no, -o, o), uniform(na, -a, a),
            uniform(nz, -z, z))


def fixed_affine_params(batch_size: int, dim: int, fixed_params, device=None):
    """Deterministic params (the evaluation augmentations); scale is 1 + s."""
    s, o, a, z = fixed_params
    ns, no, na, nz = _param_widths(dim)
    return (torch.full((batch_size, ns), 1.0 + s, device=device),
            torch.full((batch_size, no), float(o), device=device),
            torch.full((batch_size, na), float(a), device=device),
            torch.full((batch_size, nz), float(z), device=device))


def deform_img(img, matrix, interp_mode: str = "bilinear"):
    """Warp a channel-first image by the affine ``matrix`` (through the flow
    of its inverse)."""
    flow = affine_flow(torch.linalg.inv(matrix.float()), img.shape[2:])
    return align_img(flow, img, mode=interp_mode)


def deform_points(points, matrix):
    return apply_matrix(matrix, points)


def affine_augment_with_params(img, params, seg=None, points=None,
                               return_affine_matrix: bool = False):
    """Apply one parameter set to the image (+ seg nearest, + points forward)."""
    M = build_affine_matrix(params, img.dim() - 2)
    res = (deform_img(img, M, "bilinear"),)
    if seg is not None:
        res += (deform_img(seg, M, "nearest"),)
    if points is not None:
        res += (deform_points(points, M),)
    if return_affine_matrix:
        res += (M,)
    return res[0] if len(res) == 1 else res


def random_affine_augment(generator, img, seg=None, points=None,
                          max_random_params=DEFAULT_MAX_PARAMS, scale_params: float = 1.0,
                          return_affine_matrix: bool = False):
    """Random augmentation with parameters drawn from ``generator``."""
    params = sample_affine_params(generator, img.shape[0], img.dim() - 2,
                                  max_random_params, scale_params, device=img.device)
    return affine_augment_with_params(img, params, seg=seg, points=points,
                                      return_affine_matrix=return_affine_matrix)


def affine_augment(img, fixed_params, seg=None, points=None):
    """Deterministic augmentation."""
    params = fixed_affine_params(img.shape[0], img.dim() - 2, fixed_params,
                                 device=img.device)
    return affine_augment_with_params(img, params, seg=seg, points=points)


def random_affine_augment_pair(generator, img1, img2, max_random_params=DEFAULT_MAX_PARAMS,
                               scale_params: float = 1.0):
    """The same random transform applied to both images."""
    params = sample_affine_params(generator, img1.shape[0], img1.dim() - 2,
                                  max_random_params, scale_params, device=img1.device)
    M = build_affine_matrix(params, img1.dim() - 2)
    return deform_img(img1, M), deform_img(img2, M)
