"""Keypoint aligner objects with the reference's public API.

Port of ``keymorph_tpu/transforms/aligners.py``: a thin object layer over
:mod:`keymorph_tpu_torch.transforms.solvers`, so that code written against
the reference's aligners runs on the port::

    aligner = AffineKeypointAligner(points_m=..., points_f=...)
    grid = aligner.get_flow_field(img_f.shape)
    pts = aligner.get_forward_transformed_points(points)

Keypoints are ``ij``-indexed (B, N, 3) in [-1, 1]. With
``align_in_real_world_coords`` they are first taken to scanner coordinates
through each image's (B, 4, 4) voxel -> world affine, and the results come
back to normalized coordinates. The TPS dense flow goes through
``solvers.tps_eval_chunked``: the TPS-flow kernel in points mode on CUDA
tensors.
"""

from __future__ import annotations

import functools

import torch

from keymorph_tpu_torch.ops import coords as C
from keymorph_tpu_torch.transforms import solvers
from keymorph_tpu_torch.transforms.affine import AffineTransform, affine_flow


def _real_world(points, aff, shape):
    return C.convert_points_norm2real(points, aff, shape)


def _require_real_world_inputs(aff_f, aff_m, shape_f, shape_m):
    for name, v in (("aff_f", aff_f), ("aff_m", aff_m), ("shape_f", shape_f),
                    ("shape_m", shape_m)):
        if v is None:
            raise ValueError(f"real-world alignment needs {name}")
    return torch.as_tensor(aff_f).float(), torch.as_tensor(aff_m).float()


class AffineKeypointAligner(AffineTransform):
    """Closed-form (weighted) least-squares affine alignment: fits fixed ->
    moving (the inverse transform, which builds the sampling grid) and
    derives the forward matrix by inversion."""

    solver = staticmethod(solvers.fit_affine)

    def __init__(self, points_m, points_f, w=None, dim: int = 3,
                 align_in_real_world_coords: bool = False, aff_m=None, aff_f=None,
                 shape_m=None, shape_f=None):
        self.dim = dim
        self.align_in_real_world_coords = align_in_real_world_coords
        self.points_f = torch.as_tensor(points_f).float()
        self.points_m = torch.as_tensor(points_m).float()
        self.shape_f, self.shape_m = shape_f, shape_m
        if align_in_real_world_coords:
            self.aff_f, self.aff_m = _require_real_world_inputs(aff_f, aff_m, shape_f, shape_m)
            self.points_m = _real_world(self.points_m, self.aff_m, shape_m)
            self.points_f = _real_world(self.points_f, self.aff_f, shape_f)
        inv = solvers.square_matrix(self.fit(self.points_f, self.points_m, w=w))
        super().__init__(inverse_matrix=inv, dim=dim)

    def fit(self, x, y, w=None):
        return type(self).solver(x, y, w)

    def get_forward_transformed_points(self, points):
        if self.align_in_real_world_coords:
            points = _real_world(points, self.aff_m, self.shape_m)
        points = super().get_forward_transformed_points(points)
        if self.align_in_real_world_coords:
            points = C.convert_points_real2norm(points, self.aff_f, self.shape_f)
        return points

    def get_inverse_transformed_points(self, points):
        if self.align_in_real_world_coords:
            points = _real_world(points, self.aff_f, self.shape_f)
        points = super().get_inverse_transformed_points(points)
        if self.align_in_real_world_coords:
            points = C.convert_points_real2norm(points, self.aff_m, self.shape_m)
        return points

    def get_flow_field(self, grid_shape, **kwargs):
        """``xy``-ordered sampling grid over the fixed image's (B, C, *S)
        shape; in real-world mode norm_f -> real_f -> fitted affine ->
        real_m -> norm_m."""
        spatial = tuple(grid_shape[2:])
        if not self.align_in_real_world_coords:
            return affine_flow(self.inverse_transform_matrix, spatial)
        B = self.inverse_transform_matrix.shape[0]
        grid = C.flat_norm_grid(spatial, device=self.inverse_transform_matrix.device)
        moved = self.get_inverse_transformed_points(grid.expand(B, -1, self.dim))
        return torch.flip(moved.reshape(B, *spatial, self.dim), dims=(-1,))


class RigidKeypointAligner(AffineKeypointAligner):
    """SVD (Arun) rigid alignment."""

    solver = staticmethod(solvers.fit_rigid)


class TPS:
    """Thin-plate-spline alignment with per-batch regularization ``lmbda``.

    The inverse spline (fixed -> moving) drives the sampling grid; the
    forward spline is fitted on first use for point transport.
    ``num_centers=S`` (below the keypoint count) selects the approximate
    solver (``solvers.fit_tps_approximate``): only the first S keypoints are
    RBF centres. ``num_subgrids`` and ``use_checkpoint`` are kept for the
    reference's signature: the flow takes the TPS-flow kernel on CUDA
    tensors whatever the chunking, and the CPU path chunks by
    ``solvers.CHUNK_POINTS``.
    """

    def __init__(self, points_m, points_f, lmbda, w=None, dim: int = 3, num_subgrids: int = 4,
                 use_checkpoint: bool = False, align_in_real_world_coords: bool = False,
                 aff_m=None, aff_f=None, shape_m=None, shape_f=None, num_centers=None):
        self.dim = dim
        self.num_subgrids = num_subgrids
        self.use_checkpoint = use_checkpoint
        self.points_f = torch.as_tensor(points_f).float()
        self.points_m = torch.as_tensor(points_m).float()
        self.lmbda = torch.as_tensor(lmbda, dtype=torch.float32, device=self.points_f.device)
        self.weights = w
        self.align_in_real_world_coords = align_in_real_world_coords
        self.shape_f, self.shape_m = shape_f, shape_m
        if align_in_real_world_coords:
            self.aff_f, self.aff_m = _require_real_world_inputs(aff_f, aff_m, shape_f, shape_m)
            self.points_m = _real_world(self.points_m, self.aff_m, shape_m)
            self.points_f = _real_world(self.points_f, self.aff_f, shape_f)
        K = self.points_f.shape[1]
        S = int(num_centers) if num_centers is not None and int(num_centers) < K else None
        self.num_centers = S
        if S is not None:
            self._fit = functools.partial(solvers.fit_tps_approximate, num_subsample=S)
        else:
            self._fit = solvers.fit_tps
        self.ctrl_f = (self.points_f if S is None else self.points_f[:, :S]).contiguous()
        self.ctrl_m = (self.points_m if S is None else self.points_m[:, :S]).contiguous()
        self.inverse_theta = self._fit(self.points_f, self.points_m, self.lmbda, w=w)
        self.theta = None  # the forward spline, fitted on first use

    def get_inverse_transformed_points(self, points):
        if self.align_in_real_world_coords:
            points = _real_world(points, self.aff_f, self.shape_f)
        points = solvers.tps_eval(self.inverse_theta, self.ctrl_f, points)
        if self.align_in_real_world_coords:
            points = C.convert_points_real2norm(points, self.aff_m, self.shape_m)
        return points

    def get_forward_transformed_points(self, points):
        if self.theta is None:
            self.theta = self._fit(self.points_m, self.points_f, self.lmbda, w=self.weights)
        if self.align_in_real_world_coords:
            points = _real_world(points, self.aff_m, self.shape_m)
        points = solvers.tps_eval(self.theta, self.ctrl_m, points)
        if self.align_in_real_world_coords:
            points = C.convert_points_real2norm(points, self.aff_f, self.shape_f)
        return points

    def get_flow_field(self, grid_shape, compute_on_subgrids: bool = False):
        """``xy``-ordered sampling grid over the fixed image's (B, C, *S)
        shape, through ``solvers.tps_eval_chunked`` (the kernel on CUDA
        tensors; ``compute_on_subgrids`` changes nothing in the result)."""
        spatial = tuple(grid_shape[2:])
        B = self.inverse_theta.shape[0]
        grid = C.flat_norm_grid(spatial, device=self.inverse_theta.device).expand(B, -1, self.dim)
        if self.align_in_real_world_coords:
            grid = _real_world(grid, self.aff_f, self.shape_f)
        moved = solvers.tps_eval_chunked(self.inverse_theta, self.ctrl_f, grid)
        if self.align_in_real_world_coords:
            moved = C.convert_points_real2norm(moved, self.aff_m, self.shape_m)
        return torch.flip(moved.reshape(B, *spatial, self.dim), dims=(-1,))
