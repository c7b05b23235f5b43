"""The KeyMorph registration pipeline: keypoint network and TPS alignment.

Port of ``keymorph_tpu/models/keymorph.py`` for the pairwise TPS path:

  * :class:`KeyMorphNet` — backbone + center-of-mass head (+ the optional
    variance-weighting parameters); fixed and moving run as two passes;
  * :func:`align_pair` — the TPS fit and its dense flow, either as
    ``ij`` planes from the TPS-flow kernel (``compute_grid="planes"``) or
    as the ``xy`` grid from the same kernel in points mode
    (``compute_grid=True``);
  * the training helpers :func:`parse_transform_type`,
    :func:`sample_tps_lmbda` and :func:`subsample_keypoints`.

Everything is differentiable; serving code calls it under
``torch.no_grad()``. Keypoints are ``ij``-indexed in [-1, 1]; images are
channel-first (B, 1, Z, Y, X). Affine/rigid alignment, real-world
coordinates, approximate TPS and the ``KeyMorph`` orchestrator are not
ported yet (ROADMAP A4).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
from keymorph_tpu_torch.models.layers import center_of_mass
from keymorph_tpu_torch.models.unet import supports_fast_unet
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.ops.cuda import tpsflow
from keymorph_tpu_torch.transforms import solvers


_TPS_RE = re.compile(r"^tps_(.+)$")


def is_supported_transform_type(s: str) -> bool:
    return s in ("affine", "rigid") or bool(_TPS_RE.match(s))


def parse_transform_type(s: str) -> Tuple[str, Optional[Union[float, str]]]:
    """'tps_0.1' -> ('tps', 0.1); 'tps_loguniform' -> ('tps', 'loguniform');
    'affine' / 'rigid' -> (s, None)."""
    m = _TPS_RE.match(s)
    if m:
        v = m.group(1)
        try:
            return "tps", float(v)
        except ValueError:
            return "tps", v
    if s not in ("affine", "rigid"):
        raise ValueError(f"Invalid transform_type {s}")
    return s, None


def sample_tps_lmbda(generator: Optional[torch.Generator], num_samples: int, spec,
                     max_rand_tps_lmbda: float = 10.0, device=None) -> torch.Tensor:
    """Per-sample TPS lambdas (num_samples,): a constant, 'uniform' in
    [0, max) or 'loguniform' in [1e-6, max). Draws come from ``generator``
    (on its own device) and are moved to ``device``."""
    if spec in ("uniform", "loguniform"):
        gdev = generator.device if generator is not None else "cpu"
        u = torch.rand((num_samples,), generator=generator, device=gdev).to(device)
        if spec == "uniform":
            return u * max_rand_tps_lmbda
        a, b = 1e-6, max_rand_tps_lmbda
        return torch.exp(u * (math.log(b) - math.log(a)) + math.log(a))
    return torch.full((num_samples,), float(spec), dtype=torch.float32, device=device)


def subsample_keypoints(generator: Optional[torch.Generator], points_f, points_m,
                        weights, max_keypoints: int, idx=None):
    """Random keypoint mini-batch for TPS training: the first
    ``max_keypoints`` of a permutation drawn from ``generator``, or the given
    ``idx`` (so a test can inject what another framework drew)."""
    if idx is None:
        gdev = generator.device if generator is not None else "cpu"
        idx = torch.randperm(points_f.shape[1], generator=generator,
                             device=gdev)[:max_keypoints]
    idx = torch.as_tensor(idx, dtype=torch.long, device=points_f.device)
    points_f, points_m = points_f[:, idx], points_m[:, idx]
    if weights is not None:
        weights = weights[:, idx]
    return points_f, points_m, weights


class KeyMorphNet(nn.Module):
    """Backbone + center-of-mass keypoint head + optional keypoint-weighting
    parameters (3D; the linear keypoint head is not ported, ROADMAP A9)."""

    def __init__(self, backbone: nn.Module, num_keypoints: int,
                 weight_keypoints: Optional[str] = None):
        super().__init__()
        if weight_keypoints not in (None, "power", "variance"):
            raise ValueError(f"weight_keypoints={weight_keypoints!r}")
        self.backbone = backbone
        self.num_keypoints = num_keypoints
        self.weight_keypoints = weight_keypoints
        if weight_keypoints == "variance":
            self.scales = nn.Parameter(torch.ones(num_keypoints))
            self.biases = nn.Parameter(torch.zeros(num_keypoints))

    def features(self, img: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """img (B, 1, *spatial) -> heatmaps (B, *spatial', K), channel-last.

        The backbone runs on the conv kernels (``fast_unet_forward``), which
        take bf16 'gcr' U-Nets only: the backbone's ``dtype`` is the compute
        dtype. ``plain`` runs the convs' plain versions (the oracle route).
        """
        if not supports_fast_unet(self.backbone):
            raise NotImplementedError(
                "only bf16 'gcr' U-Net backbones are ported (ROADMAP A3: fp32 "
                "backbones, other layer orders; A9: other block families)"
            )
        return fast_unet_forward(self.backbone, img, plain=plain)

    def get_keypoints(self, img: torch.Tensor, return_feat: bool = False,
                      plain: bool = False):
        feat = self.features(img, plain=plain)
        points = center_of_mass(feat)
        return (points, feat) if return_feat else points

    def weight_by_variance(self, feat1, feat2):
        """Inverse-variance keypoint confidence, normalized per batch row."""
        axes = tuple(range(1, feat1.dim() - 1))
        var1 = torch.var(torch.relu(feat1.float()), dim=axes, unbiased=False)
        var2 = torch.var(torch.relu(feat2.float()), dim=axes, unbiased=False)
        w1 = 1.0 / (self.scales * var1 + self.biases + 1e-8)
        w2 = 1.0 / (self.scales * var2 + self.biases + 1e-8)
        w = w1 * w2
        return w / w.sum(dim=-1, keepdim=True)

    def weight_by_power(self, feat1, feat2):
        """Heatmap-mass keypoint confidence, normalized per batch row."""
        axes = tuple(range(1, feat1.dim() - 1))
        p1 = torch.sum(torch.relu(feat1), dim=axes, dtype=torch.float32)
        p2 = torch.sum(torch.relu(feat2), dim=axes, dtype=torch.float32)
        w = p1 * p2
        return w / w.sum(dim=-1, keepdim=True)

    def forward(self, img_f: torch.Tensor, img_m: torch.Tensor, plain: bool = False):
        """Keypoints (and weights) of a pair: (points_f, points_m, weights
        or None). Fixed and moving run as two separate backbone passes."""
        points_f, feat_f = self.get_keypoints(img_f, return_feat=True, plain=plain)
        points_m, feat_m = self.get_keypoints(img_m, return_feat=True, plain=plain)
        if self.weight_keypoints == "variance":
            weights = self.weight_by_variance(feat_f, feat_m)
        elif self.weight_keypoints == "power":
            weights = self.weight_by_power(feat_f, feat_m)
        else:
            weights = None
        return points_f, points_m, weights


def align_pair(points_f: torch.Tensor, points_m: torch.Tensor, align_type: str,
               grid_shape: Sequence[int], lmbda=None, weights=None,
               compute_grid=True, aff_f=None, aff_m=None, tps_centers=None,
               plain: bool = False):
    """Fit the fixed -> moving TPS and produce its dense flow.

    Args:
        points_f, points_m: (B, T, 3) keypoints, ``ij`` order, in [-1, 1].
        align_type: "tps" (the only ported type).
        grid_shape: (D, H, W) of the fixed image.
        lmbda: scalar or (B,) TPS regularization.
        weights: optional (B, T) keypoint weights.
        compute_grid: "planes" -> ``out["planes"]``, ``ij`` (B, 3, D, H, W)
            from the TPS-flow kernel; True -> ``out["grid"]``, the ``xy``
            (B, D, H, W, 3) grid from the spline at the flat identity grid
            (``solvers.tps_eval_chunked``: the kernel's points mode on CUDA
            tensors).
        plain: run the plain versions of the TPS kernels (the oracle route).
    Returns:
        dict with "planes" or "grid".
    """
    if align_type != "tps":
        raise NotImplementedError(
            f"align_type={align_type!r}: only 'tps' is ported (ROADMAP A4, "
            "affine/rigid alignment)"
        )
    if aff_f is not None or aff_m is not None:
        raise NotImplementedError(
            "real-world coordinate alignment is not ported (ROADMAP A4)"
        )
    if tps_centers is not None:
        raise NotImplementedError("approximate TPS is not ported (ROADMAP A4)")
    if lmbda is None:
        raise ValueError("TPS alignment needs lmbda")
    if compute_grid not in ("planes", True):
        raise ValueError(f"compute_grid={compute_grid!r}: 'planes' or True")
    spatial = tuple(int(s) for s in grid_shape)
    ctrl = points_f.float().contiguous()
    theta = solvers.fit_tps(ctrl, points_m, lmbda, weights).contiguous()
    if compute_grid == "planes":
        flow = tpsflow.tps_planes_plain if plain else tpsflow.tps_planes
        return {"planes": flow(theta, ctrl, spatial)}
    B = ctrl.shape[0]
    grid = coords.flat_norm_grid(spatial, device=ctrl.device)
    evaluate = solvers.tps_eval_chunked_plain if plain else solvers.tps_eval_chunked
    moved = evaluate(theta, ctrl, grid.expand(B, -1, 3))
    return {"grid": torch.flip(moved.reshape(B, *spatial, 3), dims=(-1,))}
