"""The KeyMorph registration pipeline.

Port of ``keymorph_tpu/models/keymorph.py``, in two layers:

1. the functional core: :class:`KeyMorphNet` (backbone + center-of-mass
   head + the optional keypoint-weighting parameters; fixed and moving run
   as two passes), :func:`align_pair` (affine, rigid, exact or approximate
   TPS, in normalized or real-world coordinates, as an ``xy`` grid, ``ij``
   planes or points only), the groupwise iteration and grids, and the
   training helpers :func:`parse_transform_type`, :func:`sample_tps_lmbda`
   and :func:`subsample_keypoints`;
2. the :class:`KeyMorph` orchestrator with the reference's result-dict
   contract: ``model(img_f, img_m, transform_type=[...],
   return_aligned_points=True)`` and ``groupwise_register``.

Everything in the core is differentiable; serving code calls it under
``torch.no_grad()``. Keypoints are ``ij``-indexed in [-1, 1]; images are
channel-first (B, 1, Z, Y, X), or (B, 1, H, W) in 2D. On CUDA tensors the
TPS flow, the warp and the convs of the bf16 3D U-Nets run the port's
kernels; 2D registration has no kernel in either package (its spline is
evaluated by ``solvers.tps_eval_chunked``'s 2D route, its warp by
``ops.resample.grid_sample_2d``), and no planes form, as keymorph_tpu's is
3D only.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from keymorph_tpu_torch import resolve_device
from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
from keymorph_tpu_torch.models.layers import LinearRegressor, center_of_mass
from keymorph_tpu_torch.models.unet import supports_fast_unet
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.ops.cuda import tpsflow
from keymorph_tpu_torch.ops.planes import affine_flow_planes
from keymorph_tpu_torch.transforms import solvers
from keymorph_tpu_torch.transforms.affine import affine_flow

RegistrationResult = Dict[str, Dict[str, Any]]


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
    """Backbone + keypoint head (center of mass, or the linear regressor) +
    optional keypoint-weighting parameters; ``dim`` is the keypoints' (the
    linear head's output width)."""

    def __init__(self, backbone: nn.Module, num_keypoints: int,
                 weight_keypoints: Optional[str] = None, keypoint_layer: str = "com",
                 dim: int = 3):
        super().__init__()
        if weight_keypoints not in (None, "power", "variance"):
            raise ValueError(f"weight_keypoints={weight_keypoints!r}")
        if keypoint_layer not in ("com", "linear"):
            raise ValueError(f"keypoint_layer={keypoint_layer!r}")
        self.backbone = backbone
        self.num_keypoints = num_keypoints
        self.weight_keypoints = weight_keypoints
        self.keypoint_layer = keypoint_layer
        self.dim = dim
        if weight_keypoints == "variance":
            self.scales = nn.Parameter(torch.ones(num_keypoints))
            self.biases = nn.Parameter(torch.zeros(num_keypoints))
        if keypoint_layer == "linear":
            self.regressor = LinearRegressor(num_keypoints, num_keypoints, dim)

    def features(self, img: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """img (B, 1, *spatial) -> heatmaps (B, *spatial', K), channel-last,
        in the backbone's dtype (its compute dtype).

        A bf16 'gcr' or 'cr' DoubleConv 3D U-Net runs on the conv kernels
        (``fast_unet_forward``; ``plain`` runs the convs' plain versions, the
        oracle route). Every other backbone is its module's forward, as
        keymorph_tpu's ``features`` applies the flax module (XLA convs, no
        Pallas kernel) where its executor does not apply.
        """
        if supports_fast_unet(self.backbone):
            return fast_unet_forward(self.backbone, img, plain=plain)
        return self.backbone(img).movedim(1, -1)

    def keypoints_from_features(self, feat: torch.Tensor) -> torch.Tensor:
        if self.keypoint_layer == "com":
            return center_of_mass(feat)
        return self.regressor(feat)

    def get_keypoints(self, img: torch.Tensor, return_feat: bool = False,
                      plain: bool = False):
        feat = self.features(img, plain=plain)
        points = self.keypoints_from_features(feat)
        return (points, feat) if return_feat else points

    def weight_by_variance(self, feat1, feat2):
        """Inverse-variance keypoint confidence, normalized per batch row."""
        axes = tuple(range(1, feat1.dim() - 1))
        var1 = torch.var(torch.relu(feat1.float()), dim=axes, unbiased=False)
        var2 = torch.var(torch.relu(feat2.float()), dim=axes, unbiased=False)
        return self.weights_from_variances(var1, var2)

    def weights_from_variances(self, var1, var2):
        """:meth:`weight_by_variance` from the heatmaps' variances (B, K)."""
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

    def _pair(self, img_f, img_m, plain):
        points_f, feat_f = self.get_keypoints(img_f, return_feat=True, plain=plain)
        points_m, feat_m = self.get_keypoints(img_m, return_feat=True, plain=plain)
        if self.weight_keypoints == "variance":
            weights = self.weight_by_variance(feat_f, feat_m)
        elif self.weight_keypoints == "power":
            weights = self.weight_by_power(feat_f, feat_m)
        else:
            weights = None
        return points_f, points_m, weights, feat_f, feat_m

    def forward(self, img_f: torch.Tensor, img_m: torch.Tensor, plain: bool = False):
        """Keypoints (and weights) of a pair: (points_f, points_m, weights
        or None). Fixed and moving run as two separate backbone passes."""
        return self._pair(img_f, img_m, plain)[:3]

    def pair_ranked_by_mass(self, img_f: torch.Tensor, img_m: torch.Tensor,
                            plain: bool = False):
        """:meth:`forward` with the keypoints (and weights) permuted by
        descending joint heatmap mass (``weight_by_power``'s statistic,
        unnormalized): approximate TPS takes the FIRST S keypoints as RBF
        centres, so this puts the confident, well-localized ones first.
        The sort is stable, as ``jnp.argsort`` is, so ties keep their
        channel order."""
        points_f, points_m, weights, feat_f, feat_m = self._pair(img_f, img_m, plain)
        axes = tuple(range(1, feat_f.dim() - 1))
        mass = (torch.sum(torch.relu(feat_f), dim=axes, dtype=torch.float32)
                * torch.sum(torch.relu(feat_m), dim=axes, dtype=torch.float32))  # (B, K)
        order = torch.argsort(-mass, dim=1, stable=True)
        idx = order[..., None].expand(-1, -1, points_f.shape[-1])
        points_f = torch.gather(points_f, 1, idx)
        points_m = torch.gather(points_m, 1, idx)
        if weights is not None:
            weights = torch.gather(weights, 1, order)
        return points_f, points_m, weights


_COMPUTE_GRID = (False, True, "planes")


def align_pair(points_f: torch.Tensor, points_m: torch.Tensor, align_type: str,
               grid_shape: Sequence[int], lmbda=None, weights=None, num_chunks: int = 1,
               compute_grid=True, compute_aligned_points: bool = False, aff_f=None,
               aff_m=None, moving_shape: Optional[Sequence[int]] = None,
               tps_centers: Optional[int] = None, plain: bool = False):
    """Fit the fixed -> moving transform and produce its flow, matrix and
    aligned points.

    Args:
        points_f, points_m: (B, T, d) keypoints, ``ij`` order, in [-1, 1]
            (d = 3, or 2 for 2D registration).
        align_type: "affine", "rigid" or "tps".
        grid_shape: (D, H, W) or (H, W) of the fixed image (``()`` with
            ``compute_grid=False``).
        lmbda: scalar or (B,) TPS regularization (TPS only, required).
        weights: optional (B, T) keypoint weights.
        num_chunks: accepted for keymorph_tpu's signature and changes
            nothing in the result: on CUDA tensors the TPS-flow kernel
            covers any number of points at once, and the CPU path chunks by
            ``solvers.CHUNK_POINTS``.
        compute_grid: True -> ``out["grid"]``, the ``xy`` (B, *grid_shape, d)
            sampling grid; "planes" (3D only) -> ``out["planes"]``, the
            ``ij`` (B, 3, D, H, W) planes, ``flip(moveaxis(grid, -1, 1), 1)``;
            False -> neither.
        compute_aligned_points: also ``out["points_a"]``, the moving
            keypoints carried into the fixed frame (B, T, d).
        aff_f, aff_m: (B, d+1, d+1) voxel -> world affines of the fixed and
            moving images: fit in real-world (scanner) coordinates, and map
            the grid back through the moving affine. Both or neither.
        moving_shape: the moving image's spatial shape (default
            ``grid_shape``).
        tps_centers: S below T selects approximate TPS: a least-squares fit
            against the first S keypoints as RBF centres.
        plain: run the plain versions of the TPS kernels (the oracle route).
    Returns:
        dict with "grid" or "planes" (per ``compute_grid``), "matrix"
        (affine and rigid: the (B, d+1, d+1) moving -> fixed matrix) and
        "points_a" (with ``compute_aligned_points``).

    On the TPS planes path in normalized coordinates the planes come from
    the TPS-flow kernel on the identity grid; the TPS grid path and the real-
    world TPS path evaluate the spline at points (the kernel's points mode);
    affine and rigid planes come from :func:`affine_flow_planes`, except in
    real-world mode, where they are the grid's flip.
    """
    if align_type not in ("affine", "rigid", "tps"):
        raise ValueError(f"Unknown align_type {align_type!r}")
    if compute_grid not in _COMPUTE_GRID:
        raise ValueError(f"compute_grid={compute_grid!r}: False, True or 'planes'")
    if (aff_f is None) != (aff_m is None):
        raise ValueError("real-world alignment needs both aff_f and aff_m")
    if align_type == "tps" and lmbda is None:
        raise ValueError("TPS alignment needs lmbda")
    out: Dict[str, torch.Tensor] = {}
    want_planes = compute_grid == "planes"
    spatial = tuple(int(s) for s in grid_shape)
    spatial_m = tuple(int(s) for s in moving_shape) if moving_shape is not None else spatial
    rw = aff_f is not None
    B, d = points_f.shape[0], points_f.shape[-1]
    if want_planes and d != 3:
        raise ValueError(f"compute_grid='planes' is 3D only (keymorph_tpu's planes path "
                         f"unpacks three sizes); got {d}D keypoints")
    pf, pm = points_f.float(), points_m.float()
    if rw:
        aff_f, aff_m = aff_f.float(), aff_m.float()
        pf = coords.convert_points_norm2real(pf, aff_f, spatial)
        pm = coords.convert_points_norm2real(pm, aff_m, spatial_m)

    def grid_points():
        g = coords.flat_norm_grid(spatial, device=pf.device).expand(B, -1, d)
        return coords.convert_points_norm2real(g, aff_f, spatial) if rw else g

    def store_grid(moved):
        if rw:
            moved = coords.convert_points_real2norm(moved, aff_m, spatial_m)
        grid = torch.flip(moved.reshape(B, *spatial, d), dims=(-1,))
        if want_planes:
            out["planes"] = torch.flip(torch.movedim(grid, -1, 1), dims=(1,)).contiguous()
        else:
            out["grid"] = grid

    if align_type in ("affine", "rigid"):
        fit = solvers.fit_affine if align_type == "affine" else solvers.fit_rigid
        inverse = solvers.square_matrix(fit(pf, pm, weights))
        matrix = torch.linalg.inv_ex(inverse)[0]
        out["matrix"] = matrix
        if compute_grid and rw:
            store_grid(coords.apply_matrix(inverse, grid_points()))
        elif want_planes:
            out["planes"] = affine_flow_planes(inverse, spatial)
        elif compute_grid:
            out["grid"] = affine_flow(inverse, spatial)
        if compute_aligned_points:
            pa = coords.apply_matrix(matrix, pm)
            out["points_a"] = coords.convert_points_real2norm(pa, aff_f, spatial) if rw else pa
        return out

    approx = tps_centers is not None and int(tps_centers) < pf.shape[1]
    S = int(tps_centers) if approx else pf.shape[1]
    if approx:
        theta = solvers.fit_tps_approximate(pf, pm, lmbda, S, weights)
    else:
        theta = solvers.fit_tps(pf, pm, lmbda, weights)
    theta, ctrl = theta.contiguous(), pf[:, :S].contiguous()
    if want_planes and not rw:
        flow = tpsflow.tps_planes_plain if plain else tpsflow.tps_planes
        out["planes"] = flow(theta, ctrl, spatial)
    elif compute_grid:
        evaluate = solvers.tps_eval_chunked_plain if plain else solvers.tps_eval_chunked
        store_grid(evaluate(theta, ctrl, grid_points()))
    if compute_aligned_points:
        if approx:
            back = solvers.fit_tps_approximate(pm, pf, lmbda, S, weights)
        else:
            back = solvers.fit_tps(pm, pf, lmbda, weights)
        pa = solvers.tps_eval(back, pm[:, :S], pm)
        out["points_a"] = coords.convert_points_real2norm(pa, aff_f, spatial) if rw else pa
    return out


def _groupwise_iterate(points: torch.Tensor, lmbda, weights, align_type: str,
                       num_iters: int):
    """``num_iters`` rounds of registering every subject's keypoints (N, K,
    3) to their mean. Returns (the final aligned points, the mean the last
    round registered to: the mean the grids target)."""
    n = points.shape[0]
    lm = lmbda.expand(n) if lmbda is not None else None
    curr, mean = points, None
    for _ in range(num_iters):
        mean = curr.mean(dim=0, keepdim=True)
        curr = align_pair(mean.expand_as(curr), curr, align_type, (), lmbda=lm,
                          weights=weights, compute_grid=False,
                          compute_aligned_points=True)["points_a"]
    return curr, mean


def _groupwise_grids(mean_points: torch.Tensor, pts: torch.Tensor, lmbda, weights,
                     align_type: str, spatial: Sequence[int], num_chunks: int):
    """Dense ``xy`` grids (n, *spatial, d) of a chunk of subjects: each
    subject's original keypoints -> the group mean."""
    return align_pair(mean_points.expand_as(pts), pts, align_type, spatial, lmbda=lmbda,
                      weights=weights, num_chunks=num_chunks, compute_grid=True)["grid"]


class KeyMorph:
    """The registration pipeline with the reference ``KeyMorph`` module's
    API (keymorph_tpu's ``models/keymorph.py:KeyMorph``):

      * ``get_keypoints(img)``;
      * ``model(img_f, img_m, transform_type=[...], return_aligned_points=...)``
        -> ``{type: {grid, points_f, points_m, points_weights, tps_lmbda,
        time_keypoint_extract, time_align, time, [matrix], [points_a]}}``;
      * ``groupwise_register(inputs, transform_type=[...], ...)``.

    The backbone is the port's ``nn.Module`` (``KeyMorphNet.features`` says
    which run on the conv kernels); its dtype is the compute dtype, so
    ``use_amp`` is kept for the signature alone. ``device`` (None = the CUDA card, raising
    without one; tests pass "cpu") holds the net, the inputs and a
    ``torch.Generator`` for the random draws (``seed_rng``). Gradients flow
    only in ``train()`` mode. The time fields are the host clock around
    ``torch.cuda.synchronize``. keymorph_tpu's ``set_allow_pallas`` switch
    (for its GSPMD-partitioned programs) has no counterpart: the port runs
    its kernels wherever the tensors are on the card.
    """

    def __init__(self, backbone: nn.Module, num_keypoints: int, dim: int = 3,
                 keypoint_layer: str = "com", max_train_keypoints: Optional[int] = None,
                 use_amp: bool = False, use_checkpoint: bool = False,
                 weight_keypoints: Optional[str] = None,
                 align_keypoints_in_real_world_coords: bool = False,
                 max_rand_tps_lmbda: float = 10.0, num_subgrids: int = 4,
                 num_tps_centers: Optional[int] = None, device=None):
        if dim not in (2, 3):
            raise ValueError(f"dim={dim}: 2D or 3D registration")
        self.device = resolve_device(device)
        self.net = KeyMorphNet(backbone, num_keypoints, weight_keypoints,
                               keypoint_layer, dim).to(self.device)
        self.num_keypoints = num_keypoints
        self.dim = dim
        self.max_train_keypoints = max_train_keypoints
        self.use_amp = use_amp
        self.use_checkpoint = use_checkpoint
        self.weight_keypoints = weight_keypoints
        self.align_keypoints_in_real_world_coords = align_keypoints_in_real_world_coords
        self.max_rand_tps_lmbda = max_rand_tps_lmbda
        self.num_subgrids = num_subgrids
        # serving only: training uses the exact solver on its keypoint subset
        self.num_tps_centers = num_tps_centers
        self.training = False
        self.seed_rng(0)

    def load_flax_params(self, variables):
        """Load keymorph_tpu ``KeyMorphNet`` variables (numpy or JAX leaves),
        so one set of weights serves both packages."""
        from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax

        self.net.load_state_dict(state_dict_from_flax(variables))
        return self

    def train(self, mode: bool = True):
        self.training = mode
        self.net.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def seed_rng(self, seed: int):
        """Reseed the generator of the random draws (lambda, keypoint
        subsets) on the model's device."""
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def _tensor(self, x) -> torch.Tensor:
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_keypoints(self, img, return_feat: bool = False):
        with torch.set_grad_enabled(self.training):
            return self.net.get_keypoints(self._tensor(img), return_feat=return_feat)

    is_supported_transform_type = staticmethod(is_supported_transform_type)

    def __call__(self, img_f, img_m, transform_type="affine", **kwargs) -> RegistrationResult:
        return self.forward(img_f, img_m, transform_type, **kwargs)

    def pairwise_register(self, *args, **kwargs) -> RegistrationResult:
        return self.forward(*args, **kwargs)

    def forward(self, img_f, img_m, transform_type="affine", **kwargs) -> RegistrationResult:
        """One keypoint extraction, then one alignment per transform type.

        kwargs: ``return_aligned_points`` (default False); ``aff_f``/``aff_m``
        ((B, d+1, d+1) voxel -> world affines) in real-world mode.
        """
        ret_pts = kwargs.get("return_aligned_points", False)
        if not isinstance(transform_type, (list, tuple)):
            transform_type = [transform_type]
        if self.training and len(transform_type) != 1:
            raise ValueError("Only one alignment type in training")
        bad = [s for s in transform_type if not is_supported_transform_type(s)]
        if bad:
            raise ValueError(f"unsupported transform_type {bad}")
        img_f, img_m = self._tensor(img_f), self._tensor(img_m)
        if img_f.shape[1] != 1 or img_m.shape[1] != 1:
            raise ValueError("Image channel must be 1")
        shape_f, shape_m = tuple(img_f.shape[2:]), tuple(img_m.shape[2:])
        aff_f = aff_m = None
        if self.align_keypoints_in_real_world_coords:
            aff_f, aff_m = self._tensor(kwargs["aff_f"]), self._tensor(kwargs["aff_m"])

        with torch.set_grad_enabled(self.training):
            t0 = time.perf_counter()
            extract = self.net.pair_ranked_by_mass if self.num_tps_centers else self.net
            points_f, points_m, weights = extract(img_f, img_m)
            self._sync()
            extract_time = time.perf_counter() - t0

            result: RegistrationResult = {}
            for name in transform_type:
                t0 = time.perf_counter()
                align_type, lmbda_spec = parse_transform_type(name)
                lmbda = None
                p_f, p_m, w = points_f, points_m, weights
                if align_type == "tps":
                    lmbda = sample_tps_lmbda(self._generator, img_f.shape[0], lmbda_spec,
                                             self.max_rand_tps_lmbda, device=self.device)
                    if (self.training and self.max_train_keypoints
                            and self.num_keypoints > self.max_train_keypoints):
                        p_f, p_m, w = subsample_keypoints(self._generator, p_f, p_m, w,
                                                          self.max_train_keypoints)
                aligned = align_pair(
                    p_f, p_m, align_type, shape_f, lmbda=lmbda, weights=w,
                    num_chunks=1 if self.training else self.num_subgrids,
                    compute_grid=True, compute_aligned_points=ret_pts, aff_f=aff_f,
                    aff_m=aff_m, moving_shape=shape_m,
                    tps_centers=(self.num_tps_centers
                                 if align_type == "tps" and not self.training else None))
                self._sync()
                align_time = time.perf_counter() - t0
                res = {"grid": aligned["grid"], "points_f": p_f, "points_m": p_m,
                       "points_weights": w, "tps_lmbda": lmbda,
                       "time_keypoint_extract": extract_time, "time_align": align_time,
                       "time": extract_time + align_time}
                if align_type in ("rigid", "affine"):
                    res["matrix"] = aligned["matrix"]
                if ret_pts:
                    res["points_a"] = aligned["points_a"]
                result[name] = res
        return result

    def _subject_weights(self, feat: torch.Tensor) -> torch.Tensor:
        """Per-subject keypoint confidences, normalized per subject:
        "power" = heatmap mass, "variance" = learned inverse variance."""
        axes = tuple(range(1, feat.dim() - 1))
        f = torch.relu(feat.float())
        if self.weight_keypoints == "power":
            w = f.sum(dim=axes)
        else:
            var = torch.var(f, dim=axes, unbiased=False)
            w = 1.0 / (self.net.scales * var + self.net.biases + 1e-8)
        return w / w.sum(dim=-1, keepdim=True)

    def _subjects(self, inputs):
        """(count, iterator of (1, 1, *S) or (1, *S) volumes) from a
        directory of ``.npz`` files, a list of arrays or ``.npz`` paths, or a
        stacked (N, 1, *S) array or tensor."""
        if isinstance(inputs, str):
            files = sorted(os.path.join(inputs, f) for f in os.listdir(inputs)
                           if f.endswith(".npz"))
            if not files:
                raise ValueError(f"No .npz files found in {inputs}")
            return len(files), (np.load(f)["img"] for f in files)
        if isinstance(inputs, (list, tuple)):
            return len(inputs), (np.load(f)["img"] if isinstance(f, str) else f
                                 for f in inputs)
        return len(inputs), (inputs[i: i + 1] for i in range(len(inputs)))

    def groupwise_register(self, inputs, transform_type="affine", **kwargs) -> RegistrationResult:
        """Iterative mean-keypoint groupwise registration: every subject
        registers to the group's mean keypoints at once, ``num_iters``
        times, then each subject's grid maps its original keypoints to the
        final mean.

        inputs: a directory of ``img_*.npz`` files, a list of arrays or
        ``.npz`` paths, or an (N, 1, *spatial) array or tensor.
        kwargs: ``num_iters`` (default 5), ``kp_batch`` and ``grid_batch``
        (subjects per extraction and per grid chunk, default min(4, N)),
        ``save_results_to_disk``/``save_dir`` (each grid saved as
        ``{type}_grid_{i:03}.npy`` instead of returned), ``log_to_console``.
        With ``weight_keypoints`` each subject's keypoints carry their own
        weights. Chunks are not padded to one size (nothing is compiled per
        shape), which leaves every result as keymorph_tpu's.

        ``mesh`` (a ``keymorph_tpu_torch.parallel.Mesh``; every rank calls
        with the same inputs): the subjects of each chunk are split over the
        mesh's data-parallel axes, each rank extracting its own and
        computing its own grids, and every rank gets the whole result back
        (all-gathered). ``kp_batch`` and ``grid_batch`` then default to the
        data-parallel size and must be multiples of it; the last chunk is
        padded with its last subject. Only rank 0 saves grids to disk.

        Returns ``{type: {time, grouppoints_m (N, K, d), grouppoints_a,
        [grouppoints_weights (N, K)], [groupgrids (N, *spatial, d)]}}``.
        """
        num_iters = int(kwargs.get("num_iters", 5))
        log = kwargs.get("log_to_console", False)
        to_disk = kwargs.get("save_results_to_disk", False) and kwargs.get("save_dir")
        if not isinstance(transform_type, (list, tuple)):
            transform_type = [transform_type]
        num_subjects, loader = self._subjects(inputs)
        mesh = kwargs.get("mesh")
        if mesh is not None:
            from keymorph_tpu_torch.parallel import mesh as pmesh

            mesh = pmesh.require_mesh(mesh)
        save = to_disk and (mesh is None or mesh.is_main)

        def batch_size(key):
            if mesh is None:
                return int(kwargs.get(key, min(4, num_subjects)))
            size = int(kwargs.get(key, mesh.data_size))
            if size % mesh.data_size:
                raise ValueError(f"{key}={size} must be a multiple of the mesh's data-parallel "
                                 f"size ({mesh.data_size})")
            return size

        def fan_out(fn, size, *rows):
            """``fn`` (returning a tuple) of a chunk of subjects' ``rows``; on
            a mesh the chunk is padded to ``size``, each rank takes its
            share and the outputs are gathered whole on every rank."""
            if mesh is None:
                return fn(*rows)
            n, local = rows[0].shape[0], pmesh.local_rows(mesh, size)
            rows = [torch.cat([t, t[-1:].expand(size - n, *t.shape[1:])])[local] for t in rows]
            return tuple(pmesh.gather_cat(o, mesh.data_group)[:n] for o in fn(*rows))

        kp_batch = batch_size("kp_batch")
        points, weights, chunk, spatial = [], [], [], None

        def extract(imgs):
            pts, feat = self.get_keypoints(imgs, return_feat=True)
            return (pts, self._subject_weights(feat)) if self.weight_keypoints else (pts,)

        def flush(chunk):
            out = fan_out(extract, kp_batch, torch.cat(chunk))
            points.append(out[0])
            if self.weight_keypoints:
                weights.append(out[1])

        with torch.no_grad():
            for i, img in enumerate(loader):
                img = self._tensor(img)
                if img.dim() == self.dim + 1:
                    img = img[None]
                spatial = tuple(img.shape[2:])
                chunk.append(img)
                if len(chunk) == kp_batch:
                    flush(chunk)
                    chunk = []
                    if log:
                        print(f"-> Extracted keypoints through subject {i + 1}/{num_subjects}")
            if chunk:
                flush(chunk)
            group_points = torch.cat(points)
            group_weights = torch.cat(weights) if self.weight_keypoints else None

            result: RegistrationResult = {}
            for name in transform_type:
                t0 = time.perf_counter()
                align_type, lmbda_spec = parse_transform_type(name)
                if align_type == "tps" and not isinstance(lmbda_spec, (int, float)):
                    raise ValueError(
                        f"groupwise registration needs a numeric TPS lambda (got "
                        f"tps_{lmbda_spec}); distributional lambdas are a training-time "
                        "feature: pass e.g. transform_type='tps_1'")
                lmbda = (sample_tps_lmbda(self._generator, 1, lmbda_spec, self.max_rand_tps_lmbda,
                                          device=self.device) if align_type == "tps" else None)
                curr, mean_points = _groupwise_iterate(group_points, lmbda, group_weights,
                                                       align_type, num_iters)
                self._sync()
                res = {"time": time.perf_counter() - t0, "grouppoints_m": group_points,
                       "grouppoints_a": curr}
                if group_weights is not None:
                    res["grouppoints_weights"] = group_weights
                grid_batch = batch_size("grid_batch")
                grids = []
                for s in range(0, num_subjects, grid_batch):
                    e = min(s + grid_batch, num_subjects)

                    def chunk_grids(pts, w=None):
                        return (_groupwise_grids(
                            mean_points, pts, lmbda.expand(pts.shape[0]) if lmbda is not None
                            else None, w, align_type, spatial, self.num_subgrids),)

                    g = fan_out(chunk_grids, grid_batch, group_points[s:e],
                                *([] if group_weights is None else [group_weights[s:e]]))[0]
                    if save:
                        g_host = g.cpu().numpy()
                        for j in range(e - s):
                            path = os.path.join(kwargs["save_dir"], f"{name}_grid_{s + j:03}.npy")
                            np.save(path, g_host[j: j + 1])
                            if log:
                                print(f"-> Saved grid {s + j + 1}/{num_subjects} to {path}")
                    elif not to_disk:
                        grids.append(g)
                if grids:
                    res["groupgrids"] = torch.cat(grids)
                result[name] = res
        if log:
            print("Groupwise registration complete!")
        return result
