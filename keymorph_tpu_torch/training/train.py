"""Training: one step (augment -> extract -> fit -> flow -> warp -> loss ->
backward -> Adam) and the epoch loop.

Port of ``keymorph_tpu/training/train.py``: ``make_train_step`` (affine,
rigid and TPS; MSE and Dice; affine augmentation with the ``aug_scale``
ramp; TPS keypoint subsampling and per-sample lambda; real-world
coordinates; 3D volumes and 2D images), ``make_kpconsistency_step`` and
``run_train``. TPS in normalized coordinates on volumes runs the
planes-native path (``align_pair(compute_grid="planes")`` then
``align_planes``); affine, rigid and every real-world step run the grid
path (``align_pair(compute_grid=True)`` then ``align_img``), as
keymorph_tpu's step does. 2D images always take the grid path, where the
warp is ``ops.resample.grid_sample_2d``: keymorph_tpu's step sends 2D TPS to
its planes path, which unpacks three sizes and fails, while its
same-resolution step trains 2D TPS on the grid path; ``make_train_step_sameres``
extracts keypoints from volumes resized to the model's size and takes the
loss at the original resolution. On a CUDA device the forward and the
backward go through the port's kernels (conv and its input gradient, TPS
flow and its backward, warp and its gradient).

Random draws come from an explicit ``torch.Generator`` in a fixed order:
augmentation parameters, lambda, keypoint subset.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from keymorph_tpu_torch import augment, resolve_device
from keymorph_tpu_torch.losses import mse_loss, soft_dice_loss
from keymorph_tpu_torch.models.keymorph import (
    align_pair,
    parse_transform_type,
    sample_tps_lmbda,
    subsample_keypoints,
)
from keymorph_tpu_torch.ops.cuda import resample3d
from keymorph_tpu_torch.ops.resample import grid_sample_2d, grid_to_planes
from keymorph_tpu_torch.ops.resize import resize_trilinear
from keymorph_tpu_torch.tracing import span
from keymorph_tpu_torch.training.config import Config
from keymorph_tpu_torch.utils import aggregate_dicts, one_hot, one_hot_subsampled_pair

LARGE_VOLUME = 77_594_624  # voxels; batches at or above it are skipped


@dataclasses.dataclass
class TrainState:
    """What a training run carries: the net (its parameters), the optimizer
    (its state) and the number of steps taken."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, net: nn.Module, optimizer: torch.optim.Optimizer):
        return cls(net=net, optimizer=optimizer, step=0)

    @property
    def params(self):
        return dict(self.net.named_parameters())


def make_optimizer(config: Config, net: nn.Module) -> torch.optim.Optimizer:
    """Adam(lr) with PyTorch's defaults (betas 0.9 / 0.999, eps 1e-8, no
    weight decay): the update of ``optax.adam(lr)``."""
    return torch.optim.Adam(net.parameters(), lr=config.lr)


def _global_norm(params) -> torch.Tensor:
    sq = [torch.sum(p.grad.float() ** 2) for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def make_train_step(net: nn.Module, config: Config, plain: bool = False):
    """Build the training step for ``config.transform_type``.

    Returned signature::

        step(state, generator, img_f, img_m, seg_f, seg_m, aug_scale,
             aff_f=None, aff_m=None, *, lmbda=None, keypoint_idx=None,
             aug_params=None) -> (state, metrics)

    ``seg_f``/``seg_m`` may be None (MSE). ``aug_scale`` is the affine-slope
    ramp factor. With ``config.align_keypoints_in_real_world_coords`` the
    step needs ``aff_f``/``aff_m``, the (B, d+1, d+1) voxel -> world affines; the
    augmentation matrix composes into the moving one (``aff_m @ aug``) and
    the fit runs in scanner coordinates. ``lmbda`` (B,), ``keypoint_idx`` and
    ``aug_params`` (the augmentation's (scale, offset, theta, shear), applied
    whatever ``config.max_random_affine_augment_params`` says) override the
    draws from ``generator`` (so a test can inject another framework's).
    ``metrics`` holds 0-d tensors: ``loss``, ``mse`` or
    ``softdice``/``softdiceloss``, and ``grad_norm`` (the global L2 norm of
    the gradients). The update is the state's optimizer's.

    ``plain=True`` runs every kernel's plain PyTorch version instead (the
    oracle route on a CUDA device; CPU tensors take the plain versions either
    way).
    """
    return _make_step(net, config, plain, model_size=None)


def make_train_step_sameres(net: nn.Module, config: Config, plain: bool = False):
    """The same-resolution step (keymorph_tpu's ``make_train_step_sameres``,
    the reference's ``run_train_sameres``): the images come at their
    original (per-dataset) resolution; after the augmentation both are
    resized to ``config.img_size`` (``ops/resize.py``, antialiased as
    ``jax.image.resize``) for keypoint extraction, and the flow and the loss
    are computed at the fixed image's ORIGINAL resolution on the grid path
    (``align_pair(compute_grid=True)``: the TPS flow's points mode, then the
    warp of the grid's planes). Signature, draws, overrides and metrics are
    :func:`make_train_step`'s."""
    return _make_step(net, config, plain, model_size=tuple(config.img_size))


def _make_step(net: nn.Module, config: Config, plain: bool, model_size):
    align_type, lmbda_spec = parse_transform_type(config.transform_type)
    rw = bool(config.align_keypoints_in_real_world_coords)
    planes_path = align_type == "tps" and not rw and model_size is None
    use_dice = config.loss_fn == "dice"
    max_params = tuple(config.max_random_affine_augment_params)
    warp_planes = resample3d.warp_planes_plain if plain else resample3d.warp_planes

    def warp(flow, x, use_planes):  # align_planes / align_img
        if use_planes:
            return warp_planes(x, flow)
        if flow.shape[-1] == 2:
            return grid_sample_2d(x, flow)
        return warp_planes(x, grid_to_planes(flow))

    def loss_fn(generator, img_f, img_m, seg_f, seg_m, aug_scale, aff_f, aff_m, lmbda,
                keypoint_idx, aug_params):
        if aug_params is not None or any(p > 0 for p in max_params):
            with torch.no_grad(), span("train.augment"):
                seg = seg_m if use_dice else None
                if aug_params is None:
                    out = augment.random_affine_augment(
                        generator, img_m, seg=seg, max_random_params=max_params,
                        scale_params=aug_scale, return_affine_matrix=True)
                else:
                    out = augment.affine_augment_with_params(img_m, aug_params, seg=seg,
                                                             return_affine_matrix=True)
                if use_dice:
                    img_m, seg_m, aug_M = out
                else:
                    img_m, aug_M = out
                if rw:
                    aff_m = aff_m @ aug_M

        with span("train.extract"):
            if model_size is None:
                points_f, points_m, weights = net(img_f, img_m, plain=plain)
            else:  # keypoints from the model's resolution, the loss at the original
                points_f, points_m, weights = net(resize_trilinear(img_f, model_size),
                                                  resize_trilinear(img_m, model_size),
                                                  plain=plain)

        if align_type == "tps":
            if lmbda is None:
                lmbda = sample_tps_lmbda(generator, img_f.shape[0], lmbda_spec,
                                         config.max_train_tps_lmbda, device=img_f.device)
            if config.max_train_keypoints and config.num_keypoints > config.max_train_keypoints:
                points_f, points_m, weights = subsample_keypoints(
                    generator, points_f, points_m, weights, config.max_train_keypoints,
                    idx=keypoint_idx)
        else:
            lmbda = None

        use_planes = planes_path and img_f.dim() == 5
        flow = align_pair(points_f, points_m, align_type, img_f.shape[2:], lmbda=lmbda,
                          weights=weights, compute_grid="planes" if use_planes else True,
                          aff_f=aff_f if rw else None, aff_m=aff_m if rw else None,
                          moving_shape=img_m.shape[2:], plain=plain)
        flow = flow["planes" if use_planes else "grid"]
        with span("train.loss"):
            if use_dice:
                loss = soft_dice_loss(warp(flow, seg_m, use_planes), seg_f)
                metrics = {"softdiceloss": loss, "softdice": 1.0 - loss}
            else:
                loss = mse_loss(img_f, warp(flow, img_m, use_planes))
                metrics = {"mse": loss}
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, generator, img_f, img_m, seg_f, seg_m, aug_scale,
             aff_f=None, aff_m=None, *, lmbda=None, keypoint_idx=None, aug_params=None):
        if rw and (aff_f is None or aff_m is None):
            raise ValueError("real-world-coordinate training needs aff_f and aff_m "
                             "(the images' voxel -> world affines)")
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(generator, img_f, img_m, seg_f, seg_m, float(aug_scale),
                                aff_f, aff_m, lmbda, keypoint_idx, aug_params)
        with span("train.backward"):
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with span("train.optimizer"):
            metrics["grad_norm"] = _global_norm(net.parameters())
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_kpconsistency_step(net: nn.Module, config: Config):
    """Keypoint-consistency step: two modalities of the SAME subject get the
    SAME random affine and their keypoints should coincide:
    ``loss = coeff * MSE(points(sub1_aug), points(sub2_aug))``.

    Signature: ``step(state, generator, sub1, sub2, aug_scale) -> (state,
    {"kploss": loss})``."""
    coeff = config.kpconsistency_coeff

    def step(state: TrainState, generator, sub1, sub2, aug_scale):
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            m1, m2 = augment.random_affine_augment_pair(generator, sub1, sub2,
                                                        scale_params=float(aug_scale))
        loss = coeff * mse_loss(net.get_keypoints(m1), net.get_keypoints(m2))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"kploss": loss.detach()}

    return step


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
        device=device, dtype=dtype)


def _affine(batch, batch_size: int, d1: int, device) -> torch.Tensor:
    """A batch's (B, d1, d1) voxel -> world affine (d1 = dim + 1), the
    identity without one (a source without headers is in voxel space)."""
    a = batch.get("affine")
    if a is None:
        return torch.eye(d1, device=device).repeat(batch_size, 1, 1)
    a = _tensor(a, device)
    return a[None].repeat(batch_size, 1, 1) if a.dim() == 2 else a


def run_train(loader, state: TrainState, step_fn, config: Config, epoch: int,
              generator: Optional[torch.Generator], kp_step_fn=None,
              modality_datasets=None, device=None):
    """One training epoch: ``config.steps_per_epoch`` batches (3 in
    ``debug_mode``) from the re-cycling ``loader`` of ``(fixed, moving)``
    pairs of ``{"img", "seg"}`` dicts, with the affine-slope ramp.

    When ``kp_step_fn`` and ``modality_datasets`` (modality -> indexable
    dataset of same-ordered subjects) are given and
    ``config.kpconsistency_coeff > 0``, each step also runs a
    keypoint-consistency update on a random same-subject cross-modality
    pair. Batches move to ``device`` (the CUDA card when None). With
    ``config.align_keypoints_in_real_world_coords`` each batch's
    ``"affine"`` (4, 4) or (B, 4, 4) voxel -> world matrix goes to the step
    as ``aff_f``/``aff_m``, the identity where a batch has none.

    Returns ``(state, epoch_stats, generator)``.
    """
    device = resolve_device(device)
    aug_scale = min(epoch / config.affine_slope, 1.0) if config.affine_slope >= 1 else 1.0

    metrics_list = []
    steps = config.steps_per_epoch if not config.debug_mode else 3
    it = iter(loader)
    start = time.time()

    prof = None
    if config.use_profiler and epoch == 1:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()

    for _ in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        b_f, b_m = batch
        if (np.prod(b_f["img"].shape) >= LARGE_VOLUME
                or np.prod(b_m["img"].shape) >= LARGE_VOLUME):
            print("Skipping large image")
            continue
        img_f = _tensor(b_f["img"], device)
        img_m = _tensor(b_m["img"], device)
        seg_f = seg_m = None
        if config.loss_fn == "dice":
            if config.max_train_seg_channels:
                seg_f, seg_m = one_hot_subsampled_pair(
                    b_f["seg"], b_m["seg"], config.max_train_seg_channels, device=device)
            else:
                # pin the one-hot channel count for the whole run on the step
                # function, so every step sees the same segmentation shape
                batch_max = int(max(np.asarray(b_f["seg"]).max(),
                                    np.asarray(b_m["seg"]).max())) + 1
                n_cls = getattr(step_fn, "_n_cls_pin", None)
                if n_cls is None:
                    n_cls = batch_max
                    step_fn._n_cls_pin = n_cls
                if batch_max > n_cls:
                    print(f"WARNING: labels >= {n_cls} clipped (set "
                          "max_train_seg_channels for datasets with ragged label sets)")
                seg_f = one_hot(_tensor(b_f["seg"], device, torch.long).clamp(0, n_cls - 1), n_cls)
                seg_m = one_hot(_tensor(b_m["seg"], device, torch.long).clamp(0, n_cls - 1), n_cls)

        affines = {}
        if config.align_keypoints_in_real_world_coords:
            d1 = img_f.dim() - 1
            affines = {"aff_f": _affine(b_f, img_f.shape[0], d1, device),
                       "aff_m": _affine(b_m, img_m.shape[0], d1, device)}
        state, metrics = step_fn(state, generator, img_f, img_m, seg_f, seg_m, aug_scale,
                                 **affines)

        if (kp_step_fn is not None and modality_datasets and len(modality_datasets) >= 2
                and config.kpconsistency_coeff > 0):
            mods = list(modality_datasets.keys())
            gdev = generator.device if generator is not None else "cpu"
            sel = torch.randperm(len(mods), generator=generator, device=gdev)
            ds1, ds2 = modality_datasets[mods[int(sel[0])]], modality_datasets[mods[int(sel[1])]]
            idx = int(torch.randint(0, min(len(ds1), len(ds2)), (), generator=generator,
                                    device=gdev))
            sub1 = _tensor(ds1[idx]["img"], device)[None]
            sub2 = _tensor(ds2[idx]["img"], device)[None]
            state, kp_metrics = kp_step_fn(state, generator, sub1, sub2, aug_scale)
            metrics = {**metrics, **kp_metrics}
        metrics_list.append(metrics)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_dir = os.path.join(config.model_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"epoch{epoch}.json"))
        print(f"Profiler trace written to {trace_dir}")
    stats = aggregate_dicts(metrics_list)
    stats["epoch_time"] = time.time() - start
    stats["steps_per_sec"] = steps / stats["epoch_time"]
    return state, stats, generator
