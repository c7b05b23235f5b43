"""Training: one step (augment -> extract -> fit -> flow -> warp -> loss ->
backward -> Adam) and the epoch loop.

Port of ``keymorph_tpu/training/train.py`` for pairwise TPS registration in
normalized coordinates: ``make_train_step`` (MSE and Dice, affine
augmentation with the ``aug_scale`` ramp, keypoint subsampling, per-sample
lambda), ``make_kpconsistency_step`` and ``run_train``. The step runs the
planes-native path: ``align_pair(compute_grid="planes")`` then
``align_planes``, so on a CUDA device the forward and the backward go through
the port's kernels (conv and its input gradient, TPS flow and its backward,
warp and its gradient). Affine/rigid training, real-world coordinates
(``aff_f``/``aff_m``) and the same-resolution variant are not ported yet
(ROADMAP A4, A6).

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
from keymorph_tpu_torch.ops.resample import align_planes
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


def _reject_unported(config: Config, aff_f=None, aff_m=None):
    align_type, lmbda_spec = parse_transform_type(config.transform_type)
    if align_type != "tps":
        raise NotImplementedError(
            f"training with transform_type={config.transform_type!r} is not ported: "
            "only TPS (ROADMAP A4, affine/rigid alignment)")
    if config.align_keypoints_in_real_world_coords or aff_f is not None or aff_m is not None:
        raise NotImplementedError(
            "real-world-coordinate training (aff_f/aff_m) is not ported (ROADMAP A4)")
    return lmbda_spec


def make_train_step(net: nn.Module, config: Config, plain: bool = False):
    """Build the training step for ``config.transform_type`` (TPS).

    Returned signature::

        step(state, generator, img_f, img_m, seg_f, seg_m, aug_scale,
             aff_f=None, aff_m=None, *, lmbda=None, keypoint_idx=None)
            -> (state, metrics)

    ``seg_f``/``seg_m`` may be None (MSE). ``aug_scale`` is the affine-slope
    ramp factor. ``lmbda`` (B,) and ``keypoint_idx`` override the draws from
    ``generator`` (so a test can inject another framework's). ``metrics``
    holds 0-d tensors: ``loss``, ``mse`` or ``softdice``/``softdiceloss``,
    and ``grad_norm`` (the global L2 norm of the gradients). The update is
    the state's optimizer's.

    ``plain=True`` runs every kernel's plain PyTorch version instead (the
    oracle route on a CUDA device; CPU tensors take the plain versions either
    way).
    """
    lmbda_spec = _reject_unported(config)
    use_dice = config.loss_fn == "dice"
    max_params = tuple(config.max_random_affine_augment_params)
    if plain:
        def warp(planes, x):
            return resample3d.warp_planes_plain(x, planes)
    else:
        warp = align_planes

    def loss_fn(generator, img_f, img_m, seg_f, seg_m, aug_scale, lmbda, keypoint_idx):
        if any(p > 0 for p in max_params):
            with torch.no_grad():
                if use_dice:
                    img_m, seg_m = augment.random_affine_augment(
                        generator, img_m, seg=seg_m, max_random_params=max_params,
                        scale_params=aug_scale)
                else:
                    img_m = augment.random_affine_augment(
                        generator, img_m, max_random_params=max_params,
                        scale_params=aug_scale)

        points_f, points_m, weights = net(img_f, img_m, plain=plain)

        if lmbda is None:
            lmbda = sample_tps_lmbda(generator, img_f.shape[0], lmbda_spec,
                                     config.max_train_tps_lmbda, device=img_f.device)
        if config.max_train_keypoints and config.num_keypoints > config.max_train_keypoints:
            points_f, points_m, weights = subsample_keypoints(
                generator, points_f, points_m, weights, config.max_train_keypoints,
                idx=keypoint_idx)

        planes = align_pair(points_f, points_m, "tps", img_f.shape[2:], lmbda=lmbda,
                            weights=weights, compute_grid="planes", plain=plain)["planes"]
        if use_dice:
            loss = soft_dice_loss(warp(planes, seg_m), seg_f)
            metrics = {"softdiceloss": loss, "softdice": 1.0 - loss}
        else:
            loss = mse_loss(img_f, warp(planes, img_m))
            metrics = {"mse": loss}
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, generator, img_f, img_m, seg_f, seg_m, aug_scale,
             aff_f=None, aff_m=None, *, lmbda=None, keypoint_idx=None):
        _reject_unported(config, aff_f, aff_m)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(generator, img_f, img_m, seg_f, seg_m, float(aug_scale),
                                lmbda, keypoint_idx)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
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


def make_train_step_sameres(net: nn.Module, config: Config):
    """Same-resolution training variant of keymorph_tpu; not ported."""
    raise NotImplementedError(
        "make_train_step_sameres (train_same_resolution) is not ported (ROADMAP A6)")


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
        device=device, dtype=dtype)


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
    pair. Batches move to ``device`` (the CUDA card when None).

    Returns ``(state, epoch_stats, generator)``.
    """
    device = resolve_device(device)
    if config.align_keypoints_in_real_world_coords:
        _reject_unported(config)
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

        state, metrics = step_fn(state, generator, img_f, img_m, seg_f, seg_m, aug_scale)

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
