"""Self-supervised pretraining: regress the keypoints of an affinely
augmented reference image to its reference keypoints pushed through the
same affine.

Port of ``keymorph_tpu/training/pretrain.py``. In real-world mode
(``config.align_keypoints_in_real_world_coords``) the reference keypoints
are sampled in voxels and converted to scanner coordinates through the
subject's affine; each step augments the image and those points with the
same matrix and converts the model's normalized predictions to scanner
coordinates through the ORIGINAL affine (not the augmented one) before the
MSE, as keymorph_tpu and the reference do.

Random draws (the augmentation's parameters) come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from keymorph_tpu_torch import augment
from keymorph_tpu_torch.losses import mse_loss
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.training.config import Config
from keymorph_tpu_torch.training.train import TrainState
from keymorph_tpu_torch.utils import aggregate_dicts, sample_valid_coordinates

PRETRAIN_MAX_PARAMS = (0.2, 0.2, 3.1416, 0.1)  # scale, offset, angle, shear


def make_pretrain_step(net: nn.Module, config: Config, plain: bool = False):
    """The pretraining step.

    Signature::

        step(state, generator, img, ref_points, aug_scale, aff=None, *,
             aug_params=None) -> (state, {"mse", "loss"})

    ``img`` (B, 1, *spatial) and ``ref_points`` (B, K, d) get one random
    affine (``PRETRAIN_MAX_PARAMS`` times the ``aug_scale`` ramp, drawn from
    ``generator``, or ``aug_params`` when given); the loss is the MSE between
    the augmented points and the keypoints the net finds in the augmented
    image. In real-world mode ``ref_points`` are scanner coordinates and
    ``aff`` the subject's (B, d+1, d+1) voxel -> world affine. ``plain`` runs the
    kernels' plain versions (the oracle route on a CUDA device).
    """
    rw = bool(config.align_keypoints_in_real_world_coords)

    def step(state: TrainState, generator, img, ref_points, aug_scale, aff=None, *,
             aug_params=None):
        if rw and aff is None:
            raise ValueError("real-world pretraining needs aff, the subject's voxel -> "
                             "world affine")
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            if aug_params is None:
                aug_params = augment.sample_affine_params(
                    generator, img.shape[0], img.dim() - 2, PRETRAIN_MAX_PARAMS, float(aug_scale),
                    device=img.device)
            img_a, tgt_points = augment.affine_augment_with_params(img, aug_params,
                                                                   points=ref_points)
        pred_points = net.get_keypoints(img_a, plain=plain)
        if rw:
            pred_points = coords.convert_points_norm2real(pred_points, aff, img.shape[2:])
        loss = mse_loss(tgt_points, pred_points)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        return state, {"mse": loss, "loss": loss}

    return step


def pick_reference_subject(loader, config: Config, seed: int = 0, device=None):
    """The pretraining reference: the first image of ``loader``'s first
    batch and ``config.num_keypoints`` points sampled in its support
    (:func:`~keymorph_tpu_torch.utils.sample_valid_coordinates` with
    ``seed``). Returns (img (1, 1, *S), points (1, K, dim), affine (1, dim+1,
    dim+1) or None) on ``device`` (the CPU when None).

    Normalized mode: the points are sampled in [0, 1] ``xy``, mapped to
    [-1, 1] and flipped to ``ij`` (the pipeline's convention). Real-world
    mode: sampled as ``ij`` voxel indices and converted through the batch's
    affine (the identity where it has none)."""
    img_t, aff = reference_image(loader, config, device)
    img = img_t.cpu().numpy()
    if aff is not None:
        pts = sample_valid_coordinates(img, config.num_keypoints, config.dim,
                                       point_space="voxel", indexing="ij", seed=seed).to(device)
        return img_t, coords.convert_points_voxel2real(pts, aff), aff
    pts = sample_valid_coordinates(img, config.num_keypoints, config.dim,
                                   seed=seed) * 2.0 - 1.0
    return img_t, pts.flip(-1).to(device), None


def reference_image(loader, config: Config, device=None):
    """The first image of ``loader``'s first batch, (1, 1, *S) fp32 on
    ``device``, and in real-world mode its (1, dim+1, dim+1) voxel -> world
    affine (the identity where the batch has none; None in normalized
    mode)."""
    batch = next(iter(loader))
    img = torch.tensor(np.asarray(batch["img"], np.float32)[:1], device=device)
    if not config.align_keypoints_in_real_world_coords:
        return img, None
    aff = batch.get("affine")
    aff = (np.eye(config.dim + 1, dtype=np.float32) if aff is None
           else np.asarray(aff, np.float32))
    return img, torch.tensor(aff[None] if aff.ndim == 2 else aff, device=device)[:1]


def run_pretrain(img, ref_points, state: TrainState, step_fn, config: Config, epoch: int,
                 generator, aff=None):
    """One pretraining epoch: ``config.steps_per_epoch`` steps (3 in
    ``debug_mode``) at the ``affine_slope`` ramp's scale. Returns ``(state,
    epoch_stats, generator)``; ``epoch_stats`` holds the mean ``mse`` and
    ``loss`` and the ``epoch_time`` (s)."""
    aug_scale = min(epoch / config.affine_slope, 1.0) if config.affine_slope >= 1 else 1.0
    steps = config.steps_per_epoch if not config.debug_mode else 3
    metrics_list = []
    start = time.time()
    for _ in range(steps):
        state, metrics = step_fn(state, generator, img, ref_points, aug_scale, aff)
        metrics_list.append(metrics)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    stats = aggregate_dicts(metrics_list)
    stats["epoch_time"] = time.time() - start
    return state, stats, generator
