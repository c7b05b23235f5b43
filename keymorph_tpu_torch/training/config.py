"""Configuration: the typed dataclass of the training and evaluation flags
(a copy of ``keymorph_tpu/training/config.py``'s field set, so a saved config
moves between the two packages), the backbone factory and the model
factory."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # I/O
    job_name: str = "keymorph"
    save_dir: str = "./output/"
    load_path: Optional[str] = None
    # restore params only from load_path (fresh optimizer/step) — the
    # reference's default load semantics: script_utils.py:59-81 loads the
    # backbone state_dict only; optimizer state is restored only on resume
    # (run.py:441-456). Use for the pretrain -> train handoff.
    load_weights_only: bool = False
    resume: bool = False
    resume_latest: bool = False
    visualize: bool = False
    log_interval: int = 25

    # KeyMorph
    num_keypoints: int = 128
    loss_fn: str = "mse"  # "mse" | "dice"
    transform_type: str = "affine"
    max_train_keypoints: Optional[int] = 64
    max_train_seg_channels: Optional[int] = None
    kp_layer: str = "com"  # "com" | "linear"
    kpconsistency_coeff: float = 0.0
    weighted_kp_align: Optional[str] = None  # None | "variance" | "power"
    # NOTE: the reference's --compute_subgrids_for_tps (run.py:107) and
    # --num_test_subjects (run.py:181) are parsed-but-never-read there too
    # (model.py:267 hardcodes subgrids to `not training`); they are
    # deliberately NOT carried here — num_subgrids and
    # early_stop_eval_subjects are the live knobs.
    max_train_tps_lmbda: float = 10.0
    num_subgrids: int = 4
    # serving-only approximate TPS: first-S RBF centers, least-squares fit
    # (the reference's commented ApproximateTPS, keypoint_aligners.py:468-590)
    num_tps_centers: Optional[int] = None
    max_random_affine_augment_params: Tuple[float, float, float, float] = (
        0.0, 0.0, 0.0, 0.0,
    )
    align_keypoints_in_real_world_coords: bool = False

    # Backbone
    backbone: str = "conv"  # conv | unet | truncatedunet | residualunet[se]
    num_truncated_layers_for_truncatedunet: int = 1
    num_levels_for_unet: int = 4
    train_same_resolution: bool = False

    # Data
    data_path: str = "./data"
    train_dataset: str = "csv"  # "csv" | "ixi"
    mix_modalities: bool = False
    num_workers: int = 1
    img_size: Tuple[int, int, int] = (128, 128, 128)

    # ML
    batch_size: int = 1
    norm_type: str = "instance"
    lr: float = 3e-6
    epochs: int = 2000
    steps_per_epoch: int = 32
    affine_slope: int = -1

    # Misc
    run_mode: str = "train"  # "train" | "pretrain" | "eval"
    debug_mode: bool = False
    seed: int = 23
    dim: int = 3
    use_amp: bool = False
    early_stop_eval_subjects: Optional[int] = None
    use_checkpoint: bool = False
    use_profiler: bool = False
    skip_if_completed: bool = False
    # save per-pair .npy artifacts during eval (img/seg/grid/points — the
    # reference's pairwise_register_eval.py:368-461 layout). Disable for
    # full-protocol sweeps where only metrics JSONs are wanted (~25 GB).
    save_eval_artifacts: bool = True

    # wandb
    use_wandb: bool = False
    wandb_api_key_path: Optional[str] = None
    wandb_kwargs: dict = dataclasses.field(default_factory=dict)

    # devices
    num_devices: Optional[int] = None  # data-parallel devices (None = all)

    # derived
    @property
    def model_dir(self):
        return os.path.join(self.save_dir, self.job_name)

    @property
    def seg_available(self):
        return self.loss_fn == "dice"

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as fh:
            d = json.load(fh)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        for key in ("max_random_affine_augment_params", "img_size"):
            if key in d and isinstance(d[key], list):
                d[key] = tuple(d[key])
        return cls(**d)


def build_backbone(config: Config, dtype=None):
    """Backbone factory, every family of keymorph_tpu's: ``conv`` (the
    ConvNet with ``config.norm_type``, 3D or 2D), ``unet`` (``UNet3D`` with
    f_maps 32, or ``UNet2D`` with f_maps 64 at ``dim`` 2), and the 3D-only
    ``truncatedunet``, ``residualunet`` and ``residualunetse``; bf16 with
    ``use_amp``, else fp32."""
    import torch

    from keymorph_tpu_torch.models.convnet import ConvNet
    from keymorph_tpu_torch.models.unet import (
        ResidualUNet3D,
        ResidualUNetSE3D,
        TruncatedUNet3D,
        UNet2D,
        UNet3D,
    )

    dtype = dtype or (torch.bfloat16 if config.use_amp else torch.float32)
    families = ("conv", "unet", "truncatedunet", "residualunet", "residualunetse")
    if config.backbone not in families:
        raise ValueError(f'Invalid keypoint extractor "{config.backbone}"')
    if config.backbone == "conv":
        return ConvNet(out_dim=config.num_keypoints, norm_type=config.norm_type, dtype=dtype,
                       dim=config.dim)
    kw = dict(out_channels=config.num_keypoints, num_levels=config.num_levels_for_unet,
              dtype=dtype, use_checkpoint=config.use_checkpoint)
    if config.backbone == "unet" and config.dim == 2:
        return UNet2D(f_maps=64, **kw)
    if config.dim != 3:
        raise ValueError(f'keypoint extractor "{config.backbone}" is 3D only (dim '
                         f'{config.dim}), as in keymorph_tpu')
    if config.backbone == "truncatedunet":
        return TruncatedUNet3D(
            f_maps=32, num_truncated_layers=config.num_truncated_layers_for_truncatedunet, **kw)
    return {"unet": UNet3D, "residualunet": ResidualUNet3D,
            "residualunetse": ResidualUNetSE3D}[config.backbone](f_maps=32, **kw)


def build_model(config: Config, device=None):
    """The registration pipeline of ``config``: a ``KeyMorph`` on ``device``
    (None: the CUDA card) with the config's keypoints, real-world flag,
    keypoint weighting, subgrids and TPS centres, over the backbone of
    :func:`build_backbone` and its keypoint head, initialized from
    ``config.seed`` (``models.unet.init_weights``; a checkpoint usually
    replaces it)."""
    import torch

    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.models.unet import init_weights

    model = KeyMorph(
        backbone=build_backbone(config),
        num_keypoints=config.num_keypoints,
        dim=config.dim,
        keypoint_layer=config.kp_layer,
        max_train_keypoints=config.max_train_keypoints,
        use_amp=config.use_amp,
        use_checkpoint=config.use_checkpoint,
        weight_keypoints=config.weighted_kp_align,
        align_keypoints_in_real_world_coords=config.align_keypoints_in_real_world_coords,
        max_rand_tps_lmbda=config.max_train_tps_lmbda,
        num_subgrids=config.num_subgrids,
        num_tps_centers=config.num_tps_centers,
        device=device,
    )
    init_weights(model.net, torch.Generator().manual_seed(int(config.seed)))
    return model
