"""User-facing registration CLI (pairwise and groupwise inference). Port of
``keymorph_tpu/cli/register.py``: the same arguments, names and defaults,
plus ``--device``; the same metric keys, JSONs and ``.npy`` artifacts.

Usage (the flagship net on the card):
    python -m keymorph_tpu_torch.cli.register \\
        --moving moving.nii.gz --fixed fixed.nii.gz \\
        --moving_seg mseg.nii.gz --fixed_seg fseg.nii.gz \\
        --backbone truncatedunet --use_amp --num_keypoints 128 \\
        --list_of_aligns rigid affine tps_1 --list_of_metrics mse harddice \\
        --load_path weights.pt --save_dir ./register_output
    python -m keymorph_tpu_torch.cli.register --groupwise --moving dir_of_niftis/ \\
        --backbone truncatedunet --use_amp --load_path weights.pt

Every 3D ``--backbone`` of keymorph_tpu runs (the default ``conv``, ``unet``,
``truncatedunet``, ``residualunet``, ``residualunetse``), in bf16 with
``--use_amp`` and else in fp32 (TF32 off on the card); the bf16 U-Nets in
layer order 'gcr' (``truncatedunet``, ``unet``) run on the port's conv
kernels, the others on PyTorch's convolutions, as keymorph_tpu runs them on
flax's.

``--load_path``: a ``.pt``/``.pth``/``.tar``/``.h5`` file is a reference
torch checkpoint (a backbone ``state_dict``, bare or under ``state_dict``,
with ``backbone.``/``module.`` prefixes), loaded strictly (a batch norm's
running statistics, which the port's batch norm does not keep, are dropped;
an instance norm's scale and bias, which the reference's affine-free
``InstanceNorm3d`` lacks, keep their identity init); another path is a
checkpoint directory of the port (``training/checkpoint.py``). A
keymorph_tpu (Orbax) checkpoint directory is refused: load it with
keymorph_tpu and carry its parameters over with
``keymorph_tpu_torch/tools/import_flax_params.py``
(``KeyMorph.load_flax_params``).

On several GPUs, one process each (``torchrun --nproc_per_node N -m
keymorph_tpu_torch.cli.register ...``), the pairs fan out over the
processes (``eval_pairwise.run_eval(mesh=...)``) and a group's extraction
and grids over them (``KeyMorph.groupwise_register(mesh=...)``); rank 0
alone prints the final metrics.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

TORCH_CHECKPOINT_SUFFIXES = (".pt", ".pth", ".h5", ".pt.tar", ".tar")


def parse_args(argv=None):
    p = argparse.ArgumentParser("keymorph_tpu_torch.register")
    p.add_argument("--moving", type=str, required=True,
                   help="Moving image path (or directory for --groupwise)")
    p.add_argument("--fixed", type=str, default=None, help="Fixed image path")
    p.add_argument("--moving_seg", type=str, default=None)
    p.add_argument("--fixed_seg", type=str, default=None)
    p.add_argument("--groupwise", action="store_true")
    p.add_argument("--num_keypoints", type=int, default=128)
    p.add_argument("--backbone", type=str, default="conv")
    p.add_argument("--num_levels_for_unet", type=int, default=4)
    p.add_argument("--num_truncated_layers_for_truncatedunet", type=int, default=1)
    p.add_argument("--load_path", type=str, default=None, help="Checkpoint path")
    p.add_argument("--list_of_aligns", nargs="*", default=["affine"])
    p.add_argument("--list_of_metrics", nargs="*", default=["mse"])
    p.add_argument("--list_of_augs", nargs="*", default=["rot0"])
    p.add_argument("--save_dir", type=str, default="./register_output/")
    p.add_argument("--save_eval_to_disk", action="store_true")
    p.add_argument("--half_resolution", action="store_true")
    p.add_argument("--size", type=int, default=None,
                   help="Override the working resolution (default 256, or 128 "
                        "with --half_resolution)")
    p.add_argument("--align_keypoints_in_real_world_coords", action="store_true")
    p.add_argument("--weighted_kp_align", type=str, default=None)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--num_subgrids", type=int, default=4)
    p.add_argument("--num_tps_centers", type=int, default=None,
                   help="Approximate-TPS serving: use only the first S "
                        "keypoints as RBF centers (O(S)/voxel flow; for "
                        "num_keypoints >= 256)")
    p.add_argument("--group_size", type=int, default=8)
    p.add_argument("--early_stop_eval_subjects", type=int, default=None)
    p.add_argument("--use_amp", action="store_true")
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--skip_if_completed", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--debug_mode", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help='Device to run on (default: the CUDA card; "cpu" runs the '
                        "kernels' plain versions)")
    return p.parse_args(argv)


def _gather_paths(path):
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.endswith((".nii", ".nii.gz", ".npy")))
    return [path]


def _strip_prefixes(state_dict):
    """Drop DataParallel / pipeline prefixes (``backbone.``, ``module.``),
    in any order and number."""
    out = {}
    for k, v in state_dict.items():
        while k.startswith(("backbone.", "module.")):
            k = k.split(".", 1)[1]
        out[k] = v
    return out


def load_weights(model, path: str):
    """Load ``path`` into ``model`` (a ``KeyMorph``) as the module docstring
    says; every other key must match (missing or unexpected keys raise)."""
    import torch

    from keymorph_tpu_torch.models.layers import GroupNorm
    from keymorph_tpu_torch.training import checkpoint as ckpt

    if path.endswith(TORCH_CHECKPOINT_SUFFIXES):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v for k, v in _strip_prefixes(sd).items()
              if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                              "num_batches_tracked")}
        backbone = model.net.backbone
        if getattr(backbone, "norm_type", None) == "instance":
            own = backbone.state_dict()
            for name, m in backbone.named_modules():
                if isinstance(m, GroupNorm):  # affine-free in the reference
                    for leaf in ("weight", "bias"):
                        sd.setdefault(f"{name}.{leaf}", own[f"{name}.{leaf}"])
        backbone.load_state_dict(sd, strict=True)
        print(f"Imported torch reference checkpoint {path}")
        return
    if os.path.isdir(path) and not os.path.isfile(os.path.join(path, "checkpoint.pt")):
        raise ValueError(
            f"{path} is not a keymorph_tpu_torch checkpoint directory (no checkpoint.pt); "
            "a keymorph_tpu (Orbax) checkpoint is loaded with keymorph_tpu and carried over "
            "with keymorph_tpu_torch/tools/import_flax_params.py (KeyMorph.load_flax_params)")
    payload = ckpt.load_checkpoint(path)
    model.net.load_state_dict(payload["params"], strict=True)
    print(f"Loaded checkpoint {path}")


def _timed_preprocessor(size, stage_times):
    """The CLI's Preprocessor; with ``stage_times``, each subject's decode
    and preprocessing (in the prefetch thread) adds its wall seconds to
    ``stage_times["decode_preprocess"]``."""
    from keymorph_tpu_torch.data import Preprocessor

    class _Timed(Preprocessor):
        def load(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().load(*args, **kwargs)
            stage_times["decode_preprocess"] = (stage_times.get("decode_preprocess", 0.0)
                                                + time.perf_counter() - t0)
            return out

    return (Preprocessor if stage_times is None else _Timed)(size=(size,) * 3)


def main(argv=None, stage_times=None):
    """Run the CLI; returns the metrics dict. ``stage_times``: a dict that
    receives wall seconds per stage (decode and preprocessing, then
    ``eval_pairwise.run_eval``'s stages), for a caller that profiles the
    run."""
    args = parse_args(argv)
    if args.visualize:
        from keymorph_tpu_torch.viz import require_matplotlib

        require_matplotlib()

    from keymorph_tpu_torch import disable_tf32, resolve_device
    from keymorph_tpu_torch.cli.eval_groupwise import run_group_eval
    from keymorph_tpu_torch.cli.eval_pairwise import run_eval
    from keymorph_tpu_torch.data import ThreadPrefetcher
    from keymorph_tpu_torch.data.datasets import DataLoader, PairedDataset, SingleDataset, Subject
    from keymorph_tpu_torch.parallel.mesh import launch_mesh
    from keymorph_tpu_torch.training.config import Config, build_model

    mesh = launch_mesh(args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if device.type == "cuda":  # fp32 backbones run cuDNN in full fp32
        disable_tf32()
    size = args.size or (128 if args.half_resolution else 256)
    transform = _timed_preprocessor(size, stage_times)

    config = Config(
        num_keypoints=args.num_keypoints,
        backbone=args.backbone,
        num_levels_for_unet=args.num_levels_for_unet,
        num_truncated_layers_for_truncatedunet=args.num_truncated_layers_for_truncatedunet,
        align_keypoints_in_real_world_coords=args.align_keypoints_in_real_world_coords,
        weighted_kp_align=args.weighted_kp_align,
        num_subgrids=args.num_subgrids,
        num_tps_centers=args.num_tps_centers,
        use_amp=args.use_amp,
        dim=args.dim,
        seed=args.seed,
        save_dir=args.save_dir,
    )
    model = build_model(config, device=device)
    model.seed_rng(args.seed)
    if args.load_path:
        load_weights(model, args.load_path)
    model.eval()

    save_dir = Path(args.save_dir)
    os.makedirs(save_dir, exist_ok=True)

    class EvalArgs:
        pass

    ea = EvalArgs()
    ea.model_eval_dir = save_dir
    ea.visualize = args.visualize
    ea.early_stop_eval_subjects = args.early_stop_eval_subjects
    ea.skip_if_completed = args.skip_if_completed
    ea.seg_available = args.moving_seg is not None or args.groupwise
    ea.dim = args.dim
    ea.save_eval_to_disk = True
    ea.batch_size = 1
    ea.debug_mode = args.debug_mode

    if args.groupwise:
        moving_paths = _gather_paths(args.moving)
        if args.moving_seg:
            seg_paths = _gather_paths(args.moving_seg)
            if len(seg_paths) != len(moving_paths):
                raise ValueError(f"--moving_seg dir has {len(seg_paths)} files but --moving "
                                 f"has {len(moving_paths)}; they pair by sorted order")
        else:
            seg_paths = [None] * len(moving_paths)
        subjects = [Subject(img_path=p, seg_path=s, modality="group")
                    for p, s in zip(moving_paths, seg_paths)]
        ea.seg_available = args.moving_seg is not None
        ea.mesh = mesh
        loader = {"group": SingleDataset(subjects, transform)}
        metrics = run_group_eval(loader, model, args.list_of_metrics, ["group"],
                                 args.list_of_augs, args.list_of_aligns,
                                 [min(args.group_size, len(subjects))], ea)
    else:
        if args.fixed is None:
            raise ValueError("--fixed required for pairwise")
        fixed = [Subject(img_path=p, seg_path=args.fixed_seg, modality="fixed")
                 for p in _gather_paths(args.fixed)]
        moving = [Subject(img_path=p, seg_path=args.moving_seg, modality="moving")
                  for p in _gather_paths(args.moving)]
        loader = DataLoader(PairedDataset(list(zip(fixed, moving)), transform), batch_size=1)
        # the next pair's NIfTI decode overlaps this pair's device work
        loader = ThreadPrefetcher(loader, depth=2)
        metrics = run_eval(loader, model, args.list_of_metrics, [("fixed", "moving")],
                           args.list_of_augs, args.list_of_aligns, ea,
                           save_dir_prefix="register", mesh=mesh, device=device,
                           stage_times=stage_times)

    if mesh is None or mesh.is_main:
        print("\nFinal metrics:")
        for k, v in metrics.items():
            if v:
                print(f"  {k}: {np.mean([np.mean(x) for x in v]):.5f}")
    return metrics


if __name__ == "__main__":
    main()
