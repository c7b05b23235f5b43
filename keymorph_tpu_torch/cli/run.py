"""The main CLI: train, pretrain and eval. Port of ``keymorph_tpu/cli/run.py``:
the same flags (every ``Config`` field, ``--no_<flag>`` for the booleans that
default to True), run directories, ``args.json``, checkpoints
(``checkpoints/epoch{N}_model``), ``train_log.jsonl`` and
``eval/summary_{unimodal,multimodal}.json``, plus ``--device``.

Usage (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.cli.run --run_mode train --num_keypoints 128 \\
        --loss_fn mse --transform_type affine --data_path data.csv \\
        --train_dataset csv
    python -m keymorph_tpu_torch.cli.run --run_mode pretrain --backbone truncatedunet \\
        --use_amp --data_path data.csv --train_dataset csv
    python -m keymorph_tpu_torch.cli.run --run_mode train --backbone truncatedunet \\
        --use_amp --load_path output/keymorph/checkpoints/epoch2000_model \\
        --load_weights_only --transform_type tps_loguniform --data_path data.csv

``--load_path`` takes a checkpoint directory of the port
(``training/checkpoint.py``); ``--resume_latest`` the newest one under
``<save_dir>/<job_name>/checkpoints``. With ``--load_weights_only`` only the
parameters come back (the pretrain -> train handoff: a fresh optimizer and
step count); with ``--resume``/``--resume_latest`` the run continues at the
checkpoint's epoch + 1. A pretraining checkpoint carries its reference
keypoints (``ref_points``), which a resumed pretraining reuses.

As in keymorph_tpu, the volumes are resized to ``--img_size`` when they are
loaded, whatever ``--train_same_resolution`` says, so through this CLI the
same-resolution step's own resize is the identity. ``--visualize`` renders
moving/fixed/aligned panels of one training batch (``<model_dir>/img/``) at
epochs 1, the last and every ``log_interval``-th, and refuses before any
work where matplotlib is not installed; ``--use_wandb`` logs each epoch's
stats to Weights & Biases, or to stdout alone where wandb is not installed.

``--run_mode eval`` on several GPUs, one process each (``torchrun
--nproc_per_node N -m keymorph_tpu_torch.cli.run --run_mode eval ...``),
fans the pairs out over the processes (``eval_pairwise.run_eval(mesh=...)``);
rank 0 alone writes ``args.json`` and the summaries. Training and
pretraining run in one process, as keymorph_tpu's CLI trains on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from keymorph_tpu_torch.training.config import Config


def parse_args(argv=None):
    """``argv`` -> (``Config``, the ``--device`` string or None)."""
    parser = argparse.ArgumentParser("keymorph_tpu_torch")
    defaults = Config()
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
            if default is True:  # True-default bools need an off switch
                parser.add_argument(f"--no_{f.name}", dest=f.name, action="store_false")
        elif f.name == "max_random_affine_augment_params":
            parser.add_argument(name, nargs=4, type=float, default=default)
        elif f.name == "img_size":
            parser.add_argument(name, nargs=3, type=int, default=default)
        elif f.name == "wandb_kwargs":
            parser.add_argument(name, nargs="*", default={})
        elif default is None:
            parser.add_argument(name, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)
    parser.add_argument("--device", type=str, default=None,
                        help='Device to run on (default: the CUDA card; "cpu" runs the '
                             "kernels' plain versions)")
    kw = vars(parser.parse_args(argv))
    device = kw.pop("device")
    if isinstance(kw.get("wandb_kwargs"), list):
        kw["wandb_kwargs"] = dict(kv.split("=", 1) for kv in kw["wandb_kwargs"])
    for key in ("max_random_affine_augment_params", "img_size"):
        kw[key] = tuple(kw[key])
    for key in ("max_train_keypoints", "max_train_seg_channels", "early_stop_eval_subjects",
                "num_devices", "num_tps_centers"):
        if kw.get(key) is not None and not isinstance(kw[key], int):
            kw[key] = int(kw[key])
    return Config(**kw), device


def get_data(config: Config):
    """The dataset and its (pretrain, train, test) loaders, every volume
    preprocessed to ``config.img_size``."""
    from keymorph_tpu_torch.cli.hyperparameters import EVAL_MULTI_NAMES, EVAL_UNI_NAMES
    from keymorph_tpu_torch.data import CSVDataset, IXIDataset, Preprocessor

    transform = Preprocessor(size=tuple(config.img_size))
    if config.train_dataset == "ixi":
        dataset = IXIDataset(config.data_path)
    elif config.train_dataset == "csv":
        dataset = CSVDataset(config.data_path)
    else:
        raise ValueError(f"Unknown dataset {config.train_dataset}")
    loaders = dataset.get_loaders(config.batch_size, config.num_workers, config.mix_modalities,
                                  transform, EVAL_UNI_NAMES + EVAL_MULTI_NAMES)
    return dataset, loaders


def _log_epoch(model_dir: Path, epoch: int, stats):
    with open(model_dir / "train_log.jsonl", "a") as fh:
        fh.write(json.dumps({"epoch": epoch, **{k: float(v) for k, v in stats.items()}}) + "\n")


def main(argv=None):
    config, device_arg = parse_args(argv)
    if config.debug_mode:
        config.steps_per_epoch = 3
        config.early_stop_eval_subjects = 1
    if config.visualize:
        from keymorph_tpu_torch.viz import require_matplotlib

        require_matplotlib()

    import torch

    import keymorph_tpu_torch
    from keymorph_tpu_torch.cli import script_utils as su
    from keymorph_tpu_torch.data import ThreadPrefetcher
    from keymorph_tpu_torch.training import checkpoint as ckpt
    from keymorph_tpu_torch.training.config import build_model
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer

    from keymorph_tpu_torch.parallel.mesh import launch_mesh, world_size

    if world_size() > 1 and config.run_mode != "eval":
        raise ValueError(f"--run_mode {config.run_mode} runs in one process (keymorph_tpu's "
                         "CLI trains on one device); launch several only for --run_mode eval")
    mesh = launch_mesh(device_arg)
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else keymorph_tpu_torch.resolve_device(device_arg)
    if device.type == "cuda":
        keymorph_tpu_torch.disable_tf32()

    model_dir = Path(config.model_dir)
    ckpt_dir = model_dir / "checkpoints"
    eval_dir = model_dir / "eval"
    for d in (model_dir, ckpt_dir, eval_dir):
        os.makedirs(d, exist_ok=True)
    if main_rank:
        config.save(str(model_dir / "args.json"))

    np.random.seed(config.seed)
    generator = torch.Generator(device=device).manual_seed(config.seed)

    dataset, (pretrain_loader, train_loader, test_loader) = get_data(config)
    seg_available = getattr(dataset, "seg_available", False)

    model = build_model(config, device=device)
    model.seed_rng(config.seed)
    su.summary(model)
    net = model.net
    state = TrainState.create(net, make_optimizer(config, net))
    start_epoch = 1
    ref_points = None

    load_path = config.load_path
    if config.resume_latest:
        load_path = ckpt.latest_epoch_checkpoint(str(ckpt_dir))
    if load_path:
        payload = ckpt.load_checkpoint(load_path)
        net.load_state_dict(payload["params"])
        if not config.load_weights_only:  # weights only: a fresh optimizer and step
            state.optimizer.load_state_dict(payload["opt_state"])
            state.step = int(payload["step"])
        if config.resume or config.resume_latest:
            start_epoch = int(payload["epoch"]) + 1
        if "ref_points" in payload:
            ref_points = payload["ref_points"].to(device)
        print(f"Loaded checkpoint {load_path} (epoch {int(payload['epoch'])})")

    wandb = su.initialize_wandb(config) if config.use_wandb else None
    epochs = config.epochs if not config.debug_mode else 2
    if config.run_mode == "train":
        from keymorph_tpu_torch.training.train import (
            make_kpconsistency_step,
            make_train_step,
            make_train_step_sameres,
            run_train,
        )

        make = make_train_step_sameres if config.train_same_resolution else make_train_step
        step_fn = make(net, config)
        kp_step_fn = modality_datasets = None
        if config.kpconsistency_coeff > 0:
            from keymorph_tpu_torch.data import Preprocessor
            from keymorph_tpu_torch.data.datasets import SingleDataset

            kp_step_fn = make_kpconsistency_step(net, config)
            subs = dataset.get_subjects(train=True)
            if isinstance(subs, dict):
                transform = Preprocessor(size=tuple(config.img_size))
                modality_datasets = {mod: SingleDataset(lst, transform)
                                     for mod, lst in subs.items()}
        # the next batch's NIfTI decode overlaps this step's device work
        train_loader = ThreadPrefetcher(train_loader, depth=2)
        for epoch in range(start_epoch, epochs + 1):
            state, stats, generator = run_train(
                train_loader, state, step_fn, config, epoch, generator, kp_step_fn=kp_step_fn,
                modality_datasets=modality_datasets, device=device)
            print(f"Epoch {epoch}/{epochs}:", stats)
            _log_epoch(model_dir, epoch, stats)
            if wandb:
                wandb.log(stats)
            if config.visualize and (epoch % config.log_interval == 0 or epoch in (1, epochs)):
                # moving/fixed/aligned panels of one training batch
                from keymorph_tpu_torch.viz import render_registration_panels

                b_f, b_m = next(iter(train_loader))
                seg_kw = {}
                if config.loss_fn == "dice":
                    seg_kw = {"seg_f": np.asarray(b_f["seg"]), "seg_m": np.asarray(b_m["seg"])}
                paths = render_registration_panels(
                    model, np.asarray(b_f["img"], np.float32), np.asarray(b_m["img"], np.float32),
                    config.transform_type, str(model_dir / "img"), f"epoch{epoch}",
                    dim=config.dim, **seg_kw)
                print("-> visualize:", ", ".join(paths))
            if epoch % config.log_interval == 0 or epoch == epochs:
                ckpt.save_checkpoint(str(ckpt_dir), epoch, state)
    elif config.run_mode == "pretrain":
        from keymorph_tpu_torch.training.pretrain import (
            make_pretrain_step,
            pick_reference_subject,
            reference_image,
            run_pretrain,
        )

        if ref_points is None:
            img, ref_points, aff = pick_reference_subject(pretrain_loader, config,
                                                          seed=config.seed, device=device)
        else:
            img, aff = reference_image(pretrain_loader, config, device)
        step_fn = make_pretrain_step(net, config)
        for epoch in range(start_epoch, epochs + 1):
            state, stats, generator = run_pretrain(img, ref_points, state, step_fn, config,
                                                   epoch, generator, aff=aff)
            print(f"Pretrain epoch {epoch}/{epochs}:", stats)
            _log_epoch(model_dir, epoch, stats)
            if wandb:
                wandb.log(stats)
            if epoch % config.log_interval == 0 or epoch == epochs:
                ckpt.save_checkpoint(str(ckpt_dir), epoch, state, ref_points=ref_points)
    elif config.run_mode == "eval":
        from keymorph_tpu_torch.cli import hyperparameters as hp
        from keymorph_tpu_torch.cli.eval_pairwise import run_eval

        model.eval()

        class EvalArgs:
            pass

        ea = EvalArgs()
        ea.model_eval_dir = eval_dir
        ea.visualize = config.visualize
        ea.early_stop_eval_subjects = config.early_stop_eval_subjects
        ea.skip_if_completed = config.skip_if_completed
        ea.save_eval_artifacts = config.save_eval_artifacts
        ea.seg_available = seg_available
        ea.dim = config.dim
        aligns = hp.EVAL_KP_ALIGNS if not config.debug_mode else ["affine"]
        metrics = hp.EVAL_METRICS if seg_available else ["mse", "jdstd", "jdlessthan0"]
        augs = hp.EVAL_AUGS if not config.debug_mode else ["rot0"]
        eval_loader = ThreadPrefetcher(test_loader, depth=2)
        for suite, names in (("unimodal", hp.EVAL_UNI_NAMES),
                             ("multimodal", hp.EVAL_MULTI_NAMES)):
            raw = run_eval(eval_loader, model, metrics, names, augs, aligns, ea,
                           save_dir_prefix=f"eval_{suite}", mesh=mesh, device=device)
            if main_rank:
                summary = {k: (float(np.mean([np.mean(x) for x in v])) if v else None)
                           for k, v in raw.items()}
                out_path = eval_dir / f"summary_{suite}.json"
                su.save_dict_as_json(summary, out_path)
                print("Eval summary written to", out_path)
    else:
        raise ValueError(f"Unknown run_mode {config.run_mode}")


if __name__ == "__main__":
    main()
