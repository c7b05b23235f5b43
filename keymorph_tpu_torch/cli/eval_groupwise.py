"""Groupwise and longitudinal registration evaluation harness. Port of
``keymorph_tpu/cli/eval_groupwise.py``.

Streams subjects to a per-group directory as ``.npz`` (a group may not fit
in device memory), runs ``KeyMorph.groupwise_register`` on the directory,
warps each subject with its saved grid (the port's warp kernel on the
card) and computes streaming all-pairs metrics. Directory layout and metric
keys (``metric:name:aug:align:group_size``) are keymorph_tpu's.

The augmentation of each subject draws from a ``torch.Generator`` seeded
with ``rng_seed``: keymorph_tpu draws from ``jax.random``, so the two
packages agree on a zero-range augmentation (``rot0``) and not on a random
one.

With ``args.mesh`` (a ``keymorph_tpu_torch.parallel.Mesh``; every rank runs
the harness) the subjects' extraction and grids fan out over the mesh
(``KeyMorph.groupwise_register(mesh=...)``); rank 0 alone writes the
group's files, warps and scores, as keymorph_tpu's one controller does, and
holds the metrics (the other ranks' lists stay empty).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
import torch

from keymorph_tpu_torch import metrics as M
from keymorph_tpu_torch import resolve_device
from keymorph_tpu_torch import utils as U
from keymorph_tpu_torch.augment import random_affine_augment
from keymorph_tpu_torch.cli.script_utils import parse_test_aug, save_dict_as_json
from keymorph_tpu_torch.data.loader import ThreadPrefetcher
from keymorph_tpu_torch.ops.resample import align_img
from keymorph_tpu_torch.parallel.mesh import require_mesh


def _duplicate_files_to_N(directory, N=4):
    """Pad a group directory to at least N files by copying the first."""
    files = sorted(f for f in os.listdir(directory)
                   if os.path.isfile(os.path.join(directory, f)))
    if not files:
        return
    first = os.path.join(directory, files[0])
    while len(files) < N:
        new_path = os.path.join(directory, f"{files[0][:3]}_m_{len(files):03}.npz")
        shutil.copy(first, new_path)
        files.append(os.path.basename(new_path))


def _is_main(args) -> bool:
    """Does this process write and score (no mesh, or rank 0 of one)?"""
    mesh = getattr(args, "mesh", None)
    return mesh is None or require_mesh(mesh).is_main


def _save_group_subjects(loader, group_size, aug_params, seg_available, groupimg_m_dir,
                         groupseg_m_dir, rng_seed=0, device=None):
    """Stream up to ``group_size`` subjects: augment on ``device`` (None:
    the card), save image and affine (and the one-hot segmentation) as
    ``.npz``. The next subject's decode overlaps the current augmentation
    (background prefetch)."""
    device = resolve_device(device)
    if not isinstance(loader, ThreadPrefetcher):
        loader = ThreadPrefetcher(loader, depth=2)
    generator = torch.Generator(device=device).manual_seed(int(rng_seed))
    with torch.no_grad():
        for i, subject in enumerate(loader):
            if i == group_size:
                break
            img_m = torch.as_tensor(np.asarray(subject["img"], np.float32), device=device)
            if img_m.dim() == 4:
                img_m = img_m[None]
            aff_m = np.asarray(subject["affine"])
            if seg_available:
                seg_raw = torch.as_tensor(np.asarray(subject["seg"]).astype(np.int32),
                                          device=device)
                if seg_raw.dim() == 4:  # unbatched (1, D, H, W) from SingleDataset
                    seg_raw = seg_raw[None]
                seg_m = U.one_hot(seg_raw, int(seg_raw.max()) + 1)
            if aug_params is not None:
                if seg_available:
                    img_m, seg_m = random_affine_augment(generator, img_m, seg=seg_m,
                                                         max_random_params=aug_params)
                else:
                    img_m = random_affine_augment(generator, img_m,
                                                  max_random_params=aug_params)
            np.savez(os.path.join(groupimg_m_dir, f"img_m_{i:03}.npz"),
                     img=img_m.cpu().numpy(), aff=aff_m)
            if seg_available:
                np.savez(os.path.join(groupseg_m_dir, f"seg_m_{i:03}.npz"),
                         seg=seg_m.cpu().numpy(), aff=aff_m)


def _run_group_eval_dir(group_dir, registration_model, list_of_eval_metrics,
                        list_of_eval_kp_aligns, aug, args, duplicate_files=False):
    """Groupwise-register a directory; warp, save, and compute all-pairs
    metrics."""
    if getattr(args, "visualize", False):
        raise NotImplementedError("groupwise evaluation with visualize: the montage is not "
                                  "ported (ROADMAP A9: viz.py)")
    group_dir = Path(group_dir)
    seg_available = getattr(args, "seg_available", False)
    device = resolve_device(getattr(registration_model, "device", None))
    mesh = getattr(args, "mesh", None)
    main = _is_main(args)
    groupimg_m_dir = group_dir / "img_m"
    groupseg_m_dir = group_dir / "seg_m"
    registration_results_dir = group_dir / "registration_results"
    os.makedirs(registration_results_dir, exist_ok=True)
    groupimg_a_dir, groupseg_a_dir = {}, {}
    for align in list_of_eval_kp_aligns:
        groupimg_a_dir[align] = group_dir / f"img_a_{align}"
        groupseg_a_dir[align] = group_dir / f"seg_a_{align}"
        os.makedirs(groupimg_a_dir[align], exist_ok=True)
        os.makedirs(groupseg_a_dir[align], exist_ok=True)

    if duplicate_files and main:
        _duplicate_files_to_N(groupimg_m_dir, 4)
        if seg_available:
            _duplicate_files_to_N(groupseg_m_dir, 4)
    if mesh is not None:
        mesh.barrier()  # rank 0 has written the group's subjects

    groupimg_m_paths = sorted(str(groupimg_m_dir / f) for f in os.listdir(groupimg_m_dir))
    groupseg_m_paths = (sorted(str(groupseg_m_dir / f) for f in os.listdir(groupseg_m_dir))
                        if seg_available and groupseg_m_dir.is_dir() else [])

    registration_results = registration_model.groupwise_register(
        str(groupimg_m_dir),
        transform_type=list(list_of_eval_kp_aligns),
        device=None,
        save_results_to_disk=True,
        save_dir=str(registration_results_dir),
        num_iters=5,
        log_to_console=True,
        mesh=mesh,
    )
    if not main:
        return registration_results

    for align, res_dict in registration_results.items():
        # exact-prefix match: a bare startswith(align) would mix tps_1 with
        # tps_10 and tps_0 with tps_0.1
        grid_paths = sorted(str(registration_results_dir / f)
                            for f in os.listdir(registration_results_dir)
                            if f.startswith(f"{align}_grid_"))
        img_a_paths, seg_a_paths = [], []
        with torch.no_grad():
            for i, img_path in enumerate(groupimg_m_paths):
                img_m = torch.as_tensor(np.load(img_path)["img"], device=device)
                grid = torch.as_tensor(np.load(grid_paths[i]), device=device)
                img_a = align_img(grid, img_m)
                out_path = str(groupimg_a_dir[align] / f"img_a_{align}_{i:03}.npy")
                np.save(out_path, img_a.cpu().numpy())
                img_a_paths.append(out_path)
                if seg_available:
                    seg_m = torch.as_tensor(np.load(groupseg_m_paths[i])["seg"], device=device)
                    seg_a = align_img(grid, seg_m)
                    seg_path = str(groupseg_a_dir[align] / f"seg_a_{align}_{i:03}.npy")
                    np.save(seg_path, seg_a.cpu().numpy())
                    seg_a_paths.append(seg_path)

            metrics = {}
            img_metric_names, grid_metric_names = [], []
            for m in list_of_eval_metrics:
                if m == "mse":
                    metrics["mse"] = float(M.MSEPairwiseLoss(device)(img_a_paths))
                elif m in ("softdice", "harddice", "harddiceroi", "hausd"):
                    assert seg_available
                    img_metric_names.append(m)
                elif m in ("jdstd", "jdlessthan0"):
                    assert args.dim == 3
                    grid_metric_names.append(m)
                else:
                    raise ValueError(f'Invalid metric "{m}"')
            if img_metric_names:
                seg_metrics = M.MultipleAvgSegPairwiseMetric(device)(seg_a_paths,
                                                                     img_metric_names)
                for name in ("harddice", "softdice"):
                    if name in seg_metrics:
                        seg_metrics[name] = float(1 - seg_metrics[name])
                if "harddiceroi" in seg_metrics:
                    seg_metrics["harddiceroi"] = (
                        1 - np.asarray(seg_metrics["harddiceroi"])).tolist()
                metrics.update(seg_metrics)
            if grid_metric_names:
                metrics.update(M.MultipleAvgGridMetric(device)(grid_paths, grid_metric_names))

        res_dict["metrics"] = metrics
        save_dict_as_json(metrics, group_dir / f"metrics-{align}.json")

        if res_dict.get("grouppoints_m") is not None:
            np.save(group_dir / f"points_m-{aug}.npy",
                    res_dict["grouppoints_m"].detach().cpu().numpy())
            np.save(group_dir / f"points_a-{aug}-{align}.npy",
                    res_dict["grouppoints_a"].detach().cpu().numpy())
        print(f"-> {align} groupwise metrics:", metrics)
    return registration_results


def run_group_eval(group_loader, registration_model, list_of_eval_metrics, list_of_eval_names,
                   list_of_eval_augs, list_of_eval_kp_aligns, list_of_group_sizes, args,
                   save_dir_prefix="group_eval", duplicate_files=False):
    """Metric keys: ``metric:name:aug:align:group_size``."""
    test_metrics = {
        f"{m}:{n}:{a}:{k}:{g}": []
        for m in list_of_eval_metrics
        for a in list_of_eval_augs
        for k in list_of_eval_kp_aligns
        for n in list_of_eval_names
        for g in list_of_group_sizes
    }
    seg_available = getattr(args, "seg_available", False)
    device = getattr(registration_model, "device", None)

    for dataset_name in list_of_eval_names:
        for aug in list_of_eval_augs:
            for group_size in list_of_group_sizes:
                name_str = "-".join(str(dataset_name).split("/")[-2:])
                group_dir = (Path(args.model_eval_dir) / save_dir_prefix
                             / f"{name_str}_{aug}_{group_size}")
                groupimg_m_dir = group_dir / "img_m"
                groupseg_m_dir = group_dir / "seg_m"
                os.makedirs(groupimg_m_dir, exist_ok=True)
                os.makedirs(groupseg_m_dir, exist_ok=True)
                if _is_main(args):
                    _save_group_subjects(group_loader[dataset_name], group_size,
                                         parse_test_aug(aug), seg_available, str(groupimg_m_dir),
                                         str(groupseg_m_dir), device=device)
                results = _run_group_eval_dir(group_dir, registration_model,
                                              list_of_eval_metrics, list_of_eval_kp_aligns, aug,
                                              args, duplicate_files)
                for align, res in results.items():
                    for m in list_of_eval_metrics if _is_main(args) else ():
                        test_metrics[f"{m}:{dataset_name}:{aug}:{align}:{group_size}"].append(
                            res["metrics"][m])
    return test_metrics


def run_long_eval(group_loader, registration_model, list_of_eval_metrics, list_of_eval_names,
                  list_of_eval_augs, list_of_eval_kp_aligns, args, save_dir_prefix="long_eval",
                  duplicate_files=False):
    """Longitudinal variant: each loader item is one subject's time series,
    registered groupwise. Metric keys: ``metric:name:aug:align``."""
    test_metrics = {
        f"{m}:{n}:{a}:{k}": []
        for m in list_of_eval_metrics
        for a in list_of_eval_augs
        for k in list_of_eval_kp_aligns
        for n in list_of_eval_names
    }
    seg_available = getattr(args, "seg_available", False)
    device = getattr(registration_model, "device", None)

    for dataset_name in list_of_eval_names:
        for aug in list_of_eval_augs:
            aug_params = parse_test_aug(aug)
            for i, group in enumerate(group_loader[dataset_name]):
                if args.early_stop_eval_subjects and i == args.early_stop_eval_subjects:
                    break
                name_str = "-".join(str(dataset_name).split("/")[-2:])
                group_dir = Path(args.model_eval_dir) / save_dir_prefix / f"{name_str}_{aug}_{i}"
                groupimg_m_dir = group_dir / "img_m"
                groupseg_m_dir = group_dir / "seg_m"
                os.makedirs(groupimg_m_dir, exist_ok=True)
                os.makedirs(groupseg_m_dir, exist_ok=True)
                if _is_main(args):
                    _save_group_subjects(group, len(group), aug_params, seg_available,
                                         str(groupimg_m_dir), str(groupseg_m_dir), device=device)
                results = _run_group_eval_dir(group_dir, registration_model,
                                              list_of_eval_metrics, list_of_eval_kp_aligns, aug,
                                              args, duplicate_files)
                for align, res in results.items():
                    for m in list_of_eval_metrics if _is_main(args) else ():
                        test_metrics[f"{m}:{dataset_name}:{aug}:{align}"].append(
                            res["metrics"][m])
    return test_metrics
