"""Pairwise registration evaluation harness. Port of
``keymorph_tpu/cli/eval_pairwise.py``.

Sweeps subjects x augmentations x transform types with one keypoint
extraction per pair (all aligns share it), computes the metric suite and
saves JSON metrics and ``.npy`` artifacts with keymorph_tpu's layout and
key scheme ``metric:mod1:mod2:aug:align``.

On the card the moving image and its one-hot segmentation are augmented and
warped by the port's warp kernel (``augment.affine_augment`` and
:func:`make_batch_score_fn`, through ``ops/resample.py:align_img``); the
extraction and the grids are ``KeyMorph``'s. Metrics are PyTorch on the
card, except the Hausdorff distance (host scipy on the uint8 channel-0
masks). Each align's warped one-hot segmentation is reduced to its labels
and freed before the next align is warped.

Pairs may be batched (``batch_pairs``). With a ``mesh``
(``keymorph_tpu_torch.parallel``, one process per GPU) the pairs fan out
over its data-parallel axes as in keymorph_tpu: each rank registers, scores
and saves its own pairs under the sequential run's file names, and the
metrics are gathered to every rank in the sequential order.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from keymorph_tpu_torch import metrics as M
from keymorph_tpu_torch import resolve_device
from keymorph_tpu_torch import utils as U
from keymorph_tpu_torch.augment import affine_augment
from keymorph_tpu_torch.cli.script_utils import (
    load_dict_from_json,
    parse_test_aug,
    save_dict_as_json,
)
from keymorph_tpu_torch.ops.resample import align_img


def _build_metric_dict(list_of_eval_metrics, list_of_eval_augs, list_of_eval_aligns, names):
    keys = [
        f"{m}:{n1}:{n2}:{a}:{k}"
        for m in list_of_eval_metrics
        for a in list_of_eval_augs
        for k in list_of_eval_aligns
        for (n1, n2) in names
    ]
    return {k: [] for k in keys}


def _metrics_for_pair(list_of_eval_metrics, args, seg_available, img_f, img_a, seg_f, seg_a,
                      grid):
    """Metric suite for ONE pair (batch-1 tensors), one metric at a time:
    the sequential counterpart of :func:`make_batch_score_fn`."""
    if seg_available:
        dice_total = 1.0 - float(M.DiceLoss(hard=True)(seg_a, seg_f, ign_first_ch=True))
        dice_roi = (1.0 - M.DiceLoss(hard=True, return_regions=True)(
            seg_a, seg_f, ign_first_ch=True)).cpu().numpy().tolist()

    metrics = {}
    for m in list_of_eval_metrics:
        if m == "mse":
            metrics["mse"] = float(M.MSELoss()(img_f, img_a))
        elif m == "softdice":
            assert seg_available
            metrics["softdiceloss"] = float(M.DiceLoss()(seg_a, seg_f))
            metrics["softdice"] = 1 - metrics["softdiceloss"]
        elif m == "harddice":
            assert seg_available
            metrics["harddice"] = dice_total
        elif m == "harddiceroi":
            assert seg_available
            metrics["harddiceroi"] = dice_roi
        elif m == "hausd":
            assert seg_available and args.dim == 3
            metrics["hausd"] = float(M.hausdorff_distance(seg_a, seg_f))
        elif m == "jdstd":
            assert args.dim == 3
            metrics["jdstd"] = M.jdstd(torch.movedim(torch.as_tensor(grid), -1, 1))
        elif m == "jdlessthan0":
            assert args.dim == 3
            metrics["jdlessthan0"] = M.jdlessthan0(torch.movedim(torch.as_tensor(grid), -1, 1),
                                                   as_percentage=True)
        else:
            raise ValueError(f'Invalid metric "{m}"')
    return metrics


def _per_pair_dice(pred, target, hard, ch_mask, ign_first_ch, dtype=torch.float32):
    """Per-pair (masked) Dice-loss reductions of ``losses._dice`` (eps 1).

    ``ch_mask`` (B, C) is 1 where channel c is below the pair's own class
    count: pairs in a batch may carry label sets one-hotted to a common
    ceiling, and the padded channels must not enter the per-channel mean
    (each would add a perfect eps/eps Dice). The hard prediction's one-hot
    is formed as a boolean mask (a quarter of an fp32 one-hot's bytes): its
    products with the target are the target where the mask holds, its
    squares the mask's counts, each an exact sum of counts. ``dtype`` is
    the sums' type (fp32 as keymorph_tpu; float64 for a reference).

    Returns (per-pair mean (B,), per-pair-per-region (B, C or C - 1)).
    """
    B, C = pred.shape[:2]
    p = pred.reshape(B, C, -1)
    t = target.reshape(B, C, -1).to(dtype)
    if hard:
        am = torch.argmax(p, dim=1)  # (B, N), the first maximum
        hit = am[:, None, :] == torch.arange(C, device=p.device)[None, :, None]
        inter = torch.sum(t * hit, dim=2)
        psq = torch.sum(hit, dim=2, dtype=dtype)
        del hit
    else:
        p = p.to(dtype)
        inter = torch.sum(p * t, dim=2)
        psq = torch.sum(p * p, dim=2)
    num = 2.0 * inter + 1.0
    den = psq + torch.sum(t * t, dim=2) + 1.0
    dl = 1.0 - num / den  # (B, C)
    m = ch_mask.to(dtype)
    if ign_first_ch:
        dl, m = dl[:, 1:], m[:, 1:]
    mean = torch.sum(dl * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return mean, dl


def make_batch_score_fn(list_of_eval_aligns, list_of_eval_metrics, seg_available, dim, warp,
                        return_volumes):
    """Warp and score a registered batch for every align.

    ``warp`` is ``align_img`` (the port's warp kernel on the card). The
    returned ``fn(grids, img_f, img_m, seg_f, seg_m, ch_mask)`` gives
    ``(metrics, ch0_f, volumes)``: per align a dict of per-pair tensors
    (``mse``, ``softdiceloss``, ``harddice``, ``harddiceroi`` (B, C - 1),
    ``ch0_a`` uint8 channel-0 masks for the host Hausdorff, ``jdstd``,
    ``jdlessthan0``, as asked), the fixed segmentation's uint8 channel-0
    mask, and with ``return_volumes`` per align (warped image, labels of
    the warped segmentation: its argmax, int16). The warped one-hot itself
    is freed once its align is scored. Pass ``seg_f = seg_m = ch_mask =
    None`` when ``seg_available`` is False. Metric values equal what
    :func:`_metrics_for_pair` computes pair by pair.
    """
    need = frozenset(list_of_eval_metrics)
    aligns = tuple(list_of_eval_aligns)

    def score(grids, img_f, img_m, seg_f, seg_m, ch_mask):
        out, vols = {}, {}
        spatial_axes = tuple(range(1, dim + 1))
        ch0_f = ((seg_f[:, 0] > 0.5).to(torch.uint8)
                 if seg_available and "hausd" in need else None)
        for align, g in zip(aligns, grids):
            img_a = warp(g, img_m)
            seg_a = warp(g, seg_m) if seg_available else None
            e = {}
            if "mse" in need:
                e["mse"] = torch.mean((img_f.float() - img_a.float()) ** 2,
                                      dim=tuple(range(1, img_f.dim())))
            if "softdice" in need:
                e["softdiceloss"], _ = _per_pair_dice(seg_a, seg_f, False, ch_mask,
                                                      ign_first_ch=False)
            if "harddice" in need or "harddiceroi" in need:
                hd_mean, hd_regions = _per_pair_dice(seg_a, seg_f, True, ch_mask,
                                                     ign_first_ch=True)
                if "harddice" in need:
                    e["harddice"] = 1.0 - hd_mean
                if "harddiceroi" in need:
                    e["harddiceroi"] = 1.0 - hd_regions
            if "hausd" in need:
                e["ch0_a"] = (seg_a[:, 0] > 0.5).to(torch.uint8)
            if "jdstd" in need or "jdlessthan0" in need:
                det = M.jacobian_determinant(torch.movedim(g, -1, 1))
                if "jdstd" in need:
                    e["jdstd"] = torch.std(det, dim=spatial_axes, correction=0)
                if "jdlessthan0" in need:
                    e["jdlessthan0"] = torch.mean((det <= 0).float(), dim=spatial_axes)
                del det
            out[align] = e
            if return_volumes:
                labels = torch.argmax(seg_a, dim=1).to(torch.int16) if seg_available else None
                vols[align] = (img_a, labels)
            del seg_a
        return out, ch0_f, vols

    return score


def _tensor(x, device, dtype=None):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device=device, dtype=dtype, non_blocking=True)


def _host(t):
    return None if t is None else (t.detach().cpu().numpy() if torch.is_tensor(t)
                                   else np.asarray(t))


class _Stages:
    """Wall seconds per stage of a run, summed into ``times`` (a dict, or
    None for no timing). Device stages synchronize the card first."""

    def __init__(self, times, device):
        self.times, self.device = times, device

    def sync(self):
        if self.times is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add(self, name, seconds):
        if self.times is not None:
            self.times[name] = self.times.get(name, 0.0) + seconds


def run_eval(loader, registration_model, list_of_eval_metrics, list_of_eval_names,
             list_of_eval_augs, list_of_eval_aligns, args, save_dir_prefix="eval", mesh=None,
             batch_pairs=None, device=None, stage_times=None):
    """Returns the test_metrics dict keyed ``metric:mod1:mod2:aug:align``.

    ``device``: where the pairs are registered and scored (None: the
    registration model's ``device``, else the card). ``mesh``: a
    ``keymorph_tpu_torch.parallel.Mesh`` over which every rank calls this
    with the same loader and model; ``batch_pairs`` then defaults to its
    data-parallel size and must be a multiple of it, each rank registers
    its rows of each batch and writes their artifacts and metric JSONs
    (ranks off the first 'space' index write nothing), and every rank
    returns the whole metrics dict. ``stage_times``: a dict
    that receives wall seconds per stage ("prep" one-hot and augmentation,
    "extract", "align", "warp_score", "hausdorff", "artifacts"), for a caller
    that profiles the run; the device stages then synchronize the card.
    """
    if mesh is not None:
        from keymorph_tpu_torch.parallel import mesh as pmesh

        mesh = pmesh.require_mesh(mesh)
    if getattr(args, "visualize", False):
        raise NotImplementedError("run_eval with visualize: the panels are not ported "
                                  "(ROADMAP A9: viz.py)")
    jd = sorted({"jdstd", "jdlessthan0"} & set(list_of_eval_metrics))
    if jd and args.dim != 3:
        # keymorph_tpu's scorer reduces the 3D determinant over `dim` axes and
        # fails to make a number of what is left
        raise ValueError(f"{jd}: the Jacobian-determinant metrics need --dim 3, got {args.dim}")
    test_metrics = _build_metric_dict(list_of_eval_metrics, list_of_eval_augs,
                                      list_of_eval_aligns, list_of_eval_names)
    seg_available = getattr(args, "seg_available", False)
    device = resolve_device(device if device is not None
                            else getattr(registration_model, "device", None))
    batch_pairs = batch_pairs or (mesh.data_size if mesh is not None else 1)
    if mesh is not None and batch_pairs % mesh.data_size:
        raise ValueError(f"batch_pairs={batch_pairs} must be a multiple of the mesh's "
                         f"data-parallel size ({mesh.data_size})")
    writes = mesh is None or mesh.space_index == 0
    stages = _Stages(stage_times, device)
    need_vols = getattr(args, "save_eval_artifacts", True)
    score_fn = make_batch_score_fn(list_of_eval_aligns, list_of_eval_metrics, seg_available,
                                   args.dim, align_img, need_vols)

    def _flush(pending):
        """Register and score a buffer of pending pairs for every aug."""
        for aug in list_of_eval_augs:
            param = parse_test_aug(aug)
            done = [bool(args.skip_if_completed) and all(
                p.exists() for p in entry["metrics_paths"][aug].values()) for entry in pending]
            if mesh is not None:
                # every rank looks before any writes this aug's files: the
                # collective orders the looks before the writes, and makes
                # every rank take the same pairs
                agreed = torch.tensor(done, dtype=torch.int32, device=mesh.device)
                done = (pmesh.all_reduce(agreed, mesh.world_group) == mesh.size).tolist()
            work = []
            for entry, skip in zip(pending, done):
                if skip:
                    print("Found metrics for all alignments, skipping registration...")
                    _record(entry, aug, {k: load_dict_from_json(v)
                                         for k, v in entry["metrics_paths"][aug].items()})
                else:
                    work.append(entry)
            if not work:
                continue

            n_work = len(work)
            batch = work + [work[-1]] * (batch_pairs - n_work)
            rows = (pmesh.local_rows(mesh, batch_pairs) if mesh is not None
                    else slice(0, batch_pairs))
            batch = batch[rows]
            mine = list(range(rows.start, min(rows.stop, n_work)))  # this rank's pairs
            stages.sync()
            t0 = time.perf_counter()
            img_f = _tensor(np.concatenate([e["img_f"] for e in batch]), device)
            img_m = _tensor(np.concatenate([e["img_m"] for e in batch]), device)
            aff_f = _tensor(np.concatenate([e["aff_f"] for e in batch]), device)
            aff_m = _tensor(np.concatenate([e["aff_m"] for e in batch]), device)
            seg_f = seg_m = ch_mask = None
            n_max = 0
            if seg_available:
                # one-hot to the batch's ceiling: the per-pair channel masks
                # recover each pair's own label set (the extra channels stay
                # zero through the linear warp)
                n_cls_list = [e["n_cls"] for e in batch]
                n_max = max(n_cls_list)
                seg_f = U.one_hot(_tensor(np.concatenate([e["seg_f"] for e in batch]),
                                          device, torch.int32), n_max)
                seg_m = U.one_hot(_tensor(np.concatenate([e["seg_m"] for e in batch]),
                                          device, torch.int32), n_max)
                img_m, seg_m = affine_augment(img_m, param, seg=seg_m)
                cm = np.zeros((len(batch), n_max), np.float32)
                for b, nc in enumerate(n_cls_list):
                    cm[b, :nc] = 1.0
                ch_mask = _tensor(cm, device)
            else:
                img_m = affine_augment(img_m, param)
            stages.sync()
            stages.add("prep", time.perf_counter() - t0)

            t0 = time.perf_counter()
            results = registration_model(img_f, img_m, transform_type=list(list_of_eval_aligns),
                                         return_aligned_points=True, aff_f=aff_f, aff_m=aff_m)
            first = results[list_of_eval_aligns[0]]
            if "time_keypoint_extract" in first:
                stages.add("extract", float(first["time_keypoint_extract"]))
                stages.add("align", sum(float(r["time_align"]) for r in results.values()))
            grids = tuple(_tensor(results[a]["grid"], device) for a in list_of_eval_aligns)
            t1 = time.perf_counter()
            scored, ch0_f, vols = score_fn(grids, img_f, img_m, seg_f, seg_m, ch_mask)
            scored = {a: {k: _host(v) for k, v in e.items()} for a, e in scored.items()}
            ch0_f = _host(ch0_f)
            stages.sync()
            stages.add("warp_score", time.perf_counter() - t1)
            batch_time = time.perf_counter() - t0

            gathered = []
            for j, w in enumerate(mine):
                entry = work[w]
                sl = slice(j, j + 1)
                n_cls_j = entry["n_cls"] if seg_available else 0
                if need_vols and writes:
                    t1 = time.perf_counter()
                    _save_pair_common(
                        entry, aug, img_f[sl], img_m[sl],
                        torch.argmax(seg_f[sl, :n_cls_j], dim=1) if seg_available else None,
                        torch.argmax(seg_m[sl, :n_cls_j], dim=1) if seg_available else None)
                    stages.add("artifacts", time.perf_counter() - t1)

                all_metrics = {}
                for align, res in results.items():
                    e = scored[align]
                    metrics = {}
                    for m in list_of_eval_metrics:
                        if m == "mse":
                            metrics["mse"] = float(e["mse"][j])
                        elif m == "softdice":
                            sdl = float(e["softdiceloss"][j])
                            metrics["softdiceloss"] = sdl
                            metrics["softdice"] = 1 - sdl
                        elif m == "harddice":
                            metrics["harddice"] = float(e["harddice"][j])
                        elif m == "harddiceroi":
                            metrics["harddiceroi"] = np.asarray(
                                e["harddiceroi"][j][: n_cls_j - 1]).tolist()
                        elif m == "hausd":
                            t1 = time.perf_counter()
                            metrics["hausd"] = float(M.hausdorff_from_ch0_masks(
                                e["ch0_a"][j: j + 1], ch0_f[j: j + 1]))
                            stages.add("hausdorff", time.perf_counter() - t1)
                        elif m == "jdstd":
                            metrics["jdstd"] = float(e["jdstd"][j])
                        elif m == "jdlessthan0":
                            metrics["jdlessthan0"] = float(e["jdlessthan0"][j])
                        else:
                            raise ValueError(f'Invalid metric "{m}"')
                    all_metrics[align] = metrics
                    print(f"-> {align}: align_time={float(res.get('time', float('nan'))):.3f}s "
                          f"batch_time={batch_time:.3f}s/{n_work}pairs", metrics)
                    t1 = time.perf_counter()
                    if writes:
                        save_dict_as_json(metrics, entry["metrics_paths"][aug][align])
                    if need_vols and writes:
                        img_a, labels_a = vols[align]
                        _save_pair_align(entry, aug, align, res, sl, res["grid"][sl], img_a[sl],
                                         labels_a[sl] if seg_available else None)
                    stages.add("artifacts", time.perf_counter() - t1)
                gathered.append([w, all_metrics])
            if mesh is not None:  # each rank's pairs, in rank order: the sequential order
                gathered = [g for part in pmesh.gather_json(gathered, mesh.data_group,
                                                            mesh.device) for g in part]
            for w, all_metrics in gathered:
                _record(work[w], aug, all_metrics)
            del results, grids, vols, img_f, img_m, seg_f, seg_m

    def _record(entry, aug, all_metrics):
        mod1, mod2 = entry["mod1"], entry["mod2"]
        for m in list_of_eval_metrics:
            for align in list_of_eval_aligns:
                test_metrics[f"{m}:{mod1}:{mod2}:{aug}:{align}"].append(all_metrics[align][m])

    def _save_pair_common(entry, aug, img_f, img_m, labels_f, labels_m):
        i, mod1_str, mod2_str = entry["i"], entry["mod1_str"], entry["mod2_str"]
        save_dir = entry["save_dir"]
        np.save(save_dir / f"img_f_{i}-{mod1_str}.npy", _host(img_f[0]))
        np.save(save_dir / f"img_m_{i}-{mod2_str}-{aug}.npy", _host(img_m[0]))
        if labels_f is not None:
            np.save(save_dir / f"seg_f_{i}-{mod1_str}.npy", _host(labels_f).astype(np.int64))
            np.save(save_dir / f"seg_m_{i}-{mod2_str}-{aug}.npy",
                    _host(labels_m).astype(np.int64))

    def _save_pair_align(entry, aug, align, res, sl, grid_j, img_a_j, labels_a_j):
        i, mod1_str, mod2_str = entry["i"], entry["mod1_str"], entry["mod2_str"]
        save_dir = entry["save_dir"]
        np.save(save_dir / f"img_a_{i}-{mod1_str}-{mod2_str}-{aug}-{align}.npy",
                _host(img_a_j[0]))
        np.save(save_dir / f"grid_{i}-{mod1_str}-{mod2_str}-{aug}-{align}.npy",
                _host(grid_j[0]))
        if labels_a_j is not None:
            np.save(save_dir / f"seg_a_{i}-{mod1_str}-{mod2_str}-{aug}-{align}.npy",
                    _host(labels_a_j).astype(np.int64))
        if res.get("points_f") is not None:
            np.save(save_dir / f"points_f_{i}-{mod1_str}.npy", _host(res["points_f"][sl][0]))
            np.save(save_dir / f"points_m_{i}-{mod2_str}-{aug}.npy",
                    _host(res["points_m"][sl][0]))
            np.save(save_dir / f"points_a_{i}-{mod1_str}-{mod2_str}-{aug}-{align}.npy",
                    _host(res["points_a"][sl][0]))
            if res.get("points_weights") is not None:
                np.save(save_dir / f"points_weights_{i}-{mod1_str}-{mod2_str}-{aug}-{align}.npy",
                        _host(res["points_weights"][sl][0]))

    wanted_pairs = {(str(n1), str(n2)) for n1, n2 in list_of_eval_names}
    pending = []
    with torch.no_grad():
        for i, (fixed, moving) in enumerate(loader):
            if args.early_stop_eval_subjects and i == args.early_stop_eval_subjects:
                break
            mod1 = fixed["modality"][0]
            mod2 = moving["modality"][0]
            if (str(mod1), str(mod2)) not in wanted_pairs:
                continue  # the loader may carry pairs of another suite
            mod1_str = "-".join(str(mod1).split("/")[-2:])
            mod2_str = "-".join(str(mod2).split("/")[-2:])
            save_dir = Path(args.model_eval_dir) / save_dir_prefix / f"{i}_{mod1_str}_{mod2_str}"
            os.makedirs(save_dir, exist_ok=True)
            entry = {
                "i": i, "mod1": mod1, "mod2": mod2, "mod1_str": mod1_str,
                "mod2_str": mod2_str, "save_dir": save_dir,
                "img_f": np.asarray(fixed["img"], np.float32),
                "img_m": np.asarray(moving["img"], np.float32),
                "aff_f": np.asarray(fixed["affine"], np.float32),
                "aff_m": np.asarray(moving["affine"], np.float32),
                "metrics_paths": {
                    aug: {align: save_dir / f"metrics-{aug}-{align}.json"
                          for align in list_of_eval_aligns}
                    for aug in list_of_eval_augs
                },
            }
            if seg_available:
                entry["seg_f"] = np.asarray(fixed["seg"])
                entry["seg_m"] = np.asarray(moving["seg"])
                entry["n_cls"] = int(max(entry["seg_f"].max(), entry["seg_m"].max())) + 1
            pending.append(entry)
            if len(pending) == batch_pairs:
                _flush(pending)
                pending = []
        if pending:
            _flush(pending)
    return test_metrics
