"""Small helpers shared by training, pretraining, evaluation and the CLI.
Port of ``keymorph_tpu/utils.py``."""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np
import torch


def str_or_float(x):
    """A float where ``x`` parses as one, else ``x`` itself."""
    try:
        return float(x)
    except ValueError:
        return x


def parse_test_mod(mod):
    """'T1_T2' (or a pair) -> ('T1', 'T2')."""
    if isinstance(mod, str):
        mod1, mod2 = mod.split("_")
    else:
        mod1, mod2 = mod
    return mod1, mod2


def aggregate_dicts(dicts):
    """Mean over a list of metric dicts, averaging over the union of keys."""
    result = defaultdict(list)
    for d in dicts:
        for k, v in d.items():
            result[k].append(float(v))
    return {k: sum(v) / len(v) for k, v in result.items()}


def one_hot(seg: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """(B, 1, *spatial) integer labels -> contiguous (B, C, *spatial) fp32
    one-hot on the labels' device (``num_classes`` defaults to max + 1).
    Written by a scatter, so no int64 one-hot is materialized on the way."""
    seg = torch.as_tensor(seg)
    if num_classes is None:
        num_classes = int(seg.max()) + 1
    idx = seg[:, :1].long()
    if bool((idx < 0).any() or (idx >= num_classes).any()):
        raise ValueError(f"one_hot: labels outside [0, {num_classes})")
    out = torch.zeros((seg.shape[0], num_classes, *seg.shape[2:]), dtype=torch.float32,
                      device=seg.device)
    return out.scatter_(1, idx, 1.0)


def one_hot_subsampled_pair(seg1, seg2, subsample_num: int = 14, seed=None, device=None):
    """One-hot both segmentations over a random subset of their SHARED
    labels (host-side: label sets depend on the data). A fresh subset is
    drawn per call unless ``seed`` pins one."""
    s1, s2 = np.asarray(seg1), np.asarray(seg2)
    shared = np.intersect1d(np.unique(s1), np.unique(s2))
    if len(shared) > subsample_num:
        selected = np.random.default_rng(seed).choice(shared, subsample_num, replace=False)
    else:
        selected = shared

    def apply(seg):
        out = np.zeros((seg.shape[0], len(selected), *seg.shape[2:]), np.float32)
        for i, val in enumerate(selected):
            out[:, i] = seg[:, 0] == val
        return torch.tensor(out, device=device)

    return apply(s1), apply(s2)


SYNTHSEG_REGION_PAIRS = (
    (0, 24),   # Background and CSF
    (13, 52),  # Pallidum
    (18, 54),  # Amygdala
    (11, 50),  # Caudate
    (3, 42),   # Cerebral Cortex
    (17, 53),  # Hippocampus
    (10, 49),  # Thalamus
    (12, 51),  # Putamen
    (2, 41),   # Cerebral WM
    (8, 47),   # Cerebellum Cortex
    (4, 43),   # Lateral Ventricle
    (7, 46),   # Cerebellum WM
    (16, 16),  # Brain-Stem
)


def one_hot_eval_synthseg(asegs) -> torch.Tensor:
    """14-region one-hot of a (B, 1, *spatial) SynthSeg label volume: the
    left/right pairs of :data:`SYNTHSEG_REGION_PAIRS` merged, plus a last
    channel for everything outside them."""
    asegs = torch.as_tensor(asegs)
    chans = [((asegs[:, 0] == a) | (asegs[:, 0] == b)).float()
             for a, b in SYNTHSEG_REGION_PAIRS]
    oh = torch.stack(chans, dim=1)
    return torch.cat([oh, 1.0 - oh.sum(dim=1, keepdim=True)], dim=1)


def _percentile(flat_sorted: torch.Tensor, p: float) -> torch.Tensor:
    """``numpy.percentile``'s linear interpolation on sorted values (no size
    limit, unlike ``torch.quantile``)."""
    pos = p / 100.0 * (flat_sorted.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, flat_sorted.numel() - 1)
    return flat_sorted[lo] + (flat_sorted[hi] - flat_sorted[lo]) * (pos - lo)


def rescale_intensity(array, out_range=(0, 1), percentiles=(0, 100)) -> torch.Tensor:
    """Percentile clip, then min-max rescale to ``out_range``, in fp32 on the
    input's device (a constant input maps to ``out_range[0]``)."""
    x = torch.as_tensor(array).float()
    if tuple(percentiles) != (0, 100):
        lo, hi = (_percentile(torch.sort(x.reshape(-1)).values, p) for p in percentiles)
        x = torch.clamp(x, lo, hi)
    in_min = x.min()
    in_range = x.max() - in_min
    scale = (out_range[1] - out_range[0]) / torch.where(in_range == 0, 1.0, in_range)
    return (x - in_min) * scale + out_range[0]


def sample_valid_coordinates(x, num_points: int, dim: int, point_space: str = "norm",
                             indexing: str = "xy", seed: int = 0) -> torch.Tensor:
    """``num_points`` voxels drawn uniformly, with replacement, from the
    support of ``x`` (values above 0.1 in 3D, above 0 in 2D; x is
    (1, 1, *spatial)) by ``numpy.random.default_rng(seed)``, so the same seed
    picks keymorph_tpu's voxels. Returns (1, num_points, dim) fp32 on the
    CPU: in [0, 1] (the voxel index over the axis size, ``"norm"``) or in
    voxels (``"voxel"``), ``xy`` (last volume axis first, the reference's
    order) or ``ij``."""
    x = np.asarray(x)
    eps = 0 if dim == 2 else 1e-1
    idx = np.argwhere(x[0, 0] > eps)  # (M, dim) valid voxels
    if len(idx) == 0:
        raise ValueError("mask has no valid voxels")
    rng = np.random.default_rng(seed)
    sel = idx[rng.integers(0, len(idx), size=num_points)]
    coords = sel[:, ::-1].astype(np.float64)
    if point_space == "norm":
        coords = coords / np.asarray(x.shape[2:][::-1])
    pts = coords.reshape(1, num_points, dim)
    if indexing == "ij":
        pts = pts[..., ::-1]
    return torch.tensor(np.ascontiguousarray(pts), dtype=torch.float32)
