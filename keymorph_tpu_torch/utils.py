"""Small helpers shared by training and tools. Port of the parts of
``keymorph_tpu/utils.py`` the training loop uses."""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def aggregate_dicts(dicts):
    """Mean over a list of metric dicts, averaging over the union of keys."""
    result = defaultdict(list)
    for d in dicts:
        for k, v in d.items():
            result[k].append(float(v))
    return {k: sum(v) / len(v) for k, v in result.items()}


def one_hot(seg: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """(B, 1, *spatial) integer labels -> (B, C, *spatial) float one-hot
    (``num_classes`` defaults to max + 1)."""
    seg = torch.as_tensor(seg)
    if num_classes is None:
        num_classes = int(seg.max()) + 1
    return F.one_hot(seg[:, 0].long(), num_classes).movedim(-1, 1).float()


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
