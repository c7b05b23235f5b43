"""Evaluation metrics. Port of ``keymorph_tpu/metrics.py``.

Dice over label maps and the Hausdorff distance are host numpy/scipy, as in
keymorph_tpu (copies); the Jacobian-determinant statistics are PyTorch in
fp32 on the tensors' device (the card in the register CLI). The aggregate
classes average over pairs of volumes or over sampling grids, given as
arrays or as ``.npy`` / NIfTI paths.

The Hausdorff distance is taken on channel 0 thresholded at ``> 0.5``, as
keymorph_tpu does (the original torch code casts it to bool).

LC2 and ImageLC2, the multimodal similarity, are PyTorch on the tensors'
device: a 3-tap gradient filter, a 3x3 normal system a sample solved by
``solve_ex``, in fp32 as keymorph_tpu computes them (float64 on request,
the oracle the card's result is held against).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from keymorph_tpu_torch.losses import DiceLoss, MSELoss, mse_loss  # noqa: F401


def _to_numpy(t):
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Dice (label-map variant)
# ---------------------------------------------------------------------------


def fast_dice(x, y):
    """Mean Dice over the union of labels, all labels in one pass: the
    per-label intersections and sizes come from one L x L confusion matrix
    (``bincount`` over rank-coded label pairs), with 1e-5 smoothing.

    Args:
        x, y: (B, C, *spatial) one-hot or probability maps (argmaxed here).
    """
    x = _to_numpy(x).argmax(1)
    y = _to_numpy(y).argmax(1)
    assert x.shape == y.shape
    labels = np.union1d(x, y)
    if len(labels) == 1:
        return np.mean(dice(x == labels[0], y == labels[0]))
    ix = np.searchsorted(labels, x.ravel())
    iy = np.searchsorted(labels, y.ravel())
    L = len(labels)
    conf = np.bincount(ix * L + iy, minlength=L * L).reshape(L, L).astype(np.float64)
    inter = np.diag(conf)
    dice_score = 2 * inter / (conf.sum(0) + conf.sum(1) + 1e-5)
    return np.mean(dice_score)


def dice(x, y):
    """Dice of two binary numpy arrays."""
    return 2 * np.sum(x * y) / (np.sum(x) + np.sum(y))


# ---------------------------------------------------------------------------
# Hausdorff distance (host numpy/scipy)
# ---------------------------------------------------------------------------


# Above this many surface voxels the full-volume EDT beats per-point
# nearest-neighbour queries.
_HAUSD_KDTREE_MAX_SURFACE = 400_000


def _surface(mask, connectivity=1):
    """Boundary voxels of a binary mask (the mask XOR its erosion)."""
    conn = scipy.ndimage.generate_binary_structure(mask.ndim, connectivity)
    return mask ^ scipy.ndimage.binary_erosion(mask, conn)


def _surface_distances(input1, input2, sampling=1, connectivity=1):
    """Symmetric surface-distance samples: for each surface voxel of one
    mask, the distance (in ``sampling`` units) to the other's surface.

    The distances are nearest-neighbour queries on a KD-tree of the other
    surface's scaled coordinates, which equal the EDT of the other surface's
    complement at those voxels; degenerate or huge surfaces take the EDT.
    """
    input_1 = np.atleast_1d(np.asarray(input1).astype(bool))
    input_2 = np.atleast_1d(np.asarray(input2).astype(bool))
    S = _surface(input_1, connectivity)
    Sprime = _surface(input_2, connectivity)
    sampling = np.atleast_1d(np.asarray(sampling, np.float64))
    if sampling.size == 1:
        sampling = np.full(input_1.ndim, sampling[0])

    pts_a = np.argwhere(S)
    pts_b = np.argwhere(Sprime)
    if (0 < len(pts_a) <= _HAUSD_KDTREE_MAX_SURFACE
            and 0 < len(pts_b) <= _HAUSD_KDTREE_MAX_SURFACE):
        from scipy.spatial import cKDTree

        # sliding-midpoint splits: a balanced build is slow on grid points
        def _tree(p):
            return cKDTree(p, balanced_tree=False, compact_nodes=False)

        ta = _tree(pts_a * sampling)
        tb = _tree(pts_b * sampling)
        d_b_to_a, _ = ta.query(pts_b * sampling, k=1)
        d_a_to_b, _ = tb.query(pts_a * sampling, k=1)
        return np.concatenate([np.ravel(d_b_to_a), np.ravel(d_a_to_b)])

    dta = scipy.ndimage.distance_transform_edt(~S, sampling)
    dtb = scipy.ndimage.distance_transform_edt(~Sprime, sampling)
    return np.concatenate([np.ravel(dta[Sprime != 0]), np.ravel(dtb[S != 0])])


def ch0_mask(seg) -> np.ndarray:
    """(B, C, *spatial) one-hot -> host (B, *spatial) bool of channel 0 at
    ``> 0.5``. A tensor is thresholded on its device and only the uint8
    mask crosses to the host."""
    if torch.is_tensor(seg):
        return (seg[:, 0] > 0.5).to(torch.uint8).cpu().numpy() > 0
    return np.asarray(seg)[:, 0] > 0.5


def hausdorff_distance(test_seg, gt_seg, sampling=(1.25, 1.25, 10)):
    """Max surface distance on channel 0 (``> 0.5``), averaged over the
    batch, with anisotropic ``sampling``."""
    return hausdorff_from_ch0_masks(ch0_mask(test_seg), ch0_mask(gt_seg), sampling)


def hausdorff_from_ch0_masks(test_mask, gt_mask, sampling=(1.25, 1.25, 10)):
    """:func:`hausdorff_distance` from the (B, *spatial) channel-0 masks."""
    test_mask = np.asarray(test_mask) > 0
    gt_mask = np.asarray(gt_mask) > 0
    hd = 0.0
    for i in range(len(test_mask)):
        hd += _surface_distances(test_mask[i], gt_mask[i], list(sampling), 1).max()
    return hd / len(test_mask)


# ---------------------------------------------------------------------------
# Jacobian determinant (PyTorch on the tensor's device)
# ---------------------------------------------------------------------------


def _central_diff(x: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5 * (x[i+1] - x[i-1]) with zeros beyond the border (the border
    voxels are cropped by the caller)."""
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis)] = pad[2 * (x.dim() - 1 - axis) + 1] = 1
    xp = torch.nn.functional.pad(x, pad)
    n = x.shape[axis]
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def jacobian_determinant(disp, dtype=torch.float32) -> torch.Tensor:
    """det(I + J) of the field ``disp`` (B, 3, D, H, W), cropped by 2 voxels
    on every side: (B, D-4, H-4, W-4), in ``dtype`` (fp32 as keymorph_tpu;
    float64 for a reference) on ``disp``'s device.

    The identity is added to the field's derivatives, so a sampling grid
    passed as is (the eval harness does, as keymorph_tpu does) gives the
    determinant of I + d(grid)."""
    disp = torch.as_tensor(disp).to(dtype)
    J = torch.stack([_central_diff(disp, axis) for axis in (2, 3, 4)], dim=1)
    J = J + torch.eye(3, dtype=dtype, device=disp.device)[None, :, :, None, None, None]
    J = J[:, :, :, 2:-2, 2:-2, 2:-2]
    a, b, c = J[:, 0, 0], J[:, 0, 1], J[:, 0, 2]
    d, e, f = J[:, 1, 0], J[:, 1, 1], J[:, 1, 2]
    g, h, i = J[:, 2, 0], J[:, 2, 1], J[:, 2, 2]
    return a * (e * i - f * h) - d * (b * i - c * h) + g * (b * f - c * e)


def jdstd(disp) -> float:
    """Population standard deviation (ddof 0) of the Jacobian determinant."""
    return float(torch.std(jacobian_determinant(disp), correction=0))


def jdlessthan0(disp, as_percentage=False):
    """Count (or fraction) of non-positive Jacobian determinants."""
    jd = jacobian_determinant(disp)
    if as_percentage:
        return float(torch.mean((jd <= 0).float()))
    return int(torch.sum(jd <= 0))


# ---------------------------------------------------------------------------
# LC2 multimodal similarity
# ---------------------------------------------------------------------------


def lc2_gradient(mr: torch.Tensor) -> torch.Tensor:
    """|grad| of (B, Z, Y, X) volumes by keymorph_tpu's 3-tap filter: per
    axis ``v[i - 1] - v[i + 1]`` with zero padding (the conv of taps +1 and
    -1, one exact subtraction a voxel), then the L2 norm over the three."""
    p = F.pad(mr, (1, 1, 1, 1, 1, 1))
    c = slice(1, -1)
    gx = p[:, c, c, :-2] - p[:, c, c, 2:]
    gy = p[:, c, :-2, c] - p[:, c, 2:, c]
    gz = p[:, :-2, c, c] - p[:, 2:, c, c]
    return torch.sqrt(gx * gx + gy * gy + gz * gz)


def _lc2_run(us, mr, radius: int, dtype=torch.float32, alpha: float = 1e-3,
             beta: float = 1e-2) -> torch.Tensor:
    """Single-scale LC2 of (B, 1, S, S, S) odd cubes -> (B,) in [0, 1]: the
    centre (2r+1)^3 crop of ``us`` regressed on [mr, |grad mr|, 1] by the
    ridge (alpha) normal equations, scored as the share of its variance
    explained (the variance floored at beta)."""
    us = torch.as_tensor(us)[:, 0].to(dtype)
    mr = torch.as_tensor(mr, device=us.device)[:, 0].to(dtype)
    if us.dim() != 4 or not us.shape[1] == us.shape[2] == us.shape[3]:
        raise ValueError(f"LC2: input must be cubic (B, 1, S, S, S), got {tuple(us.shape)}")
    bs, size = mr.shape[0], mr.shape[1]
    if size % 2 != 1:
        raise ValueError(f"LC2: input must be odd size, got {size}")
    pad = (size - (2 * radius + 1)) // 2
    count = (2 * radius + 1) ** 3
    sl = (slice(None),) + (slice(pad, size - pad),) * 3
    A = torch.stack([mr[sl].reshape(bs, -1), lc2_gradient(mr)[sl].reshape(bs, -1),
                     torch.ones((bs, count), dtype=dtype, device=us.device)], dim=1)
    b = us[sl].reshape(bs, -1)
    C = (A @ A.transpose(1, 2) / count
         + alpha * torch.eye(3, dtype=dtype, device=us.device)[None])
    Atb = (A @ b[..., None])[..., 0] / count
    coeff = torch.linalg.solve_ex(C, Atb[..., None])[0][..., 0]
    mean_b2 = torch.mean(b * b, dim=1)
    var = mean_b2 - torch.mean(b, dim=1) ** 2
    dist = (mean_b2 + torch.einsum("bi,bj,bij->b", coeff, coeff, C)
            - 2 * torch.einsum("bi,bi->b", coeff, Atb))
    return torch.clamp((var - dist) / torch.clamp(var, min=beta), 0.0, 1.0)


class LC2:
    """Local correlation-of-correlations similarity of (B, 1, S, S, S) odd
    cubes, averaged over ``radiuses``: (B,). ``dtype`` is the working
    precision (fp32 as keymorph_tpu; float64 gives the oracle)."""

    def __init__(self, radiuses: Sequence[int] = (3, 5, 7), dtype=torch.float32):
        self.radiuses = radiuses
        self.dtype = dtype

    def __call__(self, us, mr):
        s = _lc2_run(us, mr, self.radiuses[0], self.dtype)
        for r in self.radiuses[1:]:
            s = s + _lc2_run(us, mr, r, self.dtype)
        return s / len(self.radiuses)

    forward = __call__


class ImageLC2:
    """Patchwise LC2: the images cut into non-overlapping ``patch_size``
    cubes (:meth:`patch2batch`), LC2 of each, their mean (``reduction``
    "mean") or each patch's (None)."""

    def __init__(self, patch_size: int = 51, radiuses: Sequence[int] = (5,), reduction="mean",
                 dtype=torch.float32):
        if reduction not in ("mean", None):
            raise ValueError(f"reduction={reduction!r}: 'mean' or None")
        self.patch_size = patch_size
        self.radii = radiuses
        self.reduction = reduction
        self.dtype = dtype

    @staticmethod
    def patch2batch(x, size: int, stride: int) -> torch.Tensor:
        """(B, C, *spatial) 2D or 3D -> (B * patches, C, size, ...): the
        non-overlapping patches (``stride == size``; the crop-and-reshape
        refuses another stride, as keymorph_tpu's does), with keymorph_tpu's
        reshape order."""
        x = torch.as_tensor(x)
        nch, spatial = x.shape[1], x.shape[2:]
        counts = [(s - size) // stride + 1 for s in spatial]
        x = x[(slice(None), slice(None))
              + tuple(slice(0, (c - 1) * stride + size) for c in counts)]
        if len(spatial) == 2:
            x = x.reshape(-1, nch, counts[0], size, counts[1], size)
            return x.movedim(4, 3).reshape(-1, nch, size, size)
        x = x.reshape(-1, nch, counts[0], size, counts[1], size, counts[2], size)
        return x.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(-1, nch, size, size, size)

    def __call__(self, us, mr):
        if tuple(us.shape) != tuple(mr.shape):
            raise ValueError(f"ImageLC2: shapes {tuple(us.shape)} and {tuple(mr.shape)} differ")
        us_p = self.patch2batch(us, self.patch_size, self.patch_size)
        mr_p = self.patch2batch(mr, self.patch_size, self.patch_size)
        s = LC2(self.radii, self.dtype)(us_p, mr_p)
        return torch.mean(s) if self.reduction == "mean" else s

    forward = __call__


# ---------------------------------------------------------------------------
# Aggregate / pairwise metrics (streaming from arrays or files)
# ---------------------------------------------------------------------------


def _load_file(path, device=None):
    if path.endswith(".npy"):
        return torch.as_tensor(np.load(path), device=device)
    if path.endswith(".nii") or path.endswith(".nii.gz"):
        from keymorph_tpu_torch.data.nifti import load_nifti

        return torch.as_tensor(load_nifti(path).data, device=device)
    raise ValueError(f"File format not supported: {path}")


def _as_float(v):
    """A metric value as Python floats (a scalar, or a list per region)."""
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, np.float64)
    return float(v) if v.ndim == 0 else v.tolist()


class MultipleAvgSegPairwiseMetric:
    """All-pairs averages of several segmentation metrics in one pass.
    ``device`` holds the volumes loaded from files (None: the CPU)."""

    def __init__(self, device=None):
        self.device = device
        self.name2fn = {
            "dice": fast_dice,
            "harddice": DiceLoss(hard=True).forward,
            "harddiceroi": DiceLoss(hard=True, return_regions=True).forward,
            "softdice": DiceLoss().forward,
            "hausd": hausdorff_distance,
        }

    def __call__(self, batch_of_imgs, fn_names) -> Dict[str, float]:
        res = {name: 0.0 for name in fn_names}
        num = 0
        for i in range(len(batch_of_imgs)):
            for j in range(i + 1, len(batch_of_imgs)):
                if isinstance(batch_of_imgs[0], str):
                    img1 = _load_file(batch_of_imgs[i], self.device)
                    img2 = _load_file(batch_of_imgs[j], self.device)
                else:
                    img1 = torch.as_tensor(batch_of_imgs[i: i + 1])
                    img2 = torch.as_tensor(batch_of_imgs[j: j + 1])
                for name in fn_names:
                    res[name] = res[name] + np.asarray(_as_float(self.name2fn[name](img1, img2)))
                num += 1
        return {name: _as_float(res[name] / num) for name in fn_names}

    forward = __call__


class MultipleAvgGridMetric:
    """Average grid metrics over a batch of (1, D, H, W, 3) sampling grids
    (arrays or ``.npy`` paths), each taken channel-first."""

    def __init__(self, device=None):
        self.device = device
        self.name2fn = {"jdstd": jdstd, "jdlessthan0": jdlessthan0}

    def __call__(self, batch_of_grids, fn_names) -> Dict[str, float]:
        res = {name: 0.0 for name in fn_names}
        for i in range(len(batch_of_grids)):
            if isinstance(batch_of_grids[i], str):
                grid = _load_file(batch_of_grids[i], self.device)
            else:
                grid = torch.as_tensor(batch_of_grids[i: i + 1])
            grid = torch.movedim(grid, -1, 1)
            for name in fn_names:
                res[name] = res[name] + self.name2fn[name](grid)
        return {name: res[name] / len(batch_of_grids) for name in fn_names}

    forward = __call__


def _make_avg_pairwise(metric_fn):
    class _AvgPairwise:
        def __init__(self, device=None):
            self.device = device

        def __call__(self, batch_of_imgs):
            loss = 0.0
            num = 0
            for i in range(len(batch_of_imgs)):
                for j in range(i + 1, len(batch_of_imgs)):
                    if isinstance(batch_of_imgs[0], str):
                        img1 = _load_file(batch_of_imgs[i], self.device)
                        img2 = _load_file(batch_of_imgs[j], self.device)
                    else:
                        img1 = torch.as_tensor(batch_of_imgs[i: i + 1])
                        img2 = torch.as_tensor(batch_of_imgs[j: j + 1])
                    loss = loss + _as_float(metric_fn(img1, img2))
                    num += 1
            return loss / num

        forward = __call__

    return _AvgPairwise


MSEPairwiseLoss = _make_avg_pairwise(MSELoss().forward)
SoftDicePairwiseLoss = _make_avg_pairwise(DiceLoss().forward)
HardDicePairwiseLoss = _make_avg_pairwise(DiceLoss(hard=True).forward)
HausdorffPairwiseLoss = _make_avg_pairwise(hausdorff_distance)


class _AvgGridMetric:
    """Average of one grid metric over a batch of sampling grids."""

    def __init__(self, metric_fn, device=None):
        self.metric_fn = metric_fn
        self.device = device

    def __call__(self, batch_of_grids):
        tot = 0.0
        for i in range(len(batch_of_grids)):
            if isinstance(batch_of_grids[i], str):
                grid = _load_file(batch_of_grids[i], self.device)
            else:
                grid = torch.as_tensor(batch_of_grids[i: i + 1])
            tot += self.metric_fn(torch.movedim(grid, -1, 1))
        return tot / len(batch_of_grids)

    forward = __call__


class AvgJDStd(_AvgGridMetric):
    def __init__(self, device=None):
        super().__init__(jdstd, device)


class AvgJDLessThan0(_AvgGridMetric):
    def __init__(self, device=None):
        super().__init__(jdlessthan0, device)
