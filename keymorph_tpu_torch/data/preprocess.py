"""Host-side preprocessing: ToCanonical -> Mask -> Resize -> rescale.

Port of ``keymorph_tpu/data/preprocess.py`` (numpy on the host, bit for bit
the same arrays and affines). Output is a dict of channel-first arrays
ready for the device: {img (1, *S), seg (1, *S)?, affine (4, 4)}.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np

from keymorph_tpu_torch.data.nifti import NiftiImage, load_nifti, to_canonical


def resize_volume(data: np.ndarray, target: Sequence[int], order: str = "linear"):
    """Resize a (*S,) volume to `target` with (tri)linear or nearest sampling.

    Output voxel centres map onto input voxel coordinates with the
    align_corners=False convention; float64 weights, host numpy.
    """
    src = np.asarray(data)
    ndim = src.ndim
    coords = []
    for ax, (n_out, n_in) in enumerate(zip(target, src.shape)):
        # output voxel centers mapped to input voxel coordinates
        c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        coords.append(c)
    mesh = np.meshgrid(*coords, indexing="ij")
    if order == "nearest":
        idx = tuple(
            np.clip(np.round(m), 0, s - 1).astype(np.int64)
            for m, s in zip(mesh, src.shape)
        )
        return src[idx]
    # linear interpolation
    lo = [np.floor(m).astype(np.int64) for m in mesh]
    frac = [m - l for m, l in zip(mesh, lo)]
    out = np.zeros(tuple(target), np.float64)
    for corner in itertools.product((0, 1), repeat=ndim):
        w = np.ones(tuple(target), np.float64)
        idx = []
        for k in range(ndim):
            ck = np.clip(lo[k] + corner[k], 0, src.shape[k] - 1)
            idx.append(ck)
            w = w * (frac[k] if corner[k] else (1.0 - frac[k]))
        out += src[tuple(idx)].astype(np.float64) * w
    return out.astype(src.dtype if np.issubdtype(src.dtype, np.floating) else np.float32)


def rescale_intensity_np(array, out_range=(0, 1), percentiles=(0, 100)):
    """Numpy twin of :func:`keymorph_tpu_torch.utils.rescale_intensity`."""
    x = np.asarray(array, np.float32)
    if tuple(percentiles) != (0, 100):
        lo, hi = np.percentile(x, percentiles)
        x = np.clip(x, lo, hi)
    in_min = x.min()
    in_range = x.max() - in_min
    if in_range == 0:
        in_range = 1.0
    return (x - in_min) / in_range * (out_range[1] - out_range[0]) + out_range[0]


@dataclasses.dataclass
class Preprocessor:
    """Configurable ToCanonical -> Mask -> Resize -> Rescale pipeline."""

    size: Optional[Tuple[int, int, int]] = (128, 128, 128)
    canonical: bool = True
    apply_mask: bool = True
    rescale: bool = True
    percentiles: Tuple[float, float] = (0, 100)

    def __call__(
        self,
        img: NiftiImage,
        seg: Optional[NiftiImage] = None,
        mask: Optional[NiftiImage] = None,
    ):
        if self.canonical:
            img = to_canonical(img)
            seg = to_canonical(seg) if seg is not None else None
            mask = to_canonical(mask) if mask is not None else None

        data = np.asarray(img.data, np.float32)
        affine = img.affine.copy()
        if mask is not None and self.apply_mask:
            data = data * (np.asarray(mask.data) > 0)

        seg_data = np.asarray(seg.data, np.float32) if seg is not None else None

        if self.size is not None and tuple(data.shape) != tuple(self.size):
            scale = np.asarray(data.shape, np.float64) / np.asarray(self.size)
            data = resize_volume(data, self.size, order="linear")
            if seg_data is not None:
                seg_data = resize_volume(seg_data, self.size, order="nearest")
            # new voxel j maps to old voxel i = (j + 0.5) * scale - 0.5, so
            # R_new = R_old * diag(scale), t_new = t_old + R_old @ (0.5*(scale-1))
            R_old = affine[:3, :3].copy()
            affine[:3, :3] = R_old * scale[None, :]
            affine[:3, 3] = affine[:3, 3] + R_old @ (0.5 * (scale - 1.0))

        if self.rescale:
            data = rescale_intensity_np(data, (0, 1), self.percentiles)

        out = {"img": data[None], "affine": affine.astype(np.float32)}
        if seg_data is not None:
            out["seg"] = seg_data[None]
        return out

    def load(self, img_path: str, seg_path=None, mask_path=None):
        img = load_nifti(img_path)
        seg = load_nifti(seg_path) if seg_path else None
        mask = load_nifti(mask_path) if mask_path else None
        out = self(img, seg, mask)
        out["path"] = img_path
        return out
