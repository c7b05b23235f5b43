"""IXI data preparation: resample already-downloaded IXI NIfTI files to
1 mm / 256^3 (or a chosen size) into the ``{root}/{T1,T2,PD}`` layout that
``IXIDataset`` expects. Port of ``keymorph_tpu/tools/prepare_ixi.py``'s
resample path; the port has no download step, so ``--raw_dir`` is
required.

Usage:
    python -m keymorph_tpu_torch.tools.prepare_ixi --out_dir ./ixi --raw_dir RAW \\
        [--modalities T1 T2 PD] [--size 256]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def resample_dir(raw_dir: str, out_dir: str, size: int = 256):
    """Canonicalize + resize every NIfTI in raw_dir into out_dir, the
    affine's voxel axes scaled to the new grid (voxel centres kept)."""
    from keymorph_tpu_torch.data.nifti import load_nifti, save_nifti, to_canonical
    from keymorph_tpu_torch.data.preprocess import resize_volume

    os.makedirs(out_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(raw_dir) if f.endswith((".nii", ".nii.gz")))
    for name in names:
        img = to_canonical(load_nifti(os.path.join(raw_dir, name)))
        data = img.data
        if data.ndim == 4:
            data = data[..., 0]
        scale = np.asarray(data.shape, np.float64) / size
        out = resize_volume(data.astype(np.float32), (size,) * 3)
        aff = img.affine.copy()
        R_old = aff[:3, :3].copy()
        aff[:3, :3] = R_old * scale[None, :]
        aff[:3, 3] = aff[:3, 3] + R_old @ (0.5 * (scale - 1.0))
        save_nifti(os.path.join(out_dir, name), out, aff)
        print(f"resampled {name} -> {out.shape}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--raw_dir", default=None,
                   help="Directory of already-downloaded IXI NIfTI files (required)")
    p.add_argument("--modalities", nargs="*", default=["T1", "T2", "PD"])
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    if args.raw_dir is None:
        p.error("--raw_dir is required: this tool has no download step; fetch the IXI "
                "archives elsewhere, unpack them and pass their directory as --raw_dir")
    for mod in args.modalities:
        resample_dir(args.raw_dir, os.path.join(args.out_dir, mod), args.size)


if __name__ == "__main__":
    main()
