"""Generate a synthetic blob-brain dataset (NIfTI + CSV) for training runs.
Port of ``keymorph_tpu/tools/make_synthetic_dataset.py``: the same phantoms,
files and CSV, host numpy only.

The phantoms (:func:`make_subjects`) are a shared template of Gaussian
blobs, each subject an affine + per-blob jitter of it, with 4-label
segmentations. Non-first modalities apply distinct monotone intensity
remaps to the same anatomy, so multimodal pairs share geometry, as IXI's
T1/T2/PD do, and each modality has its own remap.

Run: python -m keymorph_tpu_torch.tools.make_synthetic_dataset --out DIR \\
        --n 10 --size 128 [--modalities T1 T2]

Writes DIR/img{i}_{mod}.nii.gz, DIR/seg{i}_{mod}.nii.gz and DIR/data.csv in
the CSVDataset modality schema (img_path,seg_path,mask_path,modality,train);
the last ``--n_test`` subjects per modality are test rows.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# distinct monotone remaps per modality slot (identity for the first)
REMAPS = (
    lambda x: x,
    lambda x: (1.0 - x) ** 2,
    lambda x: np.sqrt(np.clip(x, 0.0, 1.0)) * (1.0 - 0.5 * x),
    lambda x: np.sin(x * np.pi / 2.0) ** 2,
)


def make_subjects(n_subjects=6, size=64, n_blobs=24, seed=0):
    """Blob-brain phantoms: a shared template of Gaussian blobs, per-subject
    smooth spatial perturbation (small affine + per-blob jitter). Returns
    (imgs (N,1,S,S,S) float32, segs (N,1,S,S,S) int32 with 4 labels), the
    same arrays as keymorph_tpu's ``tools/weight_parity.py:make_subjects``."""
    rng = np.random.default_rng(seed)
    centers0 = rng.uniform(0.25, 0.75, size=(n_blobs, 3)) * size
    sigmas = rng.uniform(0.04, 0.10, size=(n_blobs,)) * size
    amps = rng.uniform(0.5, 1.0, size=(n_blobs,))
    labels = rng.integers(1, 4, size=(n_blobs,))  # blob -> seg label 1..3

    ax = np.arange(size, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")

    imgs, segs = [], []
    for _ in range(n_subjects):
        # small random rotation+scale+shift of the template
        ang = rng.uniform(-0.2, 0.2, size=3)
        Rz = np.array([[np.cos(ang[0]), -np.sin(ang[0]), 0],
                       [np.sin(ang[0]), np.cos(ang[0]), 0],
                       [0, 0, 1]])
        Ry = np.array([[np.cos(ang[1]), 0, np.sin(ang[1])],
                       [0, 1, 0],
                       [-np.sin(ang[1]), 0, np.cos(ang[1])]])
        scale = np.diag(rng.uniform(0.9, 1.1, size=3))
        M = Rz @ Ry @ scale
        shift = rng.uniform(-0.04, 0.04, size=3) * size
        c = (centers0 - size / 2) @ M.T + size / 2 + shift
        c = c + rng.normal(0, 0.01 * size, size=c.shape)  # per-blob jitter

        img = np.zeros((size, size, size), np.float32)
        lab = np.zeros((4, size, size, size), np.float32)
        for b in range(n_blobs):
            d2 = (zz - c[b, 0]) ** 2 + (yy - c[b, 1]) ** 2 + (xx - c[b, 2]) ** 2
            g = amps[b] * np.exp(-d2 / (2 * sigmas[b] ** 2))
            img += g
            lab[labels[b]] = np.maximum(lab[labels[b]], g)
        img = (img / img.max()).astype(np.float32)
        seg = np.where(lab.max(axis=0) > 0.3, lab.argmax(axis=0), 0).astype(np.int32)
        imgs.append(img[None])
        segs.append(seg[None])
    return np.stack(imgs), np.stack(segs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=10, help="subjects per modality")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--n_test", type=int, default=2)
    p.add_argument("--modalities", nargs="+", default=["T1"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from keymorph_tpu_torch.data.nifti import save_nifti

    os.makedirs(args.out, exist_ok=True)
    imgs, segs = make_subjects(n_subjects=args.n, size=args.size, seed=args.seed)
    rows = []
    for i in range(args.n):
        train = i < args.n - args.n_test
        for j, mod in enumerate(args.modalities):
            img = REMAPS[j % len(REMAPS)](imgs[i, 0])
            img_path = os.path.join(args.out, f"img{i}_{mod}.nii.gz")
            seg_path = os.path.join(args.out, f"seg{i}_{mod}.nii.gz")
            save_nifti(img_path, img.astype(np.float32))
            save_nifti(seg_path, segs[i, 0].astype(np.int16))
            rows.append(f"{img_path},{seg_path},None,{mod},{train}")
    csv_path = os.path.join(args.out, "data.csv")
    with open(csv_path, "w") as fh:
        fh.write("img_path,seg_path,mask_path,modality,train\n")
        fh.write("\n".join(rows) + "\n")
    print(f"wrote {len(rows)} rows to {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
