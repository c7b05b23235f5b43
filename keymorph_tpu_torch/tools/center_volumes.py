"""Translation-center volumes against a reference. Port of
``keymorph_tpu/tools/center_volumes.py``.

Each volume is translated so its intensity centroid lands on the reference
volume's centroid (in world space via the NIfTI affines), resampled with the
border-padded trilinear warp (``ops/planes.py:affine_register_warp``: the
warp kernel on the card).

Usage (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.tools.center_volumes \\
        --img_dir ixi/T1 --reference ixi/T1/IXI002.nii.gz --out_dir ixi/T1_centered
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def intensity_centroid_voxel(data: np.ndarray) -> np.ndarray:
    """Intensity-weighted centroid in voxel coordinates."""
    data = np.maximum(np.asarray(data, np.float64), 0)
    total = data.sum() + 1e-12
    idx = [np.arange(s) for s in data.shape]
    c = []
    for ax in range(data.ndim):
        axes = tuple(a for a in range(data.ndim) if a != ax)
        c.append(float((data.sum(axis=axes) * idx[ax]).sum() / total))
    return np.asarray(c)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img_dir", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", type=str, default=None,
                   help='Device to warp on (default: the CUDA card; "cpu" runs the '
                        "warp's plain version)")
    args = p.parse_args(argv)

    import torch

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.data.nifti import load_nifti, save_nifti, to_canonical
    from keymorph_tpu_torch.ops.planes import affine_register_warp

    device = resolve_device(args.device)
    ref = to_canonical(load_nifti(args.reference))
    ref_centroid_world = ref.affine[:3, :3] @ intensity_centroid_voxel(ref.data) + ref.affine[:3, 3]

    os.makedirs(args.out_dir, exist_ok=True)
    for name in sorted(os.listdir(args.img_dir)):
        if not name.endswith((".nii", ".nii.gz")):
            continue
        img = to_canonical(load_nifti(os.path.join(args.img_dir, name)))
        c_world = img.affine[:3, :3] @ intensity_centroid_voxel(img.data) + img.affine[:3, 3]
        delta_world = c_world - ref_centroid_world
        # world translation -> normalized [-1,1] translation per axis
        spacing = np.linalg.norm(img.affine[:3, :3], axis=0)
        delta_norm = 2.0 * delta_world / (spacing * np.asarray(img.shape))
        # sampling transform (fixed->moving): shift sample positions by +delta
        M = np.eye(4, dtype=np.float32)
        M[:3, 3] = delta_norm.astype(np.float32)
        with torch.no_grad():
            warped, _ = affine_register_warp(
                torch.as_tensor(M, device=device)[None],
                torch.as_tensor(np.asarray(img.data, np.float32), device=device)[None, None])
        out_path = os.path.join(args.out_dir, name)
        save_nifti(out_path, warped[0, 0].cpu().numpy(), img.affine)
        print(f"{name}: centered (|delta|={np.linalg.norm(delta_world):.1f}mm) -> {out_path}")


if __name__ == "__main__":
    main()
