"""Brain extraction over a directory of NIfTI scans: ``SimpleUnet`` mask
prediction and connected-component cleanup, written as ``<name>_mask.nii.gz``
beside the scan's affine. Port of ``keymorph_tpu/tools/extract_brains.py``.

Usage:
    python -m keymorph_tpu_torch.tools.extract_brains \\
        --img_dir ixi/T1 --out_dir ixi/T1_mask --checkpoint params.npz [--device cpu]

``--checkpoint`` is the ``.npz`` of flat ``/``-joined flax parameter names
that keymorph_tpu's tool reads (``params/Conv_0/kernel`` ...); without one
the net keeps a random initialization (smoke tests only).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_simple_unet(path=None, seed: int = 0):
    """A ``SimpleUnet`` with the flax parameters of the ``.npz`` at ``path``
    (:func:`~keymorph_tpu_torch.tools.import_flax_params.simple_unet_state_dict_from_flax`),
    or seeded random weights when ``path`` is None."""
    import torch

    from keymorph_tpu_torch.models.unet import SimpleUnet, init_weights
    from keymorph_tpu_torch.tools.import_flax_params import (
        simple_unet_state_dict_from_flax,
        unflatten_npz,
    )

    model = SimpleUnet(out_channels=1)
    if path is None:
        return init_weights(model, torch.Generator().manual_seed(seed))
    with np.load(path) as flat:
        tree = unflatten_npz(flat)
    model.load_state_dict(simple_unet_state_dict_from_flax(tree))
    return model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="SimpleUnet flax params (.npz of '/'-joined names); random init "
                        "if omitted (for smoke testing only)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--clean_threshold", type=float, default=0.2)
    p.add_argument("--size", type=int, default=None, help="Optional working resolution")
    p.add_argument("--device", default=None,
                   help="where the net runs (default: the CUDA card)")
    args = p.parse_args(argv)

    from keymorph_tpu_torch import disable_tf32, resolve_device
    from keymorph_tpu_torch.brain_extract import extract_brain
    from keymorph_tpu_torch.data.nifti import load_nifti, save_nifti, to_canonical
    from keymorph_tpu_torch.data.preprocess import resize_volume

    device = resolve_device(args.device)
    disable_tf32()
    if args.checkpoint is None:
        print("WARNING: no checkpoint given; using random init")
    model = load_simple_unet(args.checkpoint).to(device).eval()
    os.makedirs(args.out_dir, exist_ok=True)
    for name in sorted(os.listdir(args.img_dir)):
        if not name.endswith((".nii", ".nii.gz")):
            continue
        img = to_canonical(load_nifti(os.path.join(args.img_dir, name)))
        data = img.data.astype(np.float32)
        orig_shape = data.shape
        if args.size:
            data = resize_volume(data, (args.size,) * 3)
        data = (data - data.min()) / max(data.max() - data.min(), 1e-6)
        mask = extract_brain(model, data[None, None], threshold=args.threshold,
                             clean_threshold=args.clean_threshold, device=device)[0, 0]
        if args.size:
            mask = (resize_volume(mask.astype(np.float32), orig_shape) > 0.5).astype(np.uint8)
        base = name.split(".")[0]
        out_path = os.path.join(args.out_dir, f"{base}_mask.nii.gz")
        save_nifti(out_path, mask, img.affine)
        print(f"{name}: mask voxels={int(mask.sum())} -> {out_path}")


if __name__ == "__main__":
    main()
