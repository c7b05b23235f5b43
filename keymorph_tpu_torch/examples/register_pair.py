"""Example: pairwise registration of two volumes, end to end.

The port's counterpart of the repo's ``examples/register_pair.py``: loads two
NIfTI volumes, registers moving -> fixed with rigid, affine and TPS (lambda
1) in one forward pass, warps the image and the segmentation, reports MSE
and hard Dice, saves each grid and draws each registration's panel.

    python -m keymorph_tpu_torch.examples.register_pair \\
        --fixed f.nii.gz --moving m.nii.gz [--fixed_seg fs --moving_seg ms] \\
        [--size 128] [--num_keypoints 128] [--checkpoint ckpt_dir] \\
        [--out out_dir] [--device cpu]

The net is keymorph_tpu's example net, an fp32 TruncatedUNet3D (f_maps 32,
4 levels, 1 truncated layer), with seeded random weights unless
``--checkpoint`` names a checkpoint directory of the port
(``training/checkpoint.py``, as ``cli.run --load_path`` loads it). It runs on
the card unless ``--device cpu``. The panels are drawn with matplotlib;
where it is not installed the example refuses before any work.

:func:`register_pair` is the work without the printing and the files: per
transform, the grid, the keypoints, the warped image, MSE and hard Dice.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np
import torch

from keymorph_tpu_torch.losses import DiceLoss, mse_loss
from keymorph_tpu_torch.models.keymorph import KeyMorph
from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
from keymorph_tpu_torch.ops.resample import align_img
from keymorph_tpu_torch.utils import one_hot

ALIGNS = ("rigid", "affine", "tps_1")


def build_model(num_keypoints: int = 128, device=None, seed: int = 0) -> KeyMorph:
    """The example's model in evaluation mode, weights seeded from ``seed``."""
    backbone = TruncatedUNet3D(out_channels=num_keypoints, f_maps=32, num_levels=4,
                               num_truncated_layers=1)
    init_weights(backbone, torch.Generator().manual_seed(seed))
    return KeyMorph(backbone, num_keypoints, device=device).eval()


@torch.no_grad()
def register_pair(fixed: dict, moving: dict, km: KeyMorph) -> dict:
    """Register ``moving`` onto ``fixed`` (the ``data.Preprocessor``'s
    dicts: ``img`` (1, *S), optionally ``seg``) with every transform of
    ``ALIGNS`` in one forward pass of ``km``.

    Returns ``{name: {grid, points_f, points_m, points_a, img_a, mse, time,
    [harddice]}}``: tensors on the model's device, ``mse`` and ``harddice``
    (hard Dice over the labels but the background, where both
    segmentations are given) floats, ``time`` the forward's seconds."""
    img_f, img_m = (torch.as_tensor(s["img"][None], dtype=torch.float32, device=km.device)
                    for s in (fixed, moving))
    results = km(img_f, img_m, transform_type=list(ALIGNS), return_aligned_points=True)
    segs = "seg" in fixed and "seg" in moving
    if segs:
        n_cls = int(max(fixed["seg"].max(), moving["seg"].max())) + 1
        seg_f, seg_m = (one_hot(torch.as_tensor(s["seg"][None].astype(np.int32),
                                                device=km.device), n_cls)
                        for s in (fixed, moving))
    out = {}
    for name, res in results.items():
        img_a = align_img(res["grid"], img_m)
        row = {"grid": res["grid"], "points_f": res["points_f"], "points_m": res["points_m"],
               "points_a": res["points_a"], "img_a": img_a,
               "mse": float(mse_loss(img_f, img_a)), "time": res["time"]}
        if segs:
            seg_a = align_img(res["grid"], seg_m)
            row["harddice"] = 1 - float(DiceLoss(hard=True)(seg_a, seg_f, ign_first_ch=True))
        out[name] = row
    return out


def require_matplotlib():
    """Raise ImportError, naming matplotlib, where it is not installed."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("register_pair draws its panels with matplotlib, which is not "
                          "installed here; run it where matplotlib is")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fixed", required=True)
    p.add_argument("--moving", required=True)
    p.add_argument("--fixed_seg")
    p.add_argument("--moving_seg")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--num_keypoints", type=int, default=128)
    p.add_argument("--checkpoint")
    p.add_argument("--out", default="./register_pair_out")
    p.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = p.parse_args(argv)
    require_matplotlib()

    from keymorph_tpu_torch import disable_tf32, resolve_device, viz
    from keymorph_tpu_torch.data import Preprocessor
    from keymorph_tpu_torch.training import checkpoint as ckpt

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()  # the fp32 convs are full fp32
    pre = Preprocessor(size=(args.size,) * 3)
    fixed = pre.load(args.fixed, seg_path=args.fixed_seg)
    moving = pre.load(args.moving, seg_path=args.moving_seg)
    km = build_model(args.num_keypoints, device)
    if args.checkpoint:
        km.net.load_state_dict(ckpt.load_checkpoint(args.checkpoint)["params"])
        print(f"loaded checkpoint {args.checkpoint}")

    results = register_pair(fixed, moving, km)

    os.makedirs(args.out, exist_ok=True)
    img_f, img_m = fixed["img"][0], moving["img"][0]
    for name, res in results.items():
        line = f"{name}: mse={res['mse']:.5f}"
        if "harddice" in res:
            line += f" harddice={res['harddice']:.4f}"
        print(line, f"({res['time']:.2f}s)")
        np.save(os.path.join(args.out, f"grid_{name}.npy"), res["grid"][0].cpu().numpy())
        viz.imshow_registration_3d(
            img_m, img_f, res["img_a"][0, 0], res["points_m"][0], res["points_f"][0],
            res["points_a"][0], save_path=os.path.join(args.out, f"panel_{name}.png"))
    print(f"grids + panels saved to {args.out}")
    return results


if __name__ == "__main__":
    main()
