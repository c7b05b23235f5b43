"""Train the port's keypoint nets and register held-out pairs with them: the
trained side of the registration-parity record. Port of
``keymorph_tpu/tools/weight_parity.py`` with the port in the trained role.

The harness, as keymorph_tpu's:

  1. synthetic deformed-blob "brains" (``tools/make_synthetic_dataset.py:
     make_subjects``: images + 4-label segmentations);
  2. :func:`train_port` trains the port's ``KeyMorph`` end to end on them
     (unsupervised MSE through the closed-form affine solve, Adam, one pair
     a step with a random affine augmentation of the moving image);
  3. the trained backbone is saved as ``{"state_dict": ...}`` under the
     reference unet3d keys, which keymorph_tpu's
     ``tools/import_torch_weights.load_torch_backbone`` reads;
  4. :func:`port_register` registers each config's held-out pair over the
     align sweep; its results have the form keymorph_tpu's
     ``weight_parity._compare`` takes as the reference side.

This module compares nothing across packages: that is
``tests/test_torch_weight_parity.py``'s job, on the weights this tool writes
(``runs/torch_weight_parity/``).

Run (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.tools.weight_parity --steps 600 --size 96 \\
        --eval_size 128 --out DIR [--device cpu]

Writes DIR/port_trained_unet.pt and DIR/port_trained_truncated.pt (the
backbones), DIR/<net>.losses.json (the loss of every step, the card and
ms per step) and DIR/<config>.npz (each align's grid and keypoints), and
prints the card as ``tools.card()`` reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from keymorph_tpu_torch.tools.make_synthetic_dataset import make_subjects

ALIGNS = ("rigid", "affine", "tps_1", "tps_0.1", "tps_0")
CONFIGS = ("unet64", "truncatedunet128", "truncatedunet128_rw")
AUGMENT = (0.1, 0.1, 1.57, 0.05)  # max (scale, offset, rotation, shear) of the moving image
CHECKPOINTS = {"unet": "port_trained_unet.pt", "truncatedunet": "port_trained_truncated.pt"}


def build_backbone(num_keypoints, f_maps, num_levels, backbone="unet", num_truncated_layers=1,
                   seed=0, dtype=None):
    """The 'gcr' U-Net of the parity runs (``num_groups = min(8, f_maps)``;
    fp32 unless ``dtype``), initialized from a generator seeded with
    ``seed``."""
    import torch

    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, UNet3D, init_weights

    dtype = dtype or torch.float32
    kw = dict(out_channels=num_keypoints, f_maps=f_maps, layer_order="gcr",
              num_groups=min(8, f_maps), num_levels=num_levels, dtype=dtype)
    if backbone == "truncatedunet":
        net = TruncatedUNet3D(num_truncated_layers=num_truncated_layers, **kw)
    elif backbone == "unet":
        net = UNet3D(**kw)
    else:
        raise ValueError(f"backbone={backbone!r}: 'unet' or 'truncatedunet'")
    return init_weights(net, torch.Generator().manual_seed(int(seed))).to(dtype)


def load_port(path, num_keypoints, f_maps, num_levels, backbone="unet", num_truncated_layers=1,
              device=None):
    """A ``KeyMorph`` (eval mode) on the backbone saved at ``path`` (a
    ``{"state_dict": ...}`` file, as :func:`main` writes it)."""
    import torch

    from keymorph_tpu_torch.models.keymorph import KeyMorph

    net = build_backbone(num_keypoints, f_maps, num_levels, backbone, num_truncated_layers)
    net.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["state_dict"])
    return KeyMorph(net, num_keypoints, dim=3, device=device).eval()


def save_backbone(model, path):
    """Write ``model``'s backbone as ``{"state_dict": ...}`` (the reference
    unet3d keys), the file :func:`load_port` and keymorph_tpu's
    ``load_torch_backbone`` read."""
    import torch

    sd = {k: v.detach().cpu() for k, v in model.net.backbone.state_dict().items()}
    torch.save({"state_dict": sd}, path)


def affine_mse(model, img_f, img_m, plain=False):
    """The training loss: the MSE between the fixed image and the moving one
    warped by ``model``'s affine registration (a ``KeyMorph`` in train
    mode). ``plain`` warps through the warp kernel's plain version (the
    oracle route on a card)."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.ops.cuda import resample3d
    from keymorph_tpu_torch.ops.resample import align_img, grid_to_planes

    grid = model(img_f, img_m, transform_type="affine", return_aligned_points=False)["affine"]["grid"]
    if plain:
        img_a = resample3d.warp_planes_plain(img_m, grid_to_planes(grid))
    else:
        img_a = align_img(grid, img_m)
    return F.mse_loss(img_f, img_a)


def draw_pair(data, rng, gen):
    """One training pair of ``data`` (N, 1, *S): (fixed, moving), drawn by
    ``rng.choice`` without replacement, the moving image augmented by a
    random affine transform from the generator ``gen``."""
    import torch

    from keymorph_tpu_torch.augment import random_affine_augment

    i, j = rng.choice(len(data), size=2, replace=False)
    with torch.no_grad():
        img_m = random_affine_augment(gen, data[j:j + 1], max_random_params=AUGMENT)
    return data[i:i + 1], img_m


def train_port(imgs, steps, num_keypoints, f_maps, num_levels, lr, seed=0, backbone="unet",
               num_truncated_layers=1, device=None, log_every=20):
    """Train the port end to end (affine, unsupervised MSE), keymorph_tpu's
    ``train_reference`` on the port: each step draws its pair from
    ``np.random.default_rng(seed)``, augments the moving image from a CPU
    ``torch.Generator(seed)`` (so the card and the CPU draw the same
    transforms) and takes one Adam step. Returns (the ``KeyMorph``, the
    loss of every step)."""
    import torch

    from keymorph_tpu_torch.models.keymorph import KeyMorph

    net = build_backbone(num_keypoints, f_maps, num_levels, backbone, num_truncated_layers, seed)
    model = KeyMorph(net, num_keypoints, dim=3, device=device).train()
    opt = torch.optim.Adam(model.net.parameters(), lr=lr)
    data = torch.from_numpy(np.asarray(imgs, np.float32)).to(model.device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(seed))
    losses = []
    for step in range(steps):
        loss = affine_mse(model, *draw_pair(data, rng, gen))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"[port] step {step}: mse {losses[-1]:.5f}", flush=True)
    return model, losses


def port_register(model, img_f, img_m, aligns, aff_f=None, aff_m=None):
    """Registration results of a trained port ``KeyMorph``: ({align: {"grid",
    "points_f", "points_m"}} as numpy, ``warp(grid, vol, mode)``), the form
    of keymorph_tpu's ``weight_parity.reference_register``. ``aff_f``/``aff_m``
    register in real-world coordinates."""
    import torch

    from keymorph_tpu_torch.ops.resample import align_img

    model.eval()
    model.align_keypoints_in_real_world_coords = aff_f is not None
    kwargs = {} if aff_f is None else {"aff_f": aff_f, "aff_m": aff_m}
    with torch.no_grad():
        res = model(img_f, img_m, transform_type=list(aligns), return_aligned_points=False,
                    **kwargs)
    out = {k: {"grid": r["grid"].cpu().numpy(), "points_f": r["points_f"].float().cpu().numpy(),
               "points_m": r["points_m"].float().cpu().numpy()} for k, r in res.items()}

    def warp(grid, vol, mode="bilinear"):
        with torch.no_grad():
            return align_img(model._tensor(grid), model._tensor(vol), mode=mode).cpu().numpy()

    return out, warp


def record_path(out, backbone):
    """Where :func:`main` writes ``backbone``'s training record in ``out``."""
    return os.path.join(out, CHECKPOINTS[backbone].replace(".pt", ".losses.json"))


def read_record(out, backbone):
    """The training record :func:`main` wrote for ``backbone`` in ``out``:
    its settings, card, ms per step and the loss of every step."""
    with open(record_path(out, backbone)) as fh:
        return json.load(fh)


def rw_affines(seed=3):
    """A pair of plausible NIfTI affines (anisotropic voxels + offsets):
    keymorph_tpu's ``weight_parity._rw_affines``."""
    rng = np.random.default_rng(seed)

    def one():
        a = np.eye(4, dtype=np.float32)
        a[:3, :3] = np.diag(rng.uniform(0.8, 1.5, size=3)).astype(np.float32)
        a[:3, 3] = rng.uniform(-40, 40, size=3)
        return a[None]

    return one(), one()


def eval_pairs(size=96, eval_size=128):
    """Each config's held-out pair, as keymorph_tpu's ``main`` draws it:
    {config: (img_f, img_m, seg_f, seg_m, aff_f, aff_m)} (affines None
    outside real-world mode). The UNet's pair is the first two of the six
    subjects its net trains beside; ``make_subjects`` draws them first, so
    two are drawn here."""
    imgs, segs = make_subjects(n_subjects=2, size=size)
    hi, hi_segs = make_subjects(n_subjects=2, size=eval_size, seed=7)
    aff_f, aff_m = rw_affines()
    return {"unet64": (imgs[0:1], imgs[1:2], segs[0:1], segs[1:2], None, None),
            "truncatedunet128": (hi[0:1], hi[1:2], hi_segs[0:1], hi_segs[1:2], None, None),
            "truncatedunet128_rw": (hi[0:1], hi[1:2], hi_segs[0:1], hi_segs[1:2], aff_f, aff_m)}


def config_backbone(name):
    """The backbone a config registers with: 'unet' or 'truncatedunet'."""
    return "unet" if name == "unet64" else "truncatedunet"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="weight_parity_out")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--eval_size", type=int, default=128,
                   help="resolution of the truncatedunet/rw eval pairs")
    p.add_argument("--num_keypoints", type=int, default=32)
    p.add_argument("--f_maps", type=int, default=8)
    p.add_argument("--num_levels", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--aligns", nargs="+", default=list(ALIGNS))
    p.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=CONFIGS)
    p.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    import torch

    from keymorph_tpu_torch import disable_tf32, resolve_device
    from keymorph_tpu_torch.tools import card

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    print(json.dumps({"card": card(device), "device": str(device)}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    pairs = eval_pairs(args.size, args.eval_size)
    kinds = []
    if "unet64" in args.configs:
        kinds.append(("unet", 0))
    if any(c.startswith("truncatedunet") for c in args.configs):
        kinds.append(("truncatedunet", 1))
    for backbone, data_seed in kinds:
        imgs, _ = make_subjects(size=args.size, seed=data_seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        model, losses = train_port(imgs[2:], args.steps, args.num_keypoints, args.f_maps,
                                   args.num_levels, args.lr, backbone=backbone, device=device)
        ms = (time.perf_counter() - t0) * 1e3 / max(args.steps, 1)
        name = CHECKPOINTS[backbone]
        save_backbone(model, os.path.join(args.out, name))
        record = {"backbone": backbone, "steps": args.steps, "size": args.size,
                  "num_keypoints": args.num_keypoints, "f_maps": args.f_maps,
                  "num_levels": args.num_levels, "lr": args.lr, "seed": 0,
                  "data_seed": data_seed, "device": str(device), "card": card(device),
                  "ms_per_step_host_clock": ms, "losses": losses}
        with open(record_path(args.out, backbone), "w") as fh:
            json.dump(record, fh)
        print(f"[port] {backbone}: {args.steps} steps, mse {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"{ms:.3f} ms a step (host clock)", flush=True)
        for cfg in args.configs:
            if config_backbone(cfg) != backbone:
                continue
            img_f, img_m, _, _, aff_f, aff_m = pairs[cfg]
            res, _ = port_register(model, img_f, img_m, args.aligns, aff_f, aff_m)
            np.savez(os.path.join(args.out, f"{cfg}.npz"),
                     **{f"{k}/{f}": v for k, r in res.items() for f, v in r.items()})
            print(f"[port] {cfg}: registered {list(res)}", flush=True)


if __name__ == "__main__":
    main()
