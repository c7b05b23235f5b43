"""Measure approximate TPS against exact TPS at large keypoint counts. Port
of ``keymorph_tpu/tools/tps_approx_bench.py``.

Approximate TPS fits against only S of the K keypoints as RBF centres, so
the dense flow costs O(S) a voxel instead of O(K): a serving lever for
K >= 256. ``main`` times the solve + flow stage (the planes path,
``align_pair(..., compute_grid="planes", tps_centers=S)``: the TPS-flow
kernel on the card) at K keypoints, exact and at each S, with each
approximate flow's largest distance from the exact one and its speedup.
``--ranked`` compares the first-S centres with the mass-ranked S
(``KeyMorphNet.pair_ranked_by_mass``) on a K-keypoint TruncatedUNet3D
(bf16, seeded weights) extracting two phantoms of ``make_subjects``: each
approximate flow's max and mean distance from the exact flow and the hard
Dice of the moving segmentation warped (nearest) by each against the exact.

Usage (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.tools.tps_approx_bench [size] [K] [S,S,...]
        defaults 256, 512, 128,256; timing: CUDA events, the mean over 3
        varied inputs after a warm-up
    python -m keymorph_tpu_torch.tools.tps_approx_bench --ranked [size] [K] [S,S,...]
        defaults 128, 512, 64,128,256

Prints one JSON line, with the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def solve_flow(points_f, points_m, spatial, tps_centers=None):
    """The planes (B, 3, *spatial) of TPS at lmbda 1, exact or with the
    first ``tps_centers`` keypoints as centres."""
    import torch

    from keymorph_tpu_torch.models.keymorph import align_pair

    lmbda = torch.ones((points_f.shape[0],), device=points_f.device)
    with torch.no_grad():
        return align_pair(points_f, points_m, "tps", spatial, lmbda=lmbda, num_chunks=8,
                          compute_grid="planes", tps_centers=tps_centers)["planes"]


def bench(size=256, K=512, Ss=(128, 256), device=None):
    """Exact against approximate TPS at ``size``^3 and K keypoints: the
    record ``main`` prints."""
    import torch

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.tools import card, mean_ms

    device = resolve_device(device)
    spatial = (size,) * 3
    rng = np.random.default_rng(0)

    def points():
        pf = rng.uniform(-0.7, 0.7, (1, K, 3)).astype(np.float32)
        pm = pf + 0.05 * rng.normal(size=(1, K, 3)).astype(np.float32)
        return torch.tensor(pf, device=device), torch.tensor(pm, device=device)

    triples = [points() for _ in range(3)]
    rec = {"tool": "tps_approx_bench", "card": card(device), "device": str(device),
           "size": size, "K": K, "ms": {}, "max_abs_d": {}, "speedup": {}}
    exact = None
    for label, S in [("exact", None)] + [(f"S={s}", s) for s in Ss]:
        out = solve_flow(*triples[0], spatial, S)
        if exact is None:
            exact = out
        else:
            rec["max_abs_d"][label] = float((out - exact).abs().max())
        del out
        rec["ms"][label], rec["timer"] = mean_ms(
            lambda pf, pm, S=S: solve_flow(pf, pm, spatial, S), triples, device)
    for label, ms in rec["ms"].items():
        if label != "exact":
            rec["speedup"][label] = rec["ms"]["exact"] / ms
    return rec


def _hard_dice(a, b):
    """Hard Dice of two label maps over their union of labels."""
    from keymorph_tpu_torch.metrics import fast_dice

    labs = np.union1d(a, b)
    oh_a = np.stack([a == lab for lab in labs])[None].astype(np.float32)
    oh_b = np.stack([b == lab for lab in labs])[None].astype(np.float32)
    return float(fast_dice(oh_a, oh_b))


def ranked_fidelity(size=128, K=512, Ss=(64, 128, 256), device=None):
    """First-S against mass-ranked-S centres: the record ``--ranked``
    prints (rows of S, order, max and mean |d| from the exact flow in grid
    units, hard Dice against the exact flow's warp)."""
    import torch

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops.resample import align_planes
    from keymorph_tpu_torch.tools import card
    from keymorph_tpu_torch.tools.make_synthetic_dataset import make_subjects

    device = resolve_device(device)
    backbone = TruncatedUNet3D(out_channels=K, f_maps=32, num_levels=4, num_truncated_layers=1,
                               dtype=torch.bfloat16)
    net = KeyMorphNet(init_weights(backbone, torch.Generator().manual_seed(0)), K)
    net = net.to(device).eval()
    imgs, segs = make_subjects(n_subjects=2, size=size, seed=3)
    img_f, img_m = (torch.tensor(imgs[i: i + 1], device=device) for i in (0, 1))
    seg_m = torch.tensor(segs[1:2], dtype=torch.float32, device=device)
    spatial = (size,) * 3
    with torch.no_grad():
        orders = {"first": net(img_f, img_m), "ranked": net.pair_ranked_by_mass(img_f, img_m)}
        exact = solve_flow(*orders["first"][:2], spatial)
        seg_exact = align_planes(exact, seg_m, mode="nearest")[0, 0].cpu().numpy()
        rows = []
        for S in Ss:
            for label, (pf, pm, _) in orders.items():
                planes = solve_flow(pf, pm, spatial, S)
                d = (planes - exact).abs()
                seg_a = align_planes(planes, seg_m, mode="nearest")[0, 0].cpu().numpy()
                rows.append({"S": S, "order": label, "max_abs_d": float(d.max()),
                             "mean_abs_d": float(d.mean()),
                             "dice_vs_exact": _hard_dice(seg_a, seg_exact)})
    return {"tool": "tps_approx_bench", "mode": "ranked", "card": card(device),
            "device": str(device), "size": size, "K": K, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranked", action="store_true",
                    help="first-S against mass-ranked-S centres on an extracting net")
    ap.add_argument("size", nargs="?", type=int, default=None)
    ap.add_argument("K", nargs="?", type=int, default=512)
    ap.add_argument("S", nargs="?", type=str, default=None, help="comma-separated centre counts")
    ap.add_argument("--device", type=str, default=None,
                    help='default: the CUDA card; "cpu" runs the plain versions, host clock')
    args = ap.parse_args(argv)
    Ss = tuple(int(s) for s in args.S.split(",")) if args.S else None
    if args.ranked:
        rec = ranked_fidelity(args.size or 128, args.K, Ss or (64, 128, 256), args.device)
    else:
        rec = bench(args.size or 256, args.K, Ss or (128, 256), args.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
