"""Measure the multi-channel warp (one-hot segmentations, C = 5-50). Port of
``keymorph_tpu/tools/warp_channels_bench.py``'s function, not of its Pallas
knobs (the band-scratch budget and the group-DMA switch have no
counterpart).

At S^3 and each C it times, on uniform random sources (seeded) and a smooth rotation + scale flow (4 degrees,
1.04: the small rung, like real TPS flows), the warp kernel
(``ops/cuda/resample3d.py:warp_planes``), ``F.grid_sample`` (border,
``align_corners=False``) on the same flow, and states the byte bound (the
source and output read and written once, the planes read once, over
3.35 TB/s); it holds the kernel against its plain version (bit for bit, as
``chip_smoke.py`` phase 1 does) and states ``F.grid_sample``'s distance.

Usage (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.tools.warp_channels_bench [S] [C,C,...] [deg scale]
Defaults: S=256, C=1,6,14. Timing: CUDA events, the mean over 3 varied
sources after a warm-up. Prints one JSON line, with the card (``nvidia-smi``
name and power limit).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _rot_scale_planes(S: int, deg: float = 14.0, scale: float = 1.10) -> np.ndarray:
    """(1, 3, S, S, S) ij-ordered normalized sample coords for an oblique
    rotation + uniform scale about the volume center (keymorph_tpu's
    ``tools/warp_tile_sweep.py:_rot_scale_planes``)."""
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    A = scale * (rz @ ry)
    ax = np.linspace(-1 + 1 / S, 1 - 1 / S, S, dtype=np.float64)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([zz, yy, xx], 0).reshape(3, -1)
    return (A @ pts).reshape(1, 3, S, S, S).astype(np.float32)


def bench(S=256, Cs=(1, 6, 14), deg=4.0, scale=1.04, device=None):
    """The record ``main`` prints: per C the kernel's, ``F.grid_sample``'s
    and the bound's ms, the kernel's distance from its plain version and
    ``F.grid_sample``'s from the kernel."""
    import torch
    import torch.nn.functional as F

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.ops.cuda.resample3d import warp_planes, warp_planes_plain
    from keymorph_tpu_torch.ops.planes import planes_to_grid
    from keymorph_tpu_torch.tools import card, mean_ms
    from keymorph_tpu_torch.tools.flops import H100_HBM_BYTES_PER_S, warp_bytes

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    planes = torch.tensor(_rot_scale_planes(S, deg, scale), device=device)
    grid = planes_to_grid(planes).contiguous()
    rows = []
    with torch.no_grad():
        for C in Cs:
            srcs = [(torch.rand((1, C, S, S, S), generator=gen, device=device),)
                    for _ in range(3)]
            out = warp_planes(srcs[0][0], planes)
            plain = warp_planes_plain(srcs[0][0], planes)
            lib = F.grid_sample(srcs[0][0], grid, mode="bilinear", padding_mode="border",
                                align_corners=False)
            row = {"C": C, "max_abs_err_vs_plain": float((out - plain).abs().max()),
                   "grid_sample_max_abs_d": float((lib - out).abs().max())}
            del out, plain, lib
            row["ms"], timer = mean_ms(lambda im: warp_planes(im, planes), srcs, device)
            row["grid_sample_ms"], _ = mean_ms(
                lambda im: F.grid_sample(im, grid, mode="bilinear", padding_mode="border",
                                         align_corners=False), srcs, device)
            row["bound_ms"] = warp_bytes(S ** 3, C, in_bytes=4) / H100_HBM_BYTES_PER_S * 1e3
            rows.append(row)
            del srcs
    return {"tool": "warp_channels_bench", "card": card(device), "device": str(device),
            "S": S, "deg": deg, "scale": scale, "timer": timer, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("S", nargs="?", type=int, default=256)
    ap.add_argument("C", nargs="?", type=str, default="1,6,14", help="comma-separated channels")
    ap.add_argument("deg", nargs="?", type=float, default=4.0)
    ap.add_argument("scale", nargs="?", type=float, default=1.04)
    ap.add_argument("--device", type=str, default=None,
                    help='default: the CUDA card; "cpu" runs the plain version, host clock')
    args = ap.parse_args(argv)
    rec = bench(args.S, tuple(int(c) for c in args.C.split(",")), args.deg, args.scale,
                args.device)
    if any(r["max_abs_err_vs_plain"] != 0.0 for r in rec["rows"]):
        raise AssertionError(f"warp_planes differs from its plain version: {rec['rows']}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
