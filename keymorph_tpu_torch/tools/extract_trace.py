"""Profile keypoint extraction at the flagship config and print the device
time by kernel. The torch.profiler form of
``keymorph_tpu/tools/extract_trace.py``, over
:func:`keymorph_tpu_torch.tools.trace_summary.profile_fn`.

TruncatedUNet3D (f_maps 32, 4 levels, 1 truncated, bf16), 128 keypoints,
seeded weights; ``KeyMorphNet.get_keypoints`` of 3 uniform-noise volumes at
S^3 after a warm-up, under ``torch.no_grad()``. Prints the card, the host
wall and device busy time per call, the device's idle share, and the top
kernels' ms per call.

Usage (on the card unless ``--device cpu``, where no device time exists):
    python -m keymorph_tpu_torch.tools.extract_trace [S] [top_n]
"""

from __future__ import annotations

import argparse

import numpy as np


def report(label, summary, calls, card):
    """Print ``profile_fn``'s summary per call: the card, host wall, device
    busy and idle share, and each op's ms per call."""
    print(f"{label}: {card or 'CPU (device time not measured)'}; host wall "
          f"{summary['wall_ms'] / calls:.3f} ms per call")
    if summary["busy_ms"] is None:
        print("device busy: not measured (the profiler recorded no device activity)")
        return
    print(f"device busy {summary['busy_ms'] / calls:.3f} ms per call, idle share "
          f"{summary['idle_share']:.4f}")
    total = 0.0
    for name, ms, count in summary["ops"]:
        total += ms
        print(f"{ms / calls:9.3f} ms  x{count:<4d} {name[:110]}")
    print(f"(top-{len(summary['ops'])} per-call total {total / calls:.3f} ms)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("S", nargs="?", type=int, default=256)
    ap.add_argument("top_n", nargs="?", type=int, default=30)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.tools import card
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.tools.trace_summary import profile_fn

    device = resolve_device(args.device)
    backbone = TruncatedUNet3D(out_channels=128, f_maps=32, num_levels=4, num_truncated_layers=1,
                               dtype=torch.bfloat16)
    net = KeyMorphNet(init_weights(backbone, torch.Generator().manual_seed(0)), 128)
    net = net.to(device).eval()
    rng = np.random.default_rng(0)
    imgs = [torch.tensor(rng.uniform(0, 1, (1, 1, args.S, args.S, args.S)).astype(np.float32),
                         device=device) for _ in range(3)]

    def run():
        for im in imgs:
            net.get_keypoints(im)

    with torch.no_grad():
        net.get_keypoints(imgs[0])  # warm-up: builds the kernels
        _, summary = profile_fn(run, top_n=args.top_n)
    report(f"extract {args.S}^3", summary, len(imgs), card(device))
    return summary


if __name__ == "__main__":
    main()
