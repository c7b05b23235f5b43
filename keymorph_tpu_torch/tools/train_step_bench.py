"""Time the canonical training step on one NVIDIA GPU.

The configuration of ``keymorph_tpu/tools/train_step_bench.py``:
TruncatedUNet3D (f_maps 32, 4 levels, 1 truncated, bf16), 128 keypoints,
``tps_loguniform``, MSE, 64-keypoint subsample, Adam(3e-6), batch 1, S^3
volumes of uniform noise from a numpy seed. One warm-up step (it builds the
kernels), then ``--steps`` timed steps: CUDA events around each step and the
host clock around the same work ending in a synchronize.

    python -m keymorph_tpu_torch.tools.train_step_bench [S] [--steps N]
        [--keypoints K] [--checkpoint] [--plain]

Prints one JSON object: the card (``nvidia-smi`` name and power limit), the
per-step times in ms, loss, grad_norm, peak device memory and the kernel
launch counters of the timed steps.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build(S: int, keypoints: int = 128, checkpoint: bool = False, seed: int = 0,
          device=None):
    """(net, config, state, images): the canonical step's ingredients."""
    import torch

    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.training.config import Config
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    backbone = TruncatedUNet3D(out_channels=keypoints, f_maps=32, num_levels=4,
                               num_truncated_layers=1, dtype=torch.bfloat16,
                               use_checkpoint=checkpoint)
    net = KeyMorphNet(init_weights(backbone, gen), keypoints).to(device)
    config = Config(num_keypoints=keypoints, transform_type="tps_loguniform",
                    loss_fn="mse", max_train_keypoints=64, img_size=(S, S, S))
    state = TrainState.create(net, make_optimizer(config, net))
    rng = np.random.default_rng(seed)
    imgs = [torch.tensor(rng.uniform(0, 1, size=(1, 1, S, S, S)).astype(np.float32),
                         device=device) for _ in range(4)]
    return net, config, state, imgs


def main(argv=None):
    import torch

    import keymorph_tpu_torch
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.tools import card
    from keymorph_tpu_torch.training.train import make_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("size", nargs="?", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--keypoints", type=int, default=128)
    ap.add_argument("--checkpoint", action="store_true",
                    help="block-level gradient checkpointing in the U-Net")
    ap.add_argument("--plain", action="store_true",
                    help="run every kernel's plain PyTorch version instead")
    args = ap.parse_args(argv)

    keymorph_tpu_torch.disable_tf32()
    net, config, state, imgs = build(args.size, args.keypoints, args.checkpoint)
    step = make_train_step(net, config, plain=args.plain)
    gen = torch.Generator().manual_seed(1)
    img_f, moving = imgs[0], imgs[1:]

    state, m = step(state, gen, img_f, moving[0], None, None, 1.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    event_ms, wall_ms = [], []
    for i in range(args.steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, gen, img_f, moving[i % len(moving)], None, None, 1.0)
        b.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(a.elapsed_time(b))
    print(json.dumps({
        "card": card(), "device": torch.cuda.get_device_name(0), "size": args.size,
        "keypoints": args.keypoints, "checkpoint": args.checkpoint, "plain": args.plain,
        "step_ms_cuda_events": event_ms, "step_ms_host": wall_ms,
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "counters": kernels.counters(),
    }))


if __name__ == "__main__":
    main()
