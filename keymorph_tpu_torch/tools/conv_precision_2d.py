"""How far the 2D pipeline's fp32 routes lie from float64, on the card.

The fp32 UNet2D of ``build_model(Config(dim=2, backbone="unet"))`` (f_maps
64, 4 levels, 128 keypoints) on a batch of Gaussian-blob images at 256^2,
three ways: the card with cuDNN (what the port runs), the card with cuDNN
off (PyTorch's own convolutions), and the CPU; each against the same net in
float64 on the card. Prints, one JSON line each:

  * the heatmaps' distance from float64 (x their largest value), the time of
    a second forward (host clock after a synchronize) and the peak memory;
  * with ``--steps``: one 2D training step (MSE, 64 of 128 keypoints,
    augmentation (0.1, 0.1, 0.3, 0.05)) as affine and as TPS, with lambda
    drawn loguniform (down to 1e-6) and with lambda 0.5: the loss's,
    grad_norm's and whole gradient's distance from the float64 step (the
    backbone in float64; the fit, grid and warp fp32 in the port) for each
    route.

Usage (one CUDA card, TF32 off)::

    python -m keymorph_tpu_torch.tools.conv_precision_2d [--batch 8] [--steps]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time


def _blobs(torch, gen, n, size, device):
    """``n`` images (n, 1, size, size): a few Gaussian blobs plus 0.2 x
    uniform noise, drawn from ``gen``."""
    axes = torch.linspace(-1, 1, size, device=device)
    out = torch.zeros((n, 1, size, size), device=device)
    for i in range(n):
        c = torch.rand((3, 2), generator=gen, device=device) * 1.2 - 0.6
        w = torch.rand((3,), generator=gen, device=device) * 0.09 + 0.03
        for (cy, cx), wd in zip(c, w):
            out[i, 0] += (torch.exp(-(axes - cy) ** 2 / wd)[:, None]
                          * torch.exp(-(axes - cx) ** 2 / wd)[None, :])
    noise = torch.rand(out.shape, generator=gen, device=device)
    return out.clamp(max=1.0) + 0.2 * noise


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8, help="image pairs")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", action="store_true", help="also the training steps")
    args = p.parse_args(argv)

    import torch

    from keymorph_tpu_torch import augment, disable_tf32, resolve_device
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet, sample_tps_lmbda
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import Config, build_backbone
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer, make_train_step

    dev = resolve_device(None)
    disable_tf32()
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f, m = (_blobs(torch, gen, args.batch, args.size, dev) for _ in range(2))
    config = Config(dim=2, backbone="unet", num_keypoints=128, loss_fn="mse",
                    max_train_keypoints=64, max_random_affine_augment_params=(0.1, 0.1, 0.3, 0.05),
                    seed=args.seed)
    routes = (("card", dev, True), ("card without cuDNN", dev, False), ("cpu", cpu, True))

    def sync():
        torch.cuda.synchronize(dev)

    bb = init_weights(build_backbone(config), torch.Generator().manual_seed(args.seed))
    bb64 = build_backbone(config, dtype=torch.float64).to(dev)
    bb64.load_state_dict(bb.state_dict())
    x = torch.cat([f, m])
    with torch.no_grad():
        ref = bb64(x.double()).cpu()
        top = ref.abs().max().item()
        for label, where, cudnn in routes:
            net = bb.to(where)
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                net(x.to(where))
                sync()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                out = net(x.to(where))
                sync()
                wall = time.perf_counter() - t0
            print(json.dumps({
                "heatmaps": label, "images": int(x.shape[0]), "size": args.size,
                "from_float64_x_max": (out.cpu().double() - ref).abs().max().item() / top,
                "forward_s": wall,
                "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if where == dev else None),
                "device": torch.cuda.get_device_name(dev)}))
    del bb64, ref
    torch.cuda.empty_cache()
    if not args.steps:
        return

    B = args.batch
    draws = torch.Generator(device=dev).manual_seed(args.seed + 1)
    aug = augment.sample_affine_params(draws, B, 2, config.max_random_affine_augment_params,
                                       1.0, device=dev)
    idx = torch.randperm(config.num_keypoints, generator=draws, device=dev)[:64]
    cases = [("affine", None),
             ("tps_loguniform", sample_tps_lmbda(draws, B, "loguniform", 10.0, device=dev)),
             ("tps_loguniform", torch.full((B,), 0.5, device=dev))]
    for transform_type, lmbda in cases:
        cfg = dataclasses.replace(config, transform_type=transform_type)
        init = {f"backbone.{k}": v for k, v in init_weights(
            build_backbone(cfg), torch.Generator().manual_seed(args.seed + 2)).state_dict().items()}

        def step(where, dtype=torch.float32, cudnn=True):
            net = KeyMorphNet(build_backbone(cfg, dtype=dtype), cfg.num_keypoints, dim=2).to(where)
            net.load_state_dict(init)
            state = TrainState.create(net, make_optimizer(cfg, net))
            mv = (lambda v: None if v is None else v.to(where))
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                _, out = make_train_step(net, cfg)(
                    state, None, f.to(where, dtype), m.to(where, dtype), None, None, 1.0,
                    lmbda=mv(lmbda), keypoint_idx=mv(idx) if lmbda is not None else None,
                    aug_params=[mv(a) for a in aug])
            grads = {k: q.grad.double().cpu() for k, q in net.named_parameters()}
            return float(out["loss"]), float(out["grad_norm"]), grads

        loss64, gn64, g64 = step(dev, torch.float64, False)
        whole = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
        for label, where, cudnn in routes:
            loss, gn, grads = step(where, cudnn=cudnn)
            dg = math.sqrt(sum(float(((grads[k] - g64[k]) ** 2).sum()) for k in g64)) / whole
            print(json.dumps({
                "step": transform_type, "route": label,
                "lmbda": None if lmbda is None else [round(v, 8) for v in lmbda.tolist()],
                "loss_from_float64": abs(loss - loss64) / abs(loss64),
                "grad_norm_from_float64": abs(gn - gn64) / gn64,
                "whole_gradient_from_float64": dg}))


if __name__ == "__main__":
    main()
