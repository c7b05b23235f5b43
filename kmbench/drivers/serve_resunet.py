"""The serving driver for a residual keypoint net (ResidualUNetSE3D, or
ResidualUNet3D without the gate): one client in a closed loop, one pair a
request, served exactly as ``drivers/serve.py`` serves the DoubleConv net.

It runs a private copy of ``drivers/serve.py`` (loaded anew from its file,
so the copy the registry hands other cells is untouched) whose three
names for the extractor are this net's: ``program.keypoint_net`` builds the
program's ``KeyMorphNet`` over its bf16 residual U-Net, ``param_specs`` lists
its published parameters and ``counts`` is ``counts/resunet.py``. The
request loop, the spans, the clock, the window, the latency events, the
kept requests and the ``data`` keys are serve.py's own; this driver adds the
plans of the transposed convs and the gates to ``data``
(``tconv_calls_per_unit``, ``tconv_bound_s_per_unit``, ``gate_calls_per_unit``,
``gate_bound_s_per_unit``) for their roofline readers.

The net must be one the program serves on its kernels
(``models.unet.supports_fast_resunet``): a program without that path fails
here, at once, before any request.

The output check is ``judge.serve_numbers``'s with the keypoints of
``reference/resunet_se.py``. Run as a module, it prints the control's
numbers for the limits (``calibrate.py`` reads the program's):

    python3 -m kmbench.drivers.serve_resunet --workload serve-resunetse-tps1 --control-seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from kmbench import inputs, judge, registry
from kmbench.counts import resunet as counts
from kmbench.reference import geometry, resunet_se
from kmbench.reference.precision import CONTROL, REFERENCE, exact_fp32

SERVE = Path(__file__).with_name("serve.py")


def _se(cfg) -> bool:
    return cfg["backbone"] == "residualunetse"


def param_specs(cfg):
    return resunet_se.param_specs(cfg["f_maps"], cfg["num_levels_for_unet"],
                                  cfg["num_keypoints"], se=_se(cfg))


def spatial(cfg):
    return tuple(int(s) for s in cfg["img_size"])


def keypoint_net(cfg: dict, weights: dict, device):
    """The program's ``KeyMorphNet`` over its bf16 residual U-Net, built on
    the meta device, its parameters copied from ``weights`` (the published
    names, without the ``backbone.`` prefix)."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import (ResidualUNet3D, ResidualUNetSE3D,
                                                supports_fast_resunet)

    if cfg["backbone"] not in ("residualunet", "residualunetse") \
            or cfg["precision"]["backbone"] != "bf16":
        raise ValueError("this builds the bf16 residual U-Nets")
    cls = ResidualUNetSE3D if _se(cfg) else ResidualUNet3D
    with torch.device("meta"):
        backbone = cls(cfg["num_keypoints"], num_levels=cfg["num_levels_for_unet"],
                       f_maps=cfg["f_maps"], layer_order=cfg["layer_order"],
                       num_groups=cfg["num_groups"], dtype=torch.bfloat16)
        net = KeyMorphNet(backbone, cfg["num_keypoints"], keypoint_layer=cfg["kp_layer"])
    if not supports_fast_resunet(backbone):
        raise ValueError("the program does not serve this net on its kernels")
    net = net.to_empty(device=device)
    net.load_state_dict({f"backbone.{k}": v for k, v in weights.items()}, strict=True)
    return net


def run(ctx):
    serve = registry.load(SERVE)
    serve.program = SimpleNamespace(keypoint_net=keypoint_net)
    serve.param_specs = param_specs
    serve.counts = counts
    window = serve.Window(ctx)
    cfg = ctx.config
    size, f, levels = spatial(cfg), cfg["f_maps"], cfg["num_levels_for_unet"]
    tconvs = counts.tconv_plan(size, f, levels)
    gates = counts.gate_plan(size, f, levels) if _se(cfg) else []
    window.data.update(
        tconv_calls_per_unit=2 * len(tconvs),
        tconv_bound_s_per_unit=2 * sum(counts.bound_s(counts.tconv_flops(t), counts.tconv_bytes(t))
                                       for t in tconvs),
        gate_calls_per_unit=2 * len(gates),
        gate_bound_s_per_unit=2 * sum(counts.bound_s(counts.gate_flops(g), counts.gate_bytes(g))
                                      for g in gates))
    return window


def serve_numbers(answers, weights, pool, cfg, prec) -> dict:
    """``judge.serve_numbers`` with this extractor: the planes and warped
    volumes of the kept requests as it judges them, the keypoints of every
    request against ``reference/resunet_se.py``'s of the same volumes:
    ``keypoints``, the largest gap of any keypoint, and ``keypoints.median``,
    the largest over the requests of the median keypoint's gap (a keypoint's
    gap: its largest coordinate's). An untrained residual net's heatmaps
    leave a few keypoints with little mass after the ReLU, whose centres
    move far on a rounding flip, so the largest gap of sound runs reaches
    what a lower precision gives; a lower precision moves every keypoint.
    So the cell's limits hold ``keypoints.median`` and leave ``keypoints``
    without a limit: it is reported, and decides nothing."""
    gaps = judge.serve_numbers({"keypoints": {}, "kept": answers["kept"]}, weights, pool, cfg,
                               prec)
    gaps = {"keypoints": gaps.pop("keypoints"), "keypoints.median": 0.0, **gaps}
    for index, seen in answers["keypoints"].items():
        ref = resunet_se.keypoints(weights, pool[index: index + 1], cfg["num_levels_for_unet"],
                                   prec)
        for kp in seen:
            d = (kp.to(ref.device).float() - ref).abs().amax(dim=-1)  # (1, K)
            gaps["keypoints"] = max(gaps["keypoints"], judge._number(d.max()))
            gaps["keypoints.median"] = max(gaps["keypoints.median"], judge._number(d.median()))
        del ref
    return gaps


def judge_window(ctx, answers) -> dict:
    """The output check's numbers, from the inputs drawn anew."""
    cfg, dev = ctx.config, ctx.device
    exact_fp32()
    with torch.no_grad():
        weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
        pool = inputs.make_pool(ctx.seed, ctx.traffic["pool"], spatial(cfg)[0], dev)
        return serve_numbers(answers, weights, pool, cfg, REFERENCE)


def control_numbers(ctx, prec=CONTROL) -> dict:
    """The judge's numbers for the reference at ``prec`` in the program's
    place (``calibrate.serve_control`` with this extractor): the keypoints of
    every pool volume, and the planes and warped volumes of the traffic's
    ``kept`` first pairs."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    size = spatial(cfg)
    exact_fp32()
    with torch.no_grad():
        weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
        pool = inputs.make_pool(ctx.seed, tr["pool"], size[0], dev)
        points = {i: resunet_se.keypoints(weights, pool[i: i + 1], cfg["num_levels_for_unet"],
                                          prec) for i in range(tr["pool"])}
        order = inputs.PairOrder(ctx.seed, tr["pool"])
        kept = []
        for f, m in map(order, range(tr["kept"])):
            outs = []
            for name in tr["transforms"]:
                planes = geometry.flow(name, points[f], points[m], size, prec)
                outs.append((name, planes.cpu(),
                             geometry.warp(pool[m: m + 1], planes, prec).cpu()))
            kept.append((f, m, points[f].cpu(), points[m].cpu(), outs))
        answers = {"keypoints": {i: [p] for i, p in points.items()}, "kept": kept}
        return serve_numbers(answers, weights, pool, cfg, REFERENCE)


def main(argv=None) -> int:
    from kmbench import run as runner

    p = argparse.ArgumentParser(description="the control's numbers for a residual cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", required=True)
    args = p.parse_args(argv)
    cell = registry.Cell(args.workload)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        ctx = runner.Context(args.workload, cell.config, cell.traffic, seed, 0.0, False,
                             torch.device("cuda"), 0.0)
        print(json.dumps({"workload": args.workload, "who": "control", "seed": seed,
                          "numbers": control_numbers(ctx)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
