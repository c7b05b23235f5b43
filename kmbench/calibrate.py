"""Readings that the limits of a cell's output check are set from.

    python3 -m kmbench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

In one process (the kernels are built once): for each of ``--seeds`` a
short run of the cell (its numbers are the lower readings: sound runs of
the program); for each of ``--control-seeds`` the control, the reference
one precision step below the configuration's (``precision.CONTROL``: fp8
conv operands, TF32 products) put in the program's place and judged by the
same comparison; for a training cell and each of ``--fault-seeds`` the
planted faults, in the reference put in the program's place: ``half``
(each step's loss over half of the voxels) and ``keypoint`` (one moving
keypoint moved by one voxel of the heatmaps). A state left unchanged reads
1 by the training comparison and needs no run. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from kmbench import inputs, judge
from kmbench.reference import geometry, train, unet
from kmbench.reference.precision import CONTROL, REFERENCE, exact_fp32
from kmbench.registry import Cell


def serve_control(ctx, prec):
    """The judge's numbers for the reference at ``prec`` in the program's
    place: the keypoints of every pool volume, and the planes and warped
    volumes of the traffic's ``kept`` first pairs."""
    from kmbench.drivers.serve import param_specs, spatial

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    levels, trunc = cfg["num_levels_for_unet"], cfg["num_truncated_layers_for_truncatedunet"]
    size = spatial(cfg)
    exact_fp32()
    with torch.no_grad():
        weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
        pool = inputs.make_pool(ctx.seed, tr["pool"], size[0], dev)
        points = {i: unet.keypoints(weights, pool[i: i + 1], levels, trunc, prec)
                  for i in range(tr["pool"])}
        order = inputs.PairOrder(ctx.seed, tr["pool"])
        kept = []
        for f, m in map(order, range(tr["kept"])):
            outs = []
            for name in tr["transforms"]:
                planes = geometry.flow(name, points[f], points[m], size, prec)
                outs.append((name, planes.cpu(), geometry.warp(pool[m: m + 1], planes, prec).cpu()))
            kept.append((f, m, points[f].cpu(), points[m].cpu(), outs))
        answers = {"keypoints": {i: [p] for i, p in points.items()}, "kept": kept}
        del weights, pool
        return judge.serve_numbers(answers, inputs.make_weights(ctx.seed, param_specs(cfg), dev),
                                   inputs.make_pool(ctx.seed, tr["pool"], size[0], dev), cfg,
                                   REFERENCE)


def half_mse(a, b):
    """The MSE with half of the voxels left out, the mean taken over the
    rest: a batch of one's form of half of the batch left out."""
    n = a.numel() // 2
    return torch.mean((a.reshape(-1)[:n] - b.reshape(-1)[:n]) ** 2)


def train_control(ctx, prec, fault=None):
    """The judge's numbers for the reference's first steps at ``prec`` in
    the program's place; ``fault="keypoint"`` moves one moving keypoint by
    one voxel of the heatmaps in each of them, ``fault="half"`` takes each
    step's loss over half of the voxels (``half_mse``)."""
    from kmbench.drivers.serve import param_specs, spatial
    from kmbench.drivers.train import draws

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    steps = tr["checked"]
    exact_fp32()
    weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
    pool = inputs.make_pool(ctx.seed, tr["pool"], spatial(cfg)[0], dev)
    order = inputs.PairOrder(ctx.seed, tr["pool"])
    pairs = [(pool[f: f + 1], pool[m: m + 1]) for f, m in map(order, range(steps))]
    table = {k: v[:steps] for k, v in draws(ctx, len(order.pairs)).items()}
    keypoints, mse = unet.keypoints, train.mse
    if fault == "half":
        train.mse = half_mse
    if fault == "keypoint":
        step = 2.0 / (spatial(cfg)[0] // 2 ** cfg["num_truncated_layers_for_truncatedunet"])
        calls = []

        def moved(*a, **k):
            out = keypoints(*a, **k)
            calls.append(1)
            if len(calls) % 2 == 0:  # the moving volume's
                out = out.clone()
                out[0, 0, 0] += step
            return out

        unet.keypoints = moved
    try:
        losses, first, after, points = train.run(
            weights, pairs, table, cfg["lr"], steps, cfg["num_levels_for_unet"],
            cfg["num_truncated_layers_for_truncatedunet"], prec)
    finally:
        unet.keypoints, train.mse = keypoints, mse
    answers = {"keypoints": points, "losses": losses,
               "grad_norms": {k: float(g.norm()) for k, g in first.items()},
               "change_norms": {k: float((after[k] - weights[k]).norm()) for k in weights}}
    del first, after
    return judge.train_numbers(answers, weights, pairs, table, cfg, REFERENCE)


def train_look(ctx):
    """Where the training numbers come from, for one seed: each checked
    step's lambda; the program's numbers against the reference that follows
    its keypoints (the check) with the three leaves of the largest gradient
    gap; and, for the look, an independent reference (taking its own
    keypoints) against the program and against itself nudged by half a bf16
    ulp (``judge.nudge``, the yardstick of rounding)."""
    from keymorph_tpu_torch import disable_tf32

    from kmbench.drivers.serve import param_specs, spatial
    from kmbench.drivers.train import draws

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    disable_tf32()
    window = Cell(ctx.workload).driver().run(ctx)
    answers = window.answers
    window.release()
    del window
    torch.cuda.empty_cache()
    exact_fp32()
    steps = tr["checked"]
    levels, trunc = cfg["num_levels_for_unet"], cfg["num_truncated_layers_for_truncatedunet"]
    weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
    pool = inputs.make_pool(ctx.seed, tr["pool"], spatial(cfg)[0], dev)
    order = inputs.PairOrder(ctx.seed, tr["pool"])
    table = {k: v[:steps] for k, v in draws(ctx, len(order.pairs)).items()}
    pairs = [(pool[f: f + 1], pool[m: m + 1]) for f, m in map(order, range(steps))]

    def side(start, forced=None):
        losses, first, after, _ = train.run(start, pairs, table, cfg["lr"], steps, levels,
                                            trunc, REFERENCE, forced=forced)
        return {"losses": losses, "grad_norms": {k: float(g.norm()) for k, g in first.items()},
                "change_norms": {k: float((after[k] - start[k]).norm()) for k in start}}

    followed = side(weights, answers["keypoints"])
    gaps = judge.leaf_gaps(answers["grad_norms"], followed["grad_norms"])
    alone = side(weights)
    nudged = side(judge.nudge(weights, inputs.generator(ctx.seed, 99, dev)))
    return {"lambda": table["lmbda"].tolist(),
            "check": judge.compare_steps(answers, followed),
            "worst_grad_leaves": sorted(gaps.items(), key=lambda kv: -kv[1])[:3],
            "independent": judge.compare_steps(answers, alone),
            "yardstick": judge.compare_steps(nudged, alone)}


def main(argv=None):
    from kmbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--look-seeds", default="", help="training: train_look's readings")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    run.cache_dirs()
    cell = Cell(args.workload)
    training = cell.traffic["driver"] == "train"

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(who, seed, numbers):
        print(json.dumps({"workload": args.workload, "who": who, "seed": seed,
                          "numbers": numbers}), flush=True)

    for seed in seeds(args.seeds):
        result, _ = run.execute(args.workload, seed, args.seconds, 0)
        emit("program", seed, {k: v["value"] for k, v in result["check"].items()})
    readings = [("control", s) for s in seeds(args.control_seeds)]
    if training:
        readings += [(f"fault:{f}", s) for s in seeds(args.fault_seeds) for f in ("half", "keypoint")]
    for who, seed in readings:
        ctx = run.Context(args.workload, cell.config, cell.traffic, seed, args.seconds, False,
                          torch.device("cuda"), 0.0)
        if not training:
            numbers = serve_control(ctx, CONTROL)
        elif who == "control":
            numbers = train_control(ctx, CONTROL)
        else:
            numbers = train_control(ctx, REFERENCE, who.split(":")[1])
        emit(who, seed, numbers)
        torch.cuda.empty_cache()
    for seed in seeds(args.look_seeds):
        ctx = run.Context(args.workload, cell.config, cell.traffic, seed, args.seconds, False,
                          torch.device("cuda"), 0.0)
        emit("look", seed, train_look(ctx))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
