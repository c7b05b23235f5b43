"""The training driver for a residual keypoint net (ResidualUNetSE3D, or
ResidualUNet3D without the gate): the program's training step back to back,
driven exactly as ``drivers/train.py`` drives the DoubleConv net.

It runs a private copy of ``drivers/train.py`` (loaded anew from its file, so
the copy the registry hands other cells is untouched) whose names for the
extractor are this net's: ``program.keypoint_net`` builds the program's
``KeyMorphNet`` over its bf16 residual U-Net (``serve_resunet.keypoint_net``),
``param_specs`` lists its published parameters and ``counts`` is
``counts/resunet_train.py``. The step (``recipe()``, ``make_train_step``), the
checked steps, the spans, the window and the ``data`` keys are train.py's own;
this driver adds the plans of the transposed convs' and the gates' backward
kernels to ``data`` (``tconv_bwd_calls_per_unit``,
``tconv_bwd_bound_s_per_unit``, ``gate_bwd_calls_per_unit``,
``gate_bwd_bound_s_per_unit``) for their roofline readers.

Before anything is built it asks the program to route a grad-enabled
``KeyMorphNet.features`` of a small net of this family to its kernel executor
(the executor's plain versions count their calls on the CPU): a program that
trains the residual nets through their modules fails here, at once.

The output check is ``judge.compare_steps``' numbers against
``reference/train_resunet.py`` following the program's keypoints, and the
first step's keypoints, both sets, against the reference's extraction from the
same weights and volumes: ``keypoints`` (the largest gap of any keypoint) and
``keypoints.median`` (the larger set's median keypoint gap; a keypoint's gap:
its largest coordinate's), read as in the residual serving cell. Run as a
module, it prints the control's numbers (the reference with fp8 conv operands
and TF32 products in the program's place) and the planted faults' (the
reference in the program's place with each step's loss over half of the
voxels, or one moving keypoint moved by one voxel) for the limits
(``calibrate.py`` reads the program's):

    python3 -m kmbench.drivers.train_resunet --workload train-resunetse-tps --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from kmbench import calibrate, inputs, judge, program, registry
from kmbench.counts import resunet_train as counts
from kmbench.drivers import serve_resunet
from kmbench.drivers.serve_resunet import param_specs, spatial
from kmbench.reference import train_resunet
from kmbench.reference.precision import CONTROL, REFERENCE, exact_fp32

TRAIN = Path(__file__).with_name("train.py")


def check_route(cfg):
    """Raise unless the program routes a grad-enabled ``features`` of a small
    bf16 net of this family to its kernel executor."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import ResidualUNet3D, ResidualUNetSE3D
    from keymorph_tpu_torch.ops import cuda as kernels

    cls = ResidualUNetSE3D if cfg["backbone"] == "residualunetse" else ResidualUNet3D
    net = cls(4, num_levels=2, f_maps=4, layer_order=cfg["layer_order"],
              num_groups=cfg["num_groups"], dtype=torch.bfloat16)
    kernels.reset_counters()
    with torch.enable_grad():
        KeyMorphNet(net, 4).features(torch.zeros((1, 1, 8, 8, 8)))
    if not kernels.counters()["conv3x3_fused_flat_res"]["plain_calls"]:
        raise ValueError("the program trains the residual U-Nets through their modules, not on "
                         "its kernels")


def run(ctx):
    check_route(ctx.config)
    train = registry.load(TRAIN)
    train.program = SimpleNamespace(keypoint_net=serve_resunet.keypoint_net,
                                    leaf_names=program.leaf_names)
    train.param_specs = param_specs
    train.spatial = spatial
    train.counts = counts
    window = train.Window(ctx)
    cfg = ctx.config
    size, f, levels = spatial(cfg), cfg["f_maps"], cfg["num_levels_for_unet"]
    tconvs = counts.tconv_plan(size, f, levels)
    gates = counts.gate_plan(size, f, levels) if cfg["backbone"] == "residualunetse" else []
    window.data.update(
        # both volumes; a transposed conv's backward launches its input
        # gradient, its weight gradient and the sum of the latter's splits
        tconv_bwd_calls_per_unit=2 * 3 * len(tconvs),
        tconv_bwd_bound_s_per_unit=2 * sum(counts.tconv_bwd_bound_s(t) for t in tconvs),
        gate_bwd_calls_per_unit=2 * len(gates),
        gate_bwd_bound_s_per_unit=2 * sum(
            counts.bound_s(counts.gate_bwd_flops(g), counts.gate_bwd_bytes(g)) for g in gates))
    return window


def _inputs(ctx, steps):
    from kmbench.drivers.train import draws

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
    pool = inputs.make_pool(ctx.seed, tr["pool"], spatial(cfg)[0], dev)
    order = inputs.PairOrder(ctx.seed, tr["pool"])
    pairs = [(pool[f: f + 1], pool[m: m + 1]) for f, m in map(order, range(steps))]
    table = {k: v[:steps] for k, v in draws(ctx, len(order.pairs)).items()}
    return weights, pairs, table


def train_numbers(answers, weights, pairs, draws, cfg, prec) -> dict:
    """The output check's numbers (see the module docstring) of ``answers``
    (the training driver's) against the reference at ``prec``."""
    steps = len(answers["losses"])
    losses, first, after, points = train_resunet.run(
        weights, pairs, draws, cfg["lr"], steps, cfg["num_levels_for_unet"], prec,
        forced=answers["keypoints"])
    reference = {"losses": losses, "grad_norms": {k: float(g.norm()) for k, g in first.items()},
                 "change_norms": {k: float((after[k] - weights[k]).norm()) for k in weights}}
    del first, after
    gaps = {"keypoints": 0.0, "keypoints.median": 0.0}
    for kp, ref in zip(answers["keypoints"][0], points[0]):
        d = (kp.to(ref.device).float() - ref).abs().amax(dim=-1)  # (1, K)
        gaps["keypoints"] = max(gaps["keypoints"], judge._number(d.max()))
        gaps["keypoints.median"] = max(gaps["keypoints.median"], judge._number(d.median()))
    return dict(gaps, **judge.compare_steps(answers, reference))


def judge_window(ctx, answers) -> dict:
    """The output check's numbers: the reference's first steps from the
    inputs drawn anew."""
    exact_fp32()
    weights, pairs, table = _inputs(ctx, len(answers["losses"]))
    return train_numbers(answers, weights, pairs, table, ctx.config, REFERENCE)


def control_numbers(ctx, prec=CONTROL, fault=None) -> dict:
    """The judge's numbers for the reference's first steps at ``prec`` in the
    program's place (``calibrate.train_control`` with this extractor);
    ``fault="half"`` takes each step's loss over half of the voxels,
    ``fault="keypoint"`` moves one moving keypoint by one voxel of the
    heatmaps in each step."""
    cfg = ctx.config
    exact_fp32()
    weights, pairs, table = _inputs(ctx, ctx.traffic["checked"])
    module = train_resunet.step_module()
    if fault == "half":
        module.mse = calibrate.half_mse
    if fault == "keypoint":
        step = 2.0 / spatial(cfg)[0]
        calls = []

        def moved(*a, **k):
            out = train_resunet.keypoints(*a, **k)
            calls.append(1)
            if len(calls) % 2 == 0:  # the moving volume's
                out = out.clone()
                out[0, 0, 0] += step
            return out

        module.unet = SimpleNamespace(keypoints=moved)
    losses, first, after, points = train_resunet.run(
        weights, pairs, table, cfg["lr"], len(pairs), cfg["num_levels_for_unet"], prec,
        module=module)
    answers = {"keypoints": points, "losses": losses,
               "grad_norms": {k: float(g.norm()) for k, g in first.items()},
               "change_norms": {k: float((after[k] - weights[k]).norm()) for k in weights}}
    del first, after
    return train_numbers(answers, weights, pairs, table, cfg, REFERENCE)


def main(argv=None) -> int:
    from kmbench import run as runner

    p = argparse.ArgumentParser(description="the control's and the faults' numbers for a "
                                            "residual training cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = registry.Cell(args.workload)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        ctx = runner.Context(args.workload, cell.config, cell.traffic, seed, 0.0, False, dev, 0.0)
        for who, prec, fault in (("control", CONTROL, None), ("fault:half", REFERENCE, "half"),
                                 ("fault:keypoint", REFERENCE, "keypoint")):
            print(json.dumps({"workload": args.workload, "who": who, "seed": seed,
                              "numbers": control_numbers(ctx, prec, fault)}), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
