"""The training driver: the program's training step, back to back.

Set-up builds one object, the program's ``TrainState`` (the net and its
Adam state) with ``make_train_step``'s step for the configuration's
recipe, and drives it through its first ``checked`` steps, each on a pair
of its own; those steps also build and warm every kernel, and their loss,
their first gradient (read from Adam's first moment after one step) and the
parameters' change over them, and the keypoints each step's forward
produced (read by a forward hook on the net), are what the output check
compares. The same
object then trains on through the window, one step after another with no
synchronisation of the benchmark's own, as ``run_train`` drives it.

Each step takes a pair from the pool and its row of the draws the
benchmark made from the seed (lambda, the keypoint subset, the
augmentation's parameters), handed in through the step's ``lmbda``,
``keypoint_idx`` and ``aug_params``, so the reference can take the same.

Traffic keys: ``pool`` (volumes), ``checked`` (set-up steps the check
follows), ``profiled`` (steps under the profiler at the start of a traced
window).
"""

from __future__ import annotations

import time

from kmbench import counts, inputs, judge, program
from kmbench.clock import Clock
from kmbench.drivers.serve import param_specs, spatial
from kmbench.reference.precision import REFERENCE, exact_fp32
from kmbench.spans import Spans
from kmbench.trace import Profiled


def recipe(cfg):
    """The program's ``Config`` for the configuration's training recipe."""
    from keymorph_tpu_torch.training.config import Config

    return Config(num_keypoints=cfg["num_keypoints"], loss_fn=cfg["loss_fn"],
                  transform_type=cfg["transform_type"],
                  max_train_keypoints=cfg["max_train_keypoints"], kp_layer=cfg["kp_layer"],
                  max_train_tps_lmbda=cfg["max_train_tps_lmbda"], backbone=cfg["backbone"],
                  num_truncated_layers_for_truncatedunet=cfg[
                      "num_truncated_layers_for_truncatedunet"],
                  num_levels_for_unet=cfg["num_levels_for_unet"],
                  img_size=tuple(cfg["img_size"]), batch_size=cfg["batch_size"],
                  lr=cfg["lr"], use_amp=cfg["precision"]["backbone"] == "bf16")


def draws(ctx, pairs: int):
    cfg = ctx.config
    return inputs.train_draws(ctx.seed, pairs, cfg["num_keypoints"], cfg["max_train_keypoints"],
                              cfg["max_train_tps_lmbda"],
                              cfg["max_random_affine_augment_params"], ctx.device)


class Window:
    def __init__(self, ctx):
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        from keymorph_tpu_torch.training import train

        if cfg["batch_size"] != 1 or cfg["loss_fn"] != "mse":
            raise ValueError("the training driver runs batch 1 with the MSE loss")
        size = spatial(cfg)
        t_imported = time.perf_counter()
        net = program.keypoint_net(cfg, inputs.make_weights(ctx.seed, param_specs(cfg), dev), dev)
        net.train()
        config = recipe(cfg)
        state = train.TrainState.create(net, train.make_optimizer(config, net))
        step = train.make_train_step(net, config)
        self.pool = inputs.make_pool(ctx.seed, tr["pool"], size[0], dev)
        order = inputs.PairOrder(ctx.seed, tr["pool"])
        rows = len(order.pairs)
        table = draws(ctx, rows)
        clock = Clock(dev)
        spans = Spans(clock)
        t_built = time.perf_counter()

        def one(i):
            f, m = order(i)
            r = i % rows
            aug = tuple(table[k][r: r + 1] for k in ("scale", "offset", "theta", "shear"))
            with spans("step"):
                return step(state, None, self.pool[f: f + 1], self.pool[m: m + 1], None, None,
                            1.0, lmbda=table["lmbda"][r: r + 1],
                            keypoint_idx=table["keypoint_idx"][r], aug_params=aug)[1]

        names = program.leaf_names(net)
        start = {names[p]: p.detach().clone() for p in net.parameters()}
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        losses, points = [], []
        # the keypoints each checked step's forward produced: (points_f, points_m, weights)
        hook = net.register_forward_hook(
            lambda module, args, out: points.append((out[0].detach().clone(),
                                                     out[1].detach().clone())))
        for i in range(tr["checked"]):
            losses.append(one(i)["loss"])
            if i == 0:
                grad_norms = {names[p]: float((state.optimizer.state[p]["exp_avg"]
                                               / (1.0 - beta1)).norm())
                              for p in net.parameters()}
        hook.remove()
        change_norms = {names[p]: float((p.detach() - start[names[p]]).norm())
                        for p in net.parameters()}
        del start
        self.answers = {"keypoints": points, "losses": [float(x) for x in losses],
                        "grad_norms": grad_norms, "change_norms": change_norms}
        clock.sync()
        setup_s = time.perf_counter() - ctx.t_start
        setup_parts = {"imports": t_imported - ctx.t_start, "inputs": t_built - t_imported,
                       "checked_steps": ctx.t_start + setup_s - t_built}

        n, paused = 0, 0.0
        prof = Profiled(ctx.trace and tr["profiled"] > 0, clock)
        spans.on = ctx.trace
        t0 = time.perf_counter()
        while time.perf_counter() - t0 - paused < ctx.seconds:
            if n == 0:  # starting the profiler is not the window's work
                t = time.perf_counter()
                prof.__enter__()
                paused += time.perf_counter() - t
            one(tr["checked"] + n)
            n += 1
            if n == tr["profiled"]:
                t = time.perf_counter()
                prof.__exit__(None, None, None)
                paused += time.perf_counter() - t
        clock.sync()
        window_s = time.perf_counter() - t0 - paused
        if n < tr["profiled"]:
            prof.__exit__(None, None, None)

        self.state = state
        self.attempted, self.failed = n, 0
        plan, _, _ = counts.conv_plan(size, cfg["f_maps"], cfg["num_levels_for_unet"],
                                      cfg["num_truncated_layers_for_truncatedunet"])
        fwd = sum(counts.bound_s(counts.conv_flops(c), counts.conv_bytes(c)) for c in plan)
        grad = sum(counts.bound_s(counts.conv_flops(c), counts.conv_input_grad_bytes(c))
                   for c in plan)
        self.data = {
            "unit": "step", "units": n, "window_s": window_s, "setup_s": setup_s,
            "setup_parts_s": setup_parts,
            "spans": spans.milliseconds(), "profile": prof.reading,
            "profiled_units": min(n, tr["profiled"]),
            "flops_per_unit": counts.train_step_flops(
                size, cfg["num_keypoints"], cfg["f_maps"], cfg["num_levels_for_unet"],
                cfg["num_truncated_layers_for_truncatedunet"], cfg["max_train_keypoints"]),
            # both volumes: the forward, its recomputation in the backward, the input gradient
            "conv_calls_per_unit": 6 * len(plan), "conv_bound_s_per_unit": 2 * (2 * fwd + grad),
        }

    def release(self):
        """Drop the program's state: the net, Adam's state and the pool."""
        self.state = self.pool = None


def run(ctx) -> Window:
    return Window(ctx)


def judge_window(ctx, answers) -> dict:
    """The output check's numbers: the reference's first steps from the
    inputs drawn anew."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    exact_fp32()
    weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
    pool = inputs.make_pool(ctx.seed, tr["pool"], spatial(cfg)[0], dev)
    order = inputs.PairOrder(ctx.seed, tr["pool"])
    steps = len(answers["losses"])
    pairs = [(pool[f: f + 1], pool[m: m + 1]) for f, m in map(order, range(steps))]
    table = {k: v[:steps] for k, v in draws(ctx, len(order.pairs)).items()}
    return judge.train_numbers(answers, weights, pairs, table, cfg, REFERENCE)
