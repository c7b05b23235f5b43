"""The comparison that decides ``correct``.

Serving: every request's keypoints against the reference's keypoints of
the same pool volumes, from the inputs alone; for a sample of requests
drawn from the seed, each transform's planes against the reference's fit
and flow of the program's own keypoints, and each warped volume against
the reference's warp of the moving volume by the program's own planes.
The planes and the warp are judged stage by stage, on what the program
handed on: an untrained net's keypoints cluster, so the fits amplify a
keypoint gap far past what the flow or the warp could add themselves.

Training: the reference takes the first steps from the same weights, pairs
and draws. Each step's keypoints are compared with the reference's
extraction from the same inputs; the fit, flow, warp, loss, backward and
update are judged stage by stage as serving's are, on the keypoints the
program's step produced (read by a forward hook on the net the benchmark
built): the reference's loss takes their values and its gradient flows
through its own extractor. Each step's loss, each leaf's first gradient
and each leaf's change over the steps are compared by their norms. An
untrained net's keypoints carry a gap of rounding (bf16 flips propagate
through the U-Net), and a TPS fit at a small lambda amplifies such a gap
into the loss and the gradient as much as any fault would: an independent
reference's steps read as far from the reference nudged by half a bf16 ulp
as from the program.

Each number is the largest gap found; it passes where it is at most its
limit (``limits/<cell>.json``). A number without a limit is printed and
not held. Nothing here imports the program.
"""

from __future__ import annotations

import statistics

import torch

from kmbench.reference import geometry, train, unet
from kmbench.reference.precision import Precision

# A leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by rounding alone: its change is not compared.
STILL_LEAF = 1e-3


def serve_numbers(answers, weights, pool, cfg, prec: Precision) -> dict:
    """{keypoints, planes.<transform> for each transform, warped}: the
    largest absolute gaps. Each transform's planes have a number of their
    own: a fit's conditioning, and so the rounding its flow carries,
    differs by transform (lambda 0 interpolates clustered keypoints).

    ``answers``: ``keypoints`` {pool index: [(1, K, 3) tensors]} of every
    request; ``kept`` [(fixed index, moving index, points_f, points_m,
    [(transform, planes, warped)])] of the sampled requests (any device)."""
    dev = pool.device
    levels, trunc = cfg["num_levels_for_unet"], cfg["num_truncated_layers_for_truncatedunet"]
    gaps = {"keypoints": 0.0}
    for index, seen in answers["keypoints"].items():
        ref = unet.keypoints(weights, pool[index: index + 1], levels, trunc, prec)
        for kp in seen:
            gaps["keypoints"] = max(gaps["keypoints"], _gap(kp, ref))
        del ref
    spatial = tuple(pool.shape[2:])
    for _, m, pf, pm, outs in answers["kept"]:
        pf, pm = pf.to(dev).float(), pm.to(dev).float()
        for transform, planes, warped in outs:
            key = f"planes.{transform}"
            ref = geometry.flow(transform, pf, pm, spatial, prec)
            gaps[key] = max(gaps.get(key, 0.0), _gap(planes, ref))
            del ref
            ref = geometry.warp(pool[m: m + 1], planes.to(dev), prec)
            gaps["warped"] = max(gaps.get("warped", 0.0), _gap(warped, ref))
            del ref
    return gaps


def _gap(a, b) -> float:
    return _number((a.to(b.device).float() - b).abs().max())


def _number(x) -> float:
    """A gap as a float; NaN (a broken answer) reads as infinite."""
    x = float(x)
    return x if x == x else float("inf")


def train_numbers(answers, weights, pairs, draws, cfg, prec: Precision) -> dict:
    """The first steps' gaps: ``keypoints`` (the largest absolute gap of the
    first step's keypoints, both sets, against the reference's extraction
    from the same inputs and weights; later steps' parameters have moved
    apart by the update's rounding); relative gaps of the
    reference following the program's keypoints (``train.run``'s
    ``forced``): ``loss`` (the largest over the steps) and ``loss.step1``,
    ``grad_norm`` (the worst leaf's first gradient) and ``grad_norm.median``
    (the median leaf's), ``param_change`` (the worst leaf's change over the
    steps) and ``param_change.median``.

    ``answers``: ``keypoints`` [(points_f, points_m)] and ``losses``
    [float] of the first steps, ``grad_norms`` {leaf: norm of the first
    step's gradient}, ``change_norms`` {leaf: norm of the change over the
    steps}. A leaf's gap is |program - reference| over the larger of the
    reference's norm of that leaf and of the median leaf. Leaves whose
    reference gradient is under ``STILL_LEAF`` of the median leaf's are
    left out of the change."""
    steps = len(answers["losses"])
    losses, first, after, points = train.run(
        weights, pairs, draws, cfg["lr"], steps, cfg["num_levels_for_unet"],
        cfg["num_truncated_layers_for_truncatedunet"], prec, forced=answers["keypoints"])
    reference = {"losses": losses, "grad_norms": {k: float(g.norm()) for k, g in first.items()},
                 "change_norms": {k: float((after[k] - weights[k]).norm()) for k in weights}}
    del first, after
    gap = max(_gap(p, r) for p, r in zip(answers["keypoints"][0], points[0]))
    return dict(keypoints=gap, **compare_steps(answers, reference))


def nudge(weights, generator):
    """A copy of ``weights`` whose conv weights are moved by up to half a
    bf16 ulp each (uniformly): about half of their bf16 roundings move to
    the neighbouring value, as another sound bf16 implementation's
    rounding would move the activations (the yardstick of rounding)."""
    moved = {}
    for k, v in weights.items():
        if v.dim() == 5:
            ulp = 2.0 ** (torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)
            v = v + (torch.rand(v.shape, generator=generator, device=v.device) - 0.5) * ulp
        moved[k] = v
    return moved


def compare_steps(program, reference) -> dict:
    """:func:`train_numbers`'s numbers from both sides' readings."""
    ref_grad, ref_change = reference["grad_norms"], reference["change_norms"]
    moving = {k for k, n in ref_grad.items()
              if n >= STILL_LEAF * statistics.median(ref_grad.values())}
    losses = [_number(abs(a - b) / abs(b))
              for a, b in zip(program["losses"], reference["losses"])]
    grad = leaf_gaps(program["grad_norms"], ref_grad).values()
    change = leaf_gaps(program["change_norms"], ref_change, moving).values()
    return {"loss": max(losses), "loss.step1": losses[0],
            "grad_norm": max(grad), "grad_norm.median": statistics.median(grad),
            "param_change": max(change), "param_change.median": statistics.median(change)}


def leaf_gaps(program, reference, leaves=None) -> dict:
    """{leaf: |program - reference| over the larger of the reference's norm
    of the leaf and of the median leaf}, over ``leaves`` (all by default)."""
    floor = statistics.median(reference.values())
    keys = reference if leaves is None else leaves
    return {k: _number(abs(program[k] - reference[k]) / max(reference[k], floor)) for k in keys}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit or None)]): correct where every number
    with a limit is within it."""
    rows = [(name, value, limits.get(name)) for name, value in numbers.items()]
    return all(lim is None or value <= lim for _, value, lim in rows), rows
