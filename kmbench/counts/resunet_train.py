"""Operation and byte counts of ResidualUNetSE3D's training step (useful
operations from the architecture, not what a kernel executes), with the
functions of ``kmbench.counts`` that the training driver calls, under the same
names and signatures, and the plans of the backward's own kernels.

The 3x3x3 convs are ``counts/resunet.py``'s plan, taken as it is: in the
step each runs forward, again in its backward (the recomputation: every one
has a ReLU) and as its input gradient (every conv's input needs one: the
first reads the first lift's output), for both volumes. A transposed conv's
backward is its input gradient and its weight gradient, each of the forward's
useful operations (2 x 27 x Cin x Cout x V/8); a gate's backward is one pass
bound by bytes (the block output and the cotangent read once, the input
gradient written once).
"""

from __future__ import annotations

from math import prod

# bound_s, conv_flops, conv_input_grad_bytes are the training driver's, as
# kmbench.counts gives them; conv_plan and conv_bytes are the residual net's
from kmbench.counts import (BF16_BYTES, FP32_BYTES, bound_s, conv_flops,  # noqa: F401
                            conv_input_grad_bytes, tps_flow_flops, tps_solve_flops, warp_flops)
from kmbench.counts.resunet import (conv_bytes, conv_plan, extract_flops, gate_flops,  # noqa: F401
                                    gate_plan, head_flops, lift_flops, tconv_flops, tconv_plan)


def tconv_dgrad_bytes(t) -> float:
    """The cotangent read once at full resolution, the bf16 weights once,
    the input gradient written once at half resolution."""
    return (t["cout"] * t["vox"] + 27.0 * t["cin"] * t["cout"]
            + t["cin"] * t["vox"] / 8.0) * BF16_BYTES


def tconv_wgrad_bytes(t) -> float:
    """The input read once at half resolution and the cotangent once, the
    fp32 weight gradient written once."""
    return ((t["cin"] * t["vox"] / 8.0 + t["cout"] * t["vox"]) * BF16_BYTES
            + 27.0 * t["cin"] * t["cout"] * FP32_BYTES)


def tconv_bwd_bound_s(t) -> float:
    """The least time of one transposed conv's backward: its input gradient
    and its weight gradient, each of the forward's useful operations."""
    return (bound_s(tconv_flops(t), tconv_dgrad_bytes(t))
            + bound_s(tconv_flops(t), tconv_wgrad_bytes(t)))


def gate_bwd_bytes(g) -> float:
    """The block output and the cotangent read once, the input gradient
    written once."""
    return 3.0 * g["c"] * g["vox"] * BF16_BYTES


def gate_bwd_flops(g) -> float:
    """Per value: the gated products again (2), the winner's terms of the
    three sums (6) and of the input gradient (5)."""
    return 13.0 * g["c"] * g["vox"]


def train_step_flops(spatial, keypoints, f_maps, num_levels, num_truncated,
                     train_keypoints) -> float:
    """Useful FLOPs of one training step (no recomputation): the forward of
    both extractions; their backward (the input and weight gradients of every
    conv, transposed conv, lift and the head, each the forward's operations,
    but the first lift's input gradient; the gates' backward); the fit, the
    spline forward and its gradient (twice the forward), the warp and its
    gradient to the planes (twice the forward), and the augmentation's warp
    (``counts.train_step_flops``'s geometry)."""
    fwd = extract_flops(spatial, keypoints, f_maps, num_levels, num_truncated)
    plan, cin, vox = conv_plan(spatial, f_maps, num_levels, num_truncated)
    gates = gate_plan(spatial, f_maps, num_levels)
    dense = (sum(conv_flops(c) for c in plan) + lift_flops(spatial, f_maps, num_levels)
             + sum(tconv_flops(t) for t in tconv_plan(spatial, f_maps, num_levels))
             + head_flops(cin, keypoints, vox))
    first_lift = 2.0 * f_maps * prod(spatial)  # its input, the volume, needs no gradient
    bwd = 2.0 * dense - first_lift + sum(gate_bwd_flops(g) for g in gates)
    n = prod(spatial)
    geo = (tps_solve_flops(train_keypoints) + 3.0 * tps_flow_flops(n, train_keypoints)
           + 3.0 * warp_flops(n) + warp_flops(n))
    return 2.0 * (fwd + bwd) + geo
