"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version beside it for CPU tensors. Every wrapper counts its
kernel launches in ``fn.launches`` and every plain version its calls in
``fn.calls``, so a run can show which path it took.
"""

from __future__ import annotations


def _functions():
    from keymorph_tpu_torch.ops.cuda import conv3d, heatmap, resample3d, resblock, tpsflow

    kernels = {
        "conv3x3_fused_flat": conv3d.conv3x3_fused_flat,
        "conv3x3_fused_flat_parts": conv3d.conv3x3_fused_flat_parts,
        "conv3x3_fused_flat_upconv": conv3d.conv3x3_fused_flat_upconv,
        "conv3x3_input_grad": conv3d.conv3x3_input_grad,
        "conv3x3_weight_grad": conv3d.conv3x3_weight_grad,
        "conv3x3_fused_flat_res": conv3d.conv3x3_fused_flat_res,
        "conv_transpose3x3s2_flat": conv3d.conv_transpose3x3s2_flat,
        "conv_transpose3x3s2_input_grad": conv3d.conv_transpose3x3s2_input_grad,
        "conv_transpose3x3s2_weight_grad": conv3d.conv_transpose3x3s2_weight_grad,
        "scse_gate_flat": resblock.scse_gate_flat,
        "scse_gate_bwd": resblock.scse_gate_bwd,
        "lift1x1_flat": resblock.lift1x1_flat,
        "maxpool2_flat": resblock.maxpool2_flat,
        "heatmap_com": heatmap.heatmap_com,
        "final_conv1x1": heatmap.final_conv1x1,
        "tps_planes": tpsflow.tps_planes,
        "tps_planes_bwd": tpsflow.tps_planes_bwd,
        "tps_flow": tpsflow.tps_flow,
        "warp_planes": resample3d.warp_planes,
        "warp_planes_grad": resample3d.warp_planes_grad,
    }
    plains = {
        "conv3x3_fused_flat": conv3d.conv3x3_fused_flat_plain,
        "conv3x3_fused_flat_parts": conv3d.conv3x3_fused_flat_parts_plain,
        "conv3x3_fused_flat_upconv": conv3d.conv3x3_fused_flat_upconv_plain,
        "conv3x3_input_grad": conv3d.conv3x3_input_grad_plain,
        "conv3x3_weight_grad": conv3d._weight_grad_plain,
        "conv3x3_fused_flat_res": conv3d.conv3x3_fused_flat_res_plain,
        "conv_transpose3x3s2_flat": conv3d.conv_transpose3x3s2_flat_plain,
        "conv_transpose3x3s2_input_grad": conv3d.conv_transpose3x3s2_input_grad_plain,
        "conv_transpose3x3s2_weight_grad": conv3d._tconv_weight_grad_plain,
        "scse_gate_flat": resblock.scse_gate_flat_plain,
        "scse_gate_bwd": resblock.scse_gate_bwd_plain,
        "lift1x1_flat": resblock.lift1x1_flat_plain,
        "maxpool2_flat": resblock.maxpool2_flat_plain,
        "heatmap_com": heatmap.heatmap_com_plain,
        "final_conv1x1": heatmap.final_conv1x1_plain,
        "tps_planes": tpsflow.tps_planes_plain,
        "tps_planes_bwd": tpsflow.tps_planes_bwd_plain,
        "tps_flow": tpsflow.tps_flow_plain,
        "warp_planes": resample3d.warp_planes_plain,
        "warp_planes_grad": resample3d.warp_planes_grad_plain,
    }
    return kernels, plains


def reset_counters() -> None:
    """Set every launch and plain-call counter to 0."""
    kernels, plains = _functions()
    for f in kernels.values():
        f.launches = 0
    for f in plains.values():
        f.calls = 0


def counters() -> dict:
    """{name: {"launches": kernel launches, "plain_calls": plain calls}}."""
    kernels, plains = _functions()
    return {
        name: {"launches": kernels[name].launches, "plain_calls": plains[name].calls}
        for name in kernels
    }
