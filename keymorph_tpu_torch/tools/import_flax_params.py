"""Carry keymorph_tpu (flax) KeyMorphNet parameters into the port.

The inverse of ``keymorph_tpu/tools/import_torch_weights.py:_map_unet_keys``
for the DoubleConv 'gcr' U-Net: the flax backbone tree

    DoubleConv_i/SingleConv_{0,1}/Conv_0/kernel      (3, 3, 3, I, O)
    DoubleConv_i/SingleConv_{0,1}/GroupNorm_0/{scale, bias}
    Conv_0/{kernel (1, 1, 1, C, K), bias}

becomes the reference unet3d ``state_dict`` the port's modules use
(``encoders.i.basic_module.SingleConv{1,2}.{conv.weight (O, I, 3, 3, 3),
groupnorm.{weight, bias}}``, ``decoders.j...``, ``final_conv.*``).

:func:`load_adam_state` carries an ``optax.adam`` state (``mu``, ``nu``,
``count``) into a ``torch.optim.Adam`` the same way, so that both packages
take the same next step from the same point.

Input leaves are numpy arrays (or anything ``np.asarray`` takes), so this
module needs neither JAX nor flax.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^(?:Checkpoint)?DoubleConv_(\d+)$")


def _blocks(backbone: Mapping) -> Dict[int, Mapping]:
    out = {}
    for name, sub in backbone.items():
        m = _BLOCK.match(name)
        if m:
            out[int(m.group(1))] = sub
        elif name != "Conv_0":
            raise ValueError(f"unsupported backbone parameter group {name!r}")
    return dict(sorted(out.items()))


def _infer_num_levels(blocks: Dict[int, Mapping]) -> int:
    """Encoder widths grow level by level; the first block whose output is
    not wider than its predecessor's is the first decoder."""
    widths = [int(np.shape(b["SingleConv_1"]["Conv_0"]["kernel"])[-1])
              for b in blocks.values()]
    for i in range(1, len(widths)):
        if widths[i] <= widths[i - 1]:
            return i
    return len(widths)


def backbone_state_dict_from_flax(backbone: Mapping) -> Dict[str, torch.Tensor]:
    """flax U-Net parameter tree -> the port's U-Net ``state_dict`` (fp32)."""
    blocks = _blocks(backbone)
    L = _infer_num_levels(blocks)
    sd: Dict[str, torch.Tensor] = {}
    for i, blk in blocks.items():
        prefix = f"encoders.{i}" if i < L else f"decoders.{i - L}"
        for j, sc_name in enumerate(("SingleConv_0", "SingleConv_1")):
            sc = blk[sc_name]
            base = f"{prefix}.basic_module.SingleConv{j + 1}"
            gn = sc["GroupNorm_0"]
            sd[f"{base}.groupnorm.weight"] = np.asarray(gn["scale"])
            sd[f"{base}.groupnorm.bias"] = np.asarray(gn["bias"])
            k = np.asarray(sc["Conv_0"]["kernel"])  # (3, 3, 3, I, O)
            sd[f"{base}.conv.weight"] = np.transpose(k, (4, 3, 0, 1, 2))
    head = backbone["Conv_0"]
    k = np.asarray(head["kernel"])  # (1, 1, 1, C, K)
    sd["final_conv.weight"] = np.transpose(k, (4, 3, 0, 1, 2))
    sd["final_conv.bias"] = np.asarray(head["bias"])
    return {name: torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
            for name, v in sd.items()}


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """keymorph_tpu ``KeyMorphNet`` variables (``{"params": {...}}`` or the
    inner params dict) -> the port's ``KeyMorphNet`` ``state_dict``:
    ``backbone.*`` plus ``scales``/``biases`` when the net weights keypoints
    by variance."""
    p = params["params"] if "params" in params else params
    sd = {f"backbone.{k}": v
          for k, v in backbone_state_dict_from_flax(p["backbone"]).items()}
    for name in ("scales", "biases"):
        if name in p:
            sd[name] = torch.tensor(np.asarray(p[name], dtype=np.float32))
    return sd


def load_adam_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                    mu: Mapping, nu: Mapping, count) -> None:
    """Set ``optimizer``'s Adam moments from an ``optax.adam`` state.

    Args:
        optimizer: a ``torch.optim.Adam`` over ``net``'s parameters.
        net: the port's ``KeyMorphNet``.
        mu, nu: optax's first and second moments, numpy trees shaped like the
            flax parameters (``ScaleByAdamState.mu`` / ``.nu``).
        count: optax's step count (``ScaleByAdamState.count``).
    """
    first, second = state_dict_from_flax(mu), state_dict_from_flax(nu)
    for name, p in net.named_parameters():
        if name not in first:
            raise KeyError(f"no Adam moments for parameter {name!r}")
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": first[name].to(device=p.device, dtype=p.dtype).reshape(p.shape),
            "exp_avg_sq": second[name].to(device=p.device, dtype=p.dtype).reshape(p.shape),
        }
