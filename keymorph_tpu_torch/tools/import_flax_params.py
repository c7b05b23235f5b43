"""Carry keymorph_tpu (flax) KeyMorphNet parameters into the port.

The inverse of ``keymorph_tpu/tools/import_torch_weights.py`` for every
backbone family, 3D and 2D: the flax tree becomes the reference
``state_dict`` the port's modules use. A conv kernel (*k, I, O) becomes the
weight (O, I, *k), whatever its number of window dims (3^3 or, in UNet2D and
the 2D ConvNet, 3^2).

U-Nets (``DoubleConv_i`` or ``ResNetBlock_i``, encoders first, then
decoders; ``Checkpoint`` prefixes accepted)::

    .../SingleConv_{0,1}/Conv_0/{kernel (3,3,3,I,O), bias}
                                     -> ...SingleConv{1,2}.conv.{weight (O,I,3,3,3), bias}
    .../SingleConv_{0,1}/GroupNorm_0/{scale, bias}        -> ....groupnorm.{weight, bias}
    .../SingleConv_{0,1}/StatelessBatchNorm_0/{scale, bias} -> ....batchnorm.{weight, bias}
    ResNetBlock_i/Conv_0 (the 1x1 lift)                   -> basic_module.conv1.*
    ResNetBlock_i/SingleConv_{0,1}                        -> basic_module.conv{2,3}.*
    ResNetBlock_i/ChannelSpatialSE_0/ChannelSE_0/Dense_{0,1}/{kernel (I,O), bias}
                                     -> basic_module.se_module.cSE.fc{1,2}.{weight (O,I), bias}
    ResNetBlock_i/ChannelSpatialSE_0/SpatialSE_0/Conv_0   -> basic_module.se_module.sSE.conv.*
    ConvTranspose_j/{kernel (3,3,3,O,I) (transpose_kernel=True), bias}
                                     -> decoders.j.upsampling.upsample.{weight (I,O,3,3,3), bias}
    Conv_0/{kernel (1,1,1,C,K), bias}                     -> final_conv.*

ConvNet: ``ConvBlock_k/Conv_0`` -> ``block{k+1}.conv``, its
``GroupNorm_0`` or ``StatelessBatchNorm_0`` -> ``block{k+1}.norm``.
KeyMorphNet: ``backbone`` -> ``backbone.*``, ``regressor/Dense_0`` (the
linear head) -> ``regressor.fc``, ``scales``/``biases`` as they are.

SimpleUnet (the brain extractor; no reference names, so the port's):
``Conv_i`` -> ``blocks.i.conv`` (i < 9) and ``Conv_9`` -> ``final_conv``,
``GroupNorm_i`` -> ``blocks.i.norm``. :func:`unflatten_npz` reads the flat
``.npz`` of ``/``-joined names that keymorph_tpu's brain-extraction tool
reads.

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

_BLOCK = re.compile(r"^(?:Checkpoint)?(DoubleConv|ResNetBlock)_(\d+)$")
_CONVBLOCK = re.compile(r"^ConvBlock_(\d+)$")
_NORMS = {"GroupNorm_0": "groupnorm", "StatelessBatchNorm_0": "batchnorm"}


def _conv(sd, base: str, p: Mapping):
    """A flax conv (kernel (*k, I, O)) -> torch ``base.weight`` (O, I, *k)."""
    k = np.asarray(p["kernel"])
    sd[f"{base}.weight"] = np.transpose(k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
    if "bias" in p:
        sd[f"{base}.bias"] = np.asarray(p["bias"])


def _dense(sd, base: str, p: Mapping):
    sd[f"{base}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{base}.bias"] = np.asarray(p["bias"])


def _norm(sd, base: str, p: Mapping):
    sd[f"{base}.weight"] = np.asarray(p["scale"])
    sd[f"{base}.bias"] = np.asarray(p["bias"])


def _single_conv(sd, base: str, sc: Mapping):
    for name, sub in sc.items():
        if name == "Conv_0":
            _conv(sd, f"{base}.conv", sub)
        elif name in _NORMS:
            _norm(sd, f"{base}.{_NORMS[name]}", sub)
        else:
            raise ValueError(f"unsupported SingleConv parameter group {name!r}")


def _unet(backbone: Mapping, sd):
    blocks, kind = {}, None
    for name, sub in backbone.items():
        m = _BLOCK.match(name)
        if m:
            kind = m.group(1)
            blocks[int(m.group(2))] = sub
        elif name != "Conv_0" and not name.startswith("ConvTranspose_"):
            raise ValueError(f"unsupported backbone parameter group {name!r}")
    blocks = dict(sorted(blocks.items()))
    if kind == "ResNetBlock":
        L = len(blocks) - sum(n.startswith("ConvTranspose_") for n in backbone)
    else:
        # encoder widths grow level by level; the first block whose output is
        # not wider than its predecessor's is the first decoder
        widths = [int(np.shape(b["SingleConv_1"]["Conv_0"]["kernel"])[-1])
                  for b in blocks.values()]
        L = next((i for i in range(1, len(widths)) if widths[i] <= widths[i - 1]), len(widths))
    for i, blk in blocks.items():
        base = (f"encoders.{i}" if i < L else f"decoders.{i - L}") + ".basic_module"
        if kind == "DoubleConv":
            for j in range(2):
                _single_conv(sd, f"{base}.SingleConv{j + 1}", blk[f"SingleConv_{j}"])
            continue
        for name, sub in blk.items():
            if name == "Conv_0":
                _conv(sd, f"{base}.conv1", sub)
            elif name in ("SingleConv_0", "SingleConv_1"):
                _single_conv(sd, f"{base}.conv{int(name[-1]) + 2}", sub)
            elif name == "ChannelSpatialSE_0":
                for k in range(2):
                    _dense(sd, f"{base}.se_module.cSE.fc{k + 1}", sub["ChannelSE_0"][f"Dense_{k}"])
                _conv(sd, f"{base}.se_module.sSE.conv", sub["SpatialSE_0"]["Conv_0"])
            else:
                raise ValueError(f"unsupported ResNetBlock parameter group {name!r}")
    for name, sub in backbone.items():
        if name.startswith("ConvTranspose_"):
            # transpose_kernel=True keeps torch's (I, O) in its last two axes
            # as (O, I): (k, k, k, O, I) -> (I, O, k, k, k)
            j = int(name.split("_")[1])
            sd[f"decoders.{j}.upsampling.upsample.weight"] = np.transpose(
                np.asarray(sub["kernel"]), (4, 3, 0, 1, 2))
            sd[f"decoders.{j}.upsampling.upsample.bias"] = np.asarray(sub["bias"])
    _conv(sd, "final_conv", backbone["Conv_0"])


def _convnet(backbone: Mapping, sd):
    for name, blk in backbone.items():
        m = _CONVBLOCK.match(name)
        if not m:
            raise ValueError(f"unsupported ConvNet parameter group {name!r}")
        base = f"block{int(m.group(1)) + 1}"
        for sub_name, sub in blk.items():
            if sub_name == "Conv_0":
                _conv(sd, f"{base}.conv", sub)
            elif sub_name in _NORMS:
                _norm(sd, f"{base}.norm", sub)
            else:
                raise ValueError(f"unsupported ConvBlock parameter group {sub_name!r}")


def backbone_state_dict_from_flax(backbone: Mapping) -> Dict[str, torch.Tensor]:
    """flax backbone parameter tree -> the port's backbone ``state_dict``
    (fp32)."""
    sd: Dict[str, np.ndarray] = {}
    if any(_CONVBLOCK.match(n) for n in backbone):
        _convnet(backbone, sd)
    else:
        _unet(backbone, sd)
    return {name: torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
            for name, v in sd.items()}


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """keymorph_tpu ``KeyMorphNet`` variables (``{"params": {...}}`` or the
    inner params dict) -> the port's ``KeyMorphNet`` ``state_dict``:
    ``backbone.*``, ``regressor.fc.*`` with the linear keypoint head, and
    ``scales``/``biases`` when the net weights keypoints by variance."""
    p = params["params"] if "params" in params else params
    sd = {f"backbone.{k}": v
          for k, v in backbone_state_dict_from_flax(p["backbone"]).items()}
    if "regressor" in p:
        head: Dict[str, np.ndarray] = {}
        _dense(head, "regressor.fc", p["regressor"]["Dense_0"])
        sd.update({k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
                   for k, v in head.items()})
    for name in ("scales", "biases"):
        if name in p:
            sd[name] = torch.tensor(np.asarray(p[name], dtype=np.float32))
    return sd


def simple_unet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """keymorph_tpu ``SimpleUnet`` variables (``{"params": {...}}`` or the
    inner dict) -> the port's ``SimpleUnet`` ``state_dict`` (fp32)."""
    p = params["params"] if "params" in params else params
    convs = sorted(int(n.split("_")[1]) for n in p if n.startswith("Conv_"))
    sd: Dict[str, np.ndarray] = {}
    for name, sub in p.items():
        kind, i = name.rsplit("_", 1)
        if kind == "Conv":
            _conv(sd, "final_conv" if int(i) == convs[-1] else f"blocks.{i}.conv", sub)
        elif kind == "GroupNorm":
            _norm(sd, f"blocks.{i}.norm", sub)
        else:
            raise ValueError(f"unsupported SimpleUnet parameter group {name!r}")
    return {name: torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
            for name, v in sd.items()}


def unflatten_npz(flat: Mapping) -> dict:
    """A flat mapping of ``/``-joined parameter names (a ``.npz``) -> the
    nested tree."""
    tree: dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree


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
