"""Checkpoint save/load on ``torch.save`` / ``torch.load``.

Port of ``keymorph_tpu/training/checkpoint.py`` with its payload keys
(``params``, ``opt_state``, ``step``, ``epoch``, optional ``ref_points``) and
directory names (``{directory}/epoch{N}_model/``). ``params`` is the net's
``state_dict`` and ``opt_state`` the optimizer's; ``ref_points`` is stored as
a tensor, so a file holds tensors and plain Python containers only and loads
with ``weights_only=True`` (no arbitrary unpickling).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

_EPOCH_RE = re.compile(r"epoch(\d+)")
_FILE = "checkpoint.pt"


def save_checkpoint(directory: str, epoch: int, state, ref_points=None):
    """Write ``{directory}/epoch{N}_model/checkpoint.pt``; returns the
    checkpoint directory."""
    path = os.path.abspath(os.path.join(directory, f"epoch{epoch}_model"))
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": state.net.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    if ref_points is not None:
        payload["ref_points"] = (ref_points.detach().cpu() if torch.is_tensor(ref_points)
                                 else torch.as_tensor(np.asarray(ref_points)))
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_epoch_checkpoint(directory: str) -> Optional[str]:
    """Newest ``epoch{N}_model`` in a directory, by N."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        m = _EPOCH_RE.search(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def load_checkpoint(path: str, state=None, map_location="cpu"):
    """Load a checkpoint directory and return its payload dict. With a
    :class:`~keymorph_tpu_torch.training.train.TrainState`, also restore its
    net, optimizer and step in place. A missing, corrupt or structurally
    incompatible checkpoint raises."""
    file = os.path.join(os.path.abspath(path), _FILE)
    payload = torch.load(file, map_location=map_location, weights_only=True)
    missing = {"params", "opt_state", "step", "epoch"} - set(payload)
    if missing:
        raise ValueError(f"checkpoint {file} lacks {sorted(missing)}")
    if state is not None:
        state.net.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
    return payload
