"""Script helpers. Port of ``keymorph_tpu/cli/script_utils.py``."""

from __future__ import annotations

import json
import math
import os

from keymorph_tpu_torch.utils import aggregate_dicts, parse_test_mod  # noqa: F401


def parse_test_aug(aug):
    """'rot45' -> the fixed augmentation (scale, offset, angle, shear)."""
    rots = {
        "rot0": 0.0,
        "rot45": math.pi / 4,
        "rot90": math.pi / 2,
        "rot135": 3 * math.pi / 4,
        "rot180": math.pi,
    }
    if aug in rots:
        return (0.0, 0.0, rots[aug], 0.0)
    raise NotImplementedError(f"Unknown aug {aug}")


def save_dict_as_json(d, path):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(d, fh, indent=2, default=float)


def load_dict_from_json(path):
    with open(path) as fh:
        return json.load(fh)


def summary(model):
    """Print and return the parameter count of a module (or of a
    ``KeyMorph``'s net)."""
    net = getattr(model, "net", model)
    params = list(net.parameters())
    total = sum(p.numel() for p in params)
    print("Model summary:")
    print(f"  parameter arrays: {len(params)}")
    print(f"  trainable parameters: {total:,}")
    return total


def initialize_wandb(config):
    """Optional Weights & Biases init: returns the ``wandb`` module after
    ``wandb.init``, or None (printing so) where wandb is not installed, and
    the run logs to stdout and ``train_log.jsonl`` alone."""
    try:
        import wandb
    except ImportError:
        print("wandb not available; logging to stdout only")
        return None
    if config.wandb_api_key_path:
        with open(config.wandb_api_key_path) as fh:
            os.environ["WANDB_API_KEY"] = fh.read().strip()
    wandb.init(name=config.job_name, config=config.__dict__, **(config.wandb_kwargs or {}))
    return wandb
