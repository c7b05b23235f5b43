"""The training step over the residual extractor: ``reference/train.py``'s
step (augment the moving volume, extract both keypoint sets, keep the step's
subset, fit the TPS at the step's lambda, warp by its planes, MSE against the
fixed volume, Adam with betas 0.9 and 0.999 and eps 1e-8) with
``reference/resunet_se.py``'s keypoints in place of the DoubleConv U-Net's.

It runs a private copy of ``reference/train.py`` (loaded anew from its file,
so the module the other cells use is untouched) whose extractor is this
one. Gradients are autograd's in float32, through bf16 operands and bf16
stores (``reference/precision.py``: each rounding passes the gradient
through unchanged), and a step can follow another implementation's keypoints
(``forced``), as ``train.run`` takes them.

Departures from the module's equations are ``resunet_se.py``'s (arithmetic
order only). Its head, slab by slab along D, is differentiable as it is: each
slab's marginal sums are written into the (K, N) sums through autograd's
CopySlices, so no copy of it is carried here. Imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

from kmbench.reference import resunet_se
from kmbench.reference.precision import Precision
from kmbench.registry import load

TRAIN = Path(__file__).with_name("train.py")


def keypoints(weights, img, num_levels: int, num_truncated: int, prec: Precision):
    """``resunet_se.keypoints`` under ``unet.keypoints``' signature (the
    residual nets keep every decoder: ``num_truncated`` is 0)."""
    if num_truncated:
        raise ValueError("the residual U-Nets keep every decoder")
    return resunet_se.keypoints(weights, img, num_levels, prec)


def step_module():
    """A private copy of ``reference/train.py`` over this extractor (its
    ``mse`` and ``unet.keypoints`` may be replaced on the copy alone)."""
    train = load(TRAIN)
    train.unet = SimpleNamespace(keypoints=keypoints)
    return train


def run(weights, pairs, draws, lr, steps, num_levels, prec: Precision, forced=None,
        module=None):
    """``train.run`` over this extractor (``module``: a copy from
    :func:`step_module` to run instead). Returns (losses, the first step's
    gradient, the parameters after the last step, the keypoints each step
    extracted)."""
    train = module or step_module()
    return train.run(weights, pairs, draws, lr, steps, num_levels, 0, prec, forced=forced)
