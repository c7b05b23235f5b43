"""Training losses (differentiable). Port of ``keymorph_tpu/losses.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, computed in fp32."""
    return torch.mean((pred.float() - target.float()) ** 2)


def soft_dice_loss(pred, target, ign_first_ch: bool = False, eps: float = 1.0):
    """Soft Dice loss (lower is better), a scalar over the whole batch.

    Args:
        pred, target: (B, C, *spatial) channel-first probabilities / one-hot.
        ign_first_ch: drop channel 0 (background) from the average.
        eps: smoothing added to numerator and denominator.
    """
    return _dice(pred, target, hard=False, ign_first_ch=ign_first_ch, eps=eps)[0]


def hard_dice_loss(pred, target, ign_first_ch: bool = False,
                   return_regions: bool = False, eps: float = 1.0):
    """Hard Dice: the prediction is first turned into the one-hot of its
    argmax. Returns the scalar average, or per-region averages (C,) with
    ``return_regions``."""
    total, regions = _dice(pred, target, hard=True, ign_first_ch=ign_first_ch, eps=eps)
    return regions if return_regions else total


def _dice(pred, target, hard, ign_first_ch, eps):
    if pred.shape != target.shape:
        raise ValueError("Input and target are different dim")
    B, C = pred.shape[:2]
    pred = pred.reshape(B, C, -1).float()
    target = target.reshape(B, C, -1).float()
    if hard:
        am = torch.argmax(pred, dim=1)
        pred = F.one_hot(am, C).movedim(-1, 1).float()
    if ign_first_ch:
        pred, target = pred[:, 1:], target[:, 1:]
    num = 2.0 * torch.sum(pred * target, dim=2) + eps
    den = torch.sum(pred * pred, dim=2) + torch.sum(target * target, dim=2) + eps
    dice_loss = 1.0 - num / den  # (B, C')
    return torch.mean(dice_loss), torch.mean(dice_loss, dim=0)


class MSELoss:
    """Object-style wrapper of :func:`mse_loss`."""

    def __call__(self, pred, target):
        return mse_loss(pred, target)

    forward = __call__


class DiceLoss:
    """Object-style wrapper of the Dice losses."""

    def __init__(self, hard: bool = False, return_regions: bool = False):
        self.hard = hard
        self.return_regions = return_regions

    def __call__(self, pred, target, ign_first_ch: bool = False):
        total, regions = _dice(pred, target, hard=self.hard,
                               ign_first_ch=ign_first_ch, eps=1.0)
        return regions if self.return_regions else total

    forward = __call__
