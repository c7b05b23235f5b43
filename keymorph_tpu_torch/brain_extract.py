"""Brain extraction: ``SimpleUnet`` inference and connected-component mask
cleanup. Port of ``keymorph_tpu/brain_extract.py``.

The net runs on the card unless the caller asks for the CPU; the cleanup is
host numpy and ``scipy.ndimage`` (a copy of keymorph_tpu's rule: the
largest component is kept with every component larger than ``threshold`` x
the largest).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch

from keymorph_tpu_torch import resolve_device


def clean_mask(mask: np.ndarray, threshold: float = 0.2) -> np.ndarray:
    """Drop small islands from a binary mask: uint8, 1 on every connected
    component (face connectivity) of ``mask > 0`` whose size over the
    largest one's exceeds ``threshold``."""
    mask = np.asarray(mask)
    labeled, num = scipy.ndimage.label(mask > 0)
    if num == 0:
        return np.zeros_like(mask, dtype=np.uint8)
    sizes = scipy.ndimage.sum_labels(np.ones_like(labeled), labeled, range(1, num + 1))
    max_size = sizes.max()
    keep = {i + 1 for i, s in enumerate(sizes) if s / max_size > threshold}
    return np.isin(labeled, list(keep)).astype(np.uint8)


def brain_logits(model: torch.nn.Module, img, device=None) -> torch.Tensor:
    """The extractor's logits (B, 1, D, H, W) of (B, 1, D, H, W) volumes,
    on ``device`` (None: the CUDA card), without gradients."""
    device = resolve_device(device)
    x = img if torch.is_tensor(img) else torch.as_tensor(np.asarray(img))
    with torch.no_grad():
        return model.to(device)(x.to(device=device, dtype=torch.float32))


def extract_brain(model: torch.nn.Module, img, threshold: float = 0.5,
                  clean_threshold: float = 0.2, device=None) -> np.ndarray:
    """Run the brain extractor and clean its masks.

    Args:
        model: a ``models.unet.SimpleUnet`` with its weights (keymorph_tpu's
            default: one output channel, encoder (4, 8, 16, 32), decoder
            (32, 16, 8, 4)).
        img: (B, 1, D, H, W) volumes (array or tensor), each size a multiple
            of 16.
        threshold: the sigmoid probability above which a voxel is brain.
        clean_threshold: :func:`clean_mask`'s.
        device: where the net runs (None: the CUDA card).
    Returns:
        (B, 1, D, H, W) uint8 cleaned masks (host numpy).
    """
    prob = torch.sigmoid(brain_logits(model, img, device))[:, 0]
    masks = (prob > threshold).cpu().numpy()
    return np.stack([clean_mask(m, clean_threshold) for m in masks])[:, None]
