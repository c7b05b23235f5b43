"""Keypoint head: the center-of-mass layer.

Port of ``keymorph_tpu/models/layers.py:center_of_mass``.
"""

from __future__ import annotations

import torch


def center_of_mass(vol: torch.Tensor) -> torch.Tensor:
    """Per-channel center of mass in normalized [-1, 1] coordinates.

    Args:
        vol: (B, *spatial, C) channel-last heatmaps, any float dtype.
    Returns:
        (B, C, d) fp32 coordinates in ``ij`` order (first volume axis
        first; keymorph_tpu's "xy" option is not ported). Along an axis of
        size N the coordinate is taken against ``linspace(0, 1, N)`` and
        mapped by ``* 2 - 1`` (align-corners style, the reference's
        convention).

    The ReLU runs in the input dtype; each marginal mass is a reduction that
    accumulates in fp32 without materializing an fp32 copy of the volume.
    """
    spatial = vol.shape[1:-1]
    d = len(spatial)
    v = torch.relu(vol)
    coords = []
    for k in range(d):
        axes = tuple(i + 1 for i in range(d) if i != k)
        m = torch.sum(v, dim=axes, dtype=torch.float32)  # (B, Nk, C)
        total = m.sum(dim=1) + 1e-8
        line = torch.linspace(0.0, 1.0, spatial[k], dtype=torch.float32,
                              device=vol.device)
        coords.append((m * line[None, :, None]).sum(dim=1) / total)
    return torch.stack(coords, dim=-1) * 2.0 - 1.0
