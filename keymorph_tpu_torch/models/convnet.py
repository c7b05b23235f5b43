"""Plain convolutional keypoint-heatmap backbone.

Port of ``keymorph_tpu/models/convnet.py`` (the reference's ``net.py``
``ConvNet``): eight :class:`~keymorph_tpu_torch.models.layers.ConvBlock`\\ s
over the widths ``H_DIMS`` with a 2x max-pool after every second one (16x
smaller output), then a head block to ``out_dim`` channels without pooling.
Parameter names are the reference's (``block{k}.conv.*``, ``block{k}.norm.*``,
k = 1..9), so a reference ``.pt`` loads directly (an ``instance`` norm's
scale and bias, which the reference's affine-free ``InstanceNorm3d`` lacks,
keep their identity init; ``cli/register.py:load_weights``).
"""

from __future__ import annotations

import torch
from torch import nn

from keymorph_tpu_torch.models.layers import ConvBlock

H_DIMS = (32, 64, 64, 128, 128, 256, 256, 512)


class ConvNet(nn.Module):
    """(B, 1, *spatial) -> heatmaps (B, out_dim, *spatial / 16) in ``dtype``;
    3^dim convs (``dim`` 3 or 2)."""

    def __init__(self, out_dim: int, norm_type: str = "instance",
                 dtype: torch.dtype = torch.float32, in_channels: int = 1, dim: int = 3):
        super().__init__()
        self.norm_type = norm_type
        self.dtype = dtype
        self.dim = dim
        widths = (in_channels,) + H_DIMS
        for k, (cin, cout) in enumerate(zip(widths, H_DIMS)):
            self.add_module(f"block{k + 1}",
                            ConvBlock(cin, cout, 1, norm_type, k % 2 == 1, dtype, dim))
        self.add_module(f"block{len(H_DIMS) + 1}",
                        ConvBlock(H_DIMS[-1], out_dim, 1, norm_type, False, dtype, dim))

    def forward(self, x):
        x = x.to(self.dtype)
        for block in self.children():
            x = block(x)
        return x
