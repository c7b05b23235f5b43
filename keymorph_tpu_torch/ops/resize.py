"""Trilinear resize of volumes, antialiased when downsampling.

The counterpart of ``jax.image.resize(img, shape, method="trilinear")``
(``antialias=True``, its default), which keymorph_tpu's same-resolution
step (``training/train.py:make_train_step_sameres``) uses to bring both
images to the model's size. It is NOT ``F.interpolate(mode="trilinear")``:
when an axis shrinks, JAX widens the triangle kernel by the shrink factor
(a low-pass filter before sampling), which ``F.interpolate`` has no option
for; the two differ by O(1) on a noisy volume downsampled ~2x, and agree to
fp32 rounding when upsampling.

As ``jax.image.scale_and_translate`` computes it: for every axis whose size
changes, a weight matrix (input size x output size) from the triangle
kernel at the output sample positions ``(i + 0.5) / scale - 0.5`` (the
kernel's width multiplied by ``max(1 / scale, 1)``), each column
normalized to sum 1 (0 where the sum is below 1000 fp32 epsilons), columns
whose sample falls outside ``[-0.5, n - 0.5]`` zeroed; then one contraction
per axis. An axis that keeps its size is left as it is. Everything is fp32;
on a CUDA device the contractions need TF32 off
(``keymorph_tpu_torch.disable_tf32()``), as keymorph_tpu's run at
``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Sequence

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def resize_weights(in_size: int, out_size: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """The (in_size, out_size) weight matrix of one axis."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=dtype, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_trilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(B, C, *spatial) -> (B, C, *size), fp32 (float64 for a float64
    ``img``)."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("resize_trilinear needs TF32 off: call "
                           "keymorph_tpu_torch.disable_tf32() first")
    out = img.to(torch.promote_types(img.dtype, torch.float32))
    spatial = out.shape[2:]
    if len(size) != len(spatial):
        raise ValueError(f"resize {tuple(img.shape)} to {tuple(size)}: wrong rank")
    for axis, (n_in, n_out) in enumerate(zip(spatial, size)):
        if n_in == n_out:
            continue
        w = resize_weights(n_in, int(n_out), device=out.device, dtype=out.dtype)
        out = torch.tensordot(out.movedim(axis + 2, -1), w, dims=1).movedim(-1, axis + 2)
    return out.contiguous()
