"""Gradient of the port's warp (keymorph_tpu_torch/ops/cuda/resample3d.py)
against keymorph_tpu's.

The port's gradient to the planes is a closed form (the plain version of the
warp-gradient kernel, which CPU tensors run through the same autograd
Function as the card): per axis the corner differences, times the
clamp-and-unnormalize chain with keymorph_tpu's ``jnp.clip`` convention: 0
outside the volume, HALF at an exact clamp tie, and exactly 0 along an axis at
its top edge. The references are keymorph_tpu's XLA VJP through
``ops.planes.grid_sample_planes`` (every case; it defines the convention) and
its Pallas gradient kernel in interpret mode (KM_FORCE_FAST_WARP=1; the
smooth case, as its own default test tier runs it).

Tolerances: against the XLA VJP 1e-4 absolute on gradients of magnitude up
to ~50 (the same fp32 terms summed in another order); against the Pallas
kernel 5e-4, keymorph_tpu's own bar for it (its matmuls carry ~2^-16
relative error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu.ops.pallas import resample3d as jwarp
from keymorph_tpu.ops.planes import grid_sample_planes as jgrid_sample_planes
from keymorph_tpu_torch.ops.cuda import resample3d as twarp
from keymorph_tpu_torch.ops.planes import grid_sample_planes

S = 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_planes(out_spatial, amp=0.05):
    axes = [np.linspace(-1, 1, s) for s in out_spatial]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    pz = zz + amp * np.sin(2.5 * yy + 1.0) - amp * 0.5 * np.cos(2.0 * xx)
    py = yy + amp * np.cos(3.0 * zz) + amp * 0.4 * np.sin(2.0 * xx + 0.3)
    px = xx - amp * np.sin(2.0 * zz + 0.7) + amp * 0.6 * np.cos(2.5 * yy)
    return np.stack([pz, py, px]).astype(np.float32)[None]


def _jax_grads(src, planes, cot, fn, mode="bilinear"):
    _, vjp = jax.vjp(lambda im, pe: fn(im, pe, mode), jnp.asarray(src), jnp.asarray(planes))
    g_img, g_planes = vjp(jnp.asarray(cot))
    return np.asarray(g_img), np.asarray(g_planes)


def _xla(im, pe, mode):
    return jgrid_sample_planes(im, pe, mode=mode)


def _port_grads(src, planes, cot, mode="bilinear"):
    img = torch.tensor(src, requires_grad=True)
    pe = torch.tensor(planes, requires_grad=True)
    twarp.warp_planes(img, pe, mode).backward(torch.tensor(cot))
    return img.grad.numpy(), (None if pe.grad is None else pe.grad.numpy())


def _cot(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("C,src_spatial,out_spatial", [(1, (S, S, S), (S, S, S)),
                                                       (14, (8, 8, 32), (8, 16, 64))])
def test_planes_grad_smooth_flow_matches_jax_xla_and_pallas(rng, monkeypatch, C, src_spatial,
                                                            out_spatial):
    """One channel at 32^3, and the Dice step's 14 one-hot channels onto
    another grid (the smallest the Pallas kernel takes; ~60 s interpreted)."""
    src = rng.random((1, C, *src_spatial), dtype=np.float32)
    planes = _smooth_planes(out_spatial)
    cot = _cot(rng, (1, C, *out_spatial))
    gi, gp = _port_grads(src, planes, cot)
    xi, xp = _jax_grads(src, planes, cot, _xla)
    np.testing.assert_allclose(gp, xp, atol=1e-4)
    np.testing.assert_allclose(gi, xi, atol=1e-5)
    monkeypatch.setenv("KM_FORCE_FAST_WARP", "1")
    _, pp = _jax_grads(src, planes, cot, lambda im, pe, mode: jwarp.warp_planes(im, pe, mode))
    np.testing.assert_allclose(gp, pp, atol=5e-4)


def test_planes_grad_integral_coordinates(rng):
    """Exactly integral sample coordinates: interior ones have the NONZERO
    gradient img[lo + 1] - img[lo]; the last voxel of each axis (an exact
    clamp tie at the top edge, hi == lo) has exactly 0."""
    idx = np.arange(S, dtype=np.float32)
    c = (2.0 * idx + 1.0) / S - 1.0  # voxel centers: v exactly integral
    planes = np.stack(np.meshgrid(c, c, c, indexing="ij")).astype(np.float32)[None]
    src = rng.random((1, 1, S, S, S), dtype=np.float32)
    cot = _cot(rng, (1, 1, S, S, S))
    _, gp = _port_grads(src, planes, cot)
    _, xp = _jax_grads(src, planes, cot, _xla)
    assert np.abs(xp).max() > 0.1  # the case is not trivial
    np.testing.assert_allclose(gp, xp, atol=1e-4)
    assert np.all(gp[0, 0, -1] == 0.0) and np.all(gp[0, 1, :, -1] == 0.0)
    assert np.all(gp[0, 2, :, :, -1] == 0.0)


def test_planes_grad_border_ties_and_outside(rng):
    """Far-outside samples (zero gradient) and exact clamp ties at both ends
    (half the gradient at v == 0, where torch.clamp would pass all of it)."""
    src = rng.random((1, 1, S, S, S), dtype=np.float32)
    planes = _smooth_planes((S, S, S)) * 3.0 - 1.5
    planes[0, 0, 0, :2, :] = 1.0 / S - 1.0            # v == 0 exactly
    planes[0, 1, 1, :, :2] = (2.0 * S - 1.0) / S - 1.0  # v == S - 1 exactly
    cot = _cot(rng, (1, 1, S, S, S))
    _, gp = _port_grads(src, planes, cot)
    _, xp = _jax_grads(src, planes, cot, _xla)
    np.testing.assert_allclose(gp, xp, atol=1e-4)
    # the ties at v == 0 carry half of what autograd through torch.clamp gives
    img = torch.tensor(src)
    pe = torch.tensor(planes, requires_grad=True)
    grid_sample_planes(img, pe).backward(torch.tensor(cot))
    full = pe.grad.numpy()[0, 0, 0, :2, :]
    assert np.abs(full).max() > 0.1
    np.testing.assert_allclose(gp[0, 0, 0, :2, :], 0.5 * full, atol=1e-4)
    outside = (planes[0, 0] < -1.0) | (planes[0, 0] > 1.0)
    assert outside.any() and np.all(gp[0, 0][outside] == 0.0)


@pytest.mark.parametrize("C", [3, 5, 14])
def test_planes_grad_several_channels(rng, C):
    """The planes gradient sums over channels (14: the Dice step's one-hot
    segmentation); other output size than source."""
    src = rng.random((2, C, 12, 20, 16), dtype=np.float32)
    planes = np.concatenate([_smooth_planes((10, 8, 24)), _smooth_planes((10, 8, 24), 0.2)])
    cot = _cot(rng, (2, C, 10, 8, 24))
    gi, gp = _port_grads(src, planes, cot)
    xi, xp = _jax_grads(src, planes, cot, _xla)
    np.testing.assert_allclose(gp, xp, atol=1e-4)
    np.testing.assert_allclose(gi, xi, atol=1e-5)


def test_nearest_has_no_planes_gradient(rng):
    src = rng.random((1, 2, 8, 8, 8), dtype=np.float32)
    planes = _smooth_planes((8, 8, 8))
    cot = _cot(rng, (1, 2, 8, 8, 8))
    gi, gp = _port_grads(src, planes, cot, "nearest")
    xi, xp = _jax_grads(src, planes, cot, _xla, "nearest")
    assert gp is None and not np.any(xp)
    np.testing.assert_allclose(gi, xi, atol=1e-6)


def test_plain_gradient_function_is_what_autograd_uses(rng):
    """warp_planes_grad (the kernel's wrapper) on CPU tensors is the closed
    form the autograd Function returns, and it counts as a plain call."""
    src = torch.tensor(rng.random((1, 2, 6, 7, 8), dtype=np.float32))
    planes = torch.tensor(_smooth_planes((5, 6, 7), 0.3))
    cot = torch.tensor(_cot(rng, (1, 2, 5, 6, 7)))
    n0 = twarp.warp_planes_grad_plain.calls
    direct = twarp.warp_planes_grad(src, planes, cot)
    pe = planes.clone().requires_grad_(True)
    twarp.warp_planes(src, pe).backward(cot)
    assert twarp.warp_planes_grad_plain.calls == n0 + 2
    assert twarp.warp_planes_grad.launches == 0
    torch.testing.assert_close(pe.grad, direct, atol=0, rtol=0)
