"""The port's center-of-mass head (``models/layers.py``: ``center_of_mass``
with ``indexing`` and the ``CenterOfMass`` module) against keymorph_tpu's on
the CPU, in 2D and 3D, on seeded heatmaps in bf16 and fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.models import CenterOfMass as JCenterOfMass
from keymorph_tpu.models import center_of_mass as jcenter_of_mass
from keymorph_tpu_torch.models import CenterOfMass, center_of_mass

ABS = 1e-6   # fp32 sums of the same addends in another order
SHAPES = {2: (2, 17, 12, 5), 3: (2, 9, 14, 11, 6)}   # (B, *spatial, C), channel-last


def _heatmaps(dim, dtype, seed=0):
    """Seeded heatmaps (B, *spatial, C), half of them negative (the ReLU
    drops those), in both packages' ``dtype``."""
    x = np.random.default_rng(seed).normal(size=SHAPES[dim]).astype(np.float32)
    t = torch.tensor(x).to(dtype)
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    return t, j


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("indexing", ["ij", "xy"])
def test_center_of_mass_matches_jax(dim, dtype, indexing):
    """The function and the module give keymorph_tpu's coordinates within
    ABS, (B, C, dim) fp32 in [-1, 1]."""
    t, j = _heatmaps(dim, dtype)
    want = np.asarray(jcenter_of_mass(j, indexing))
    got = center_of_mass(t, indexing)
    mod = CenterOfMass(indexing)(t)
    jmod = np.asarray(JCenterOfMass(indexing).apply({}, j))
    assert got.dtype == torch.float32 and got.shape == (SHAPES[dim][0], SHAPES[dim][-1], dim)
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=ABS, rtol=0)
    np.testing.assert_allclose(mod.numpy(), jmod, atol=ABS, rtol=0)
    assert torch.equal(mod, got)


@pytest.mark.parametrize("dim", [2, 3])
def test_xy_is_ij_reversed_and_ij_is_the_default(dim):
    """``"xy"`` is the ``"ij"`` coordinates in reverse order, bit for bit,
    and the default is ``"ij"`` (the served pairs' path, unchanged); no
    other indexing is taken."""
    t, _ = _heatmaps(dim, torch.bfloat16, seed=1)
    ij = center_of_mass(t, "ij")
    assert torch.equal(center_of_mass(t), ij) and torch.equal(CenterOfMass()(t), ij)
    assert torch.equal(center_of_mass(t, "xy"), ij.flip(-1))
    assert not list(CenterOfMass().parameters())
    with pytest.raises(ValueError, match="indexing"):
        center_of_mass(t, "zyx")
    with pytest.raises(ValueError, match="indexing"):
        CenterOfMass("zyx")


def _refuse(*args, **kwargs):
    raise AssertionError("reached the head kernel's route")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_a_cpu_tensor_takes_the_plain_version(dim, dtype, monkeypatch):
    """On a CPU tensor ``center_of_mass`` is ``center_of_mass_plain`` bit
    for bit, never reaches the kernel's wrapper, and matches keymorph_tpu
    as before; no counter moves."""
    from keymorph_tpu_torch.models import center_of_mass_plain
    from keymorph_tpu_torch.ops.cuda import heatmap

    monkeypatch.setattr(heatmap, "heatmap_com", _refuse)
    t, j = _heatmaps(dim, dtype, seed=2)
    calls = heatmap.heatmap_com_plain.calls
    with torch.no_grad():
        got = center_of_mass(t)
    assert torch.equal(got, center_of_mass_plain(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcenter_of_mass(j)), atol=ABS, rtol=0)
    assert heatmap.heatmap_com_plain.calls == calls


@pytest.mark.parametrize("dim", [2, 3])
def test_the_gradient_through_center_of_mass_is_unchanged(dim):
    """An input that requires grad keeps autograd through ``center_of_mass``:
    its gradient is the plain version's, bit for bit, and keymorph_tpu's
    (``jax.grad``) within fp32 rounding of the sums (2e-5 of the largest)."""
    import jax

    from keymorph_tpu_torch.models import center_of_mass_plain

    x = np.random.default_rng(3).normal(size=SHAPES[dim]).astype(np.float32)
    w = np.random.default_rng(4).normal(size=(SHAPES[dim][0], SHAPES[dim][-1], dim)).astype(
        np.float32)
    t = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad((center_of_mass(t) * torch.tensor(w)).sum(), t)
    (gp,) = torch.autograd.grad((center_of_mass_plain(t) * torch.tensor(w)).sum(), t)
    assert torch.equal(g, gp)
    gj = np.asarray(jax.grad(lambda v: (jcenter_of_mass(v) * w).sum())(jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), gj, atol=2e-5 * np.abs(gj).max(), rtol=0)


def test_plain_keypoints_never_reach_the_router(monkeypatch):
    """``keypoints_from_features(plain=True)`` and ``get_keypoints(plain=True)``
    take ``center_of_mass_plain`` and never ``center_of_mass`` or the kernel's
    wrapper; without ``plain`` the head goes through ``center_of_mass``."""
    from torch import nn

    from keymorph_tpu_torch.models import center_of_mass_plain, keymorph
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.ops.cuda import heatmap

    torch.manual_seed(0)
    net = KeyMorphNet(nn.Conv3d(1, 6, 3, padding=1), 6)
    img = torch.rand((2, 1, 8, 9, 10))
    with torch.no_grad():
        feat = net.features(img)
        want = center_of_mass_plain(feat)
    monkeypatch.setattr(keymorph, "center_of_mass", _refuse)
    monkeypatch.setattr(heatmap, "heatmap_com", _refuse)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert torch.equal(net.keypoints_from_features(feat, plain=True), want)
            points, f = net.get_keypoints(img, return_feat=True, plain=True)
            assert torch.equal(points, want) and points.requires_grad == grad
            with pytest.raises(AssertionError, match="head kernel"):
                net.keypoints_from_features(feat)


def test_the_head_wrapper_on_the_cpu():
    """``heatmap_com`` on a CPU tensor runs its plain version, counted, and
    launches nothing; it is forward-only, as the other serving wrappers."""
    from keymorph_tpu_torch.models import center_of_mass_plain
    from keymorph_tpu_torch.ops.cuda import heatmap

    t, _ = _heatmaps(3, torch.bfloat16, seed=5)
    calls, launches = heatmap.heatmap_com_plain.calls, heatmap.heatmap_com.launches
    assert torch.equal(heatmap.heatmap_com(t), center_of_mass_plain(t))
    assert heatmap.heatmap_com_plain.calls == calls + 1
    assert heatmap.heatmap_com.launches == launches
    with pytest.raises(RuntimeError, match="forward-only"):
        heatmap.heatmap_com(t.float().requires_grad_())


@pytest.mark.parametrize("spatial,C,itemsize", [((256, 256, 256), 256, 2), ((128, 128, 128), 256, 2),
                                                ((24, 256, 256), 256, 2), ((7, 13, 19), 6, 2),
                                                ((37, 29), 5, 4), ((300, 1, 1), 3, 4)])
def test_the_head_plan_cuts_an_item_into_equal_runs_of_rows(spatial, C, itemsize):
    """The first pass's plan, from an item's shape alone (it takes no batch
    size): runs of whole x-rows covering the item's Z*Y rows exactly once,
    at most MAX_BLOCKS of them, each of at least MIN_BLOCK_BYTES of heatmaps
    unless the item has one run."""
    from keymorph_tpu_torch.ops.cuda import heatmap

    Z, Y, X = (1,) * (3 - len(spatial)) + spatial
    rows, blocks = heatmap.plan(spatial, C, itemsize)
    assert rows * (blocks - 1) < Z * Y <= rows * blocks
    assert 1 <= blocks <= heatmap.MAX_BLOCKS
    assert blocks == 1 or rows * X * C * itemsize >= heatmap.MIN_BLOCK_BYTES
