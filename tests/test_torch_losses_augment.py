"""The port's losses, affine augmentation, center of mass and keypoint
helpers (keymorph_tpu_torch/losses.py, augment.py, transforms/affine.py,
models/layers.py, models/keymorph.py) against keymorph_tpu's on the same numpy
inputs. Everything here is plain tensor code in both packages (no kernel), so
the tolerances are those of fp32 sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu import augment as jaugment
from keymorph_tpu import losses as jlosses
from keymorph_tpu.models import keymorph as jkeymorph
from keymorph_tpu.models.layers import center_of_mass as jcenter_of_mass
from keymorph_tpu.transforms.affine import affine_flow as jaffine_flow
from keymorph_tpu_torch import augment, losses
from keymorph_tpu_torch.models import keymorph
from keymorph_tpu_torch.models.layers import center_of_mass
from keymorph_tpu_torch.transforms.affine import affine_flow


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rng, B, amp=1.0):
    """(scale, offset, theta, shear) inside the default augmentation ranges."""
    return (rng.uniform(1 - 0.2 * amp, 1 + 0.2 * amp, (B, 3)).astype(np.float32),
            rng.uniform(-0.2 * amp, 0.2 * amp, (B, 3)).astype(np.float32),
            rng.uniform(-1.0 * amp, 1.0 * amp, (B, 3)).astype(np.float32),
            rng.uniform(-0.1 * amp, 0.1 * amp, (B, 6)).astype(np.float32))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_mse_loss_and_its_gradient_match_jax(rng):
    """Value rel 1e-6; gradient 1e-6 of its largest value (2 (p - t) / n)."""
    p = rng.normal(size=(2, 1, 6, 7, 8)).astype(np.float32)
    t = rng.normal(size=(2, 1, 6, 7, 8)).astype(np.float32)
    want, g = jax.value_and_grad(jlosses.mse_loss)(jnp.asarray(p), jnp.asarray(t))
    tp = torch.tensor(p, requires_grad=True)
    got = losses.mse_loss(tp, torch.tensor(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g), atol=1e-6 * np.abs(g).max())
    assert losses.MSELoss()(tp, torch.tensor(t)).item() == got.item()


@pytest.mark.parametrize("ign_first_ch", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_dice_losses_match_jax(rng, hard, ign_first_ch):
    """Soft and hard Dice (eps = 1) over (B, C, *spatial); the soft loss's
    gradient too. rel 1e-5: fp32 sums over 336 voxels per channel."""
    pred = rng.random((2, 4, 6, 7, 8)).astype(np.float32)
    tgt = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 6, 7, 8))].transpose(0, 4, 1, 2, 3)
    if hard:
        want = jlosses.hard_dice_loss(jnp.asarray(pred), jnp.asarray(tgt), ign_first_ch)
        got = losses.hard_dice_loss(torch.tensor(pred), torch.tensor(tgt), ign_first_ch)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        return
    want, g = jax.value_and_grad(
        lambda p: jlosses.soft_dice_loss(p, jnp.asarray(tgt), ign_first_ch))(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    got = losses.soft_dice_loss(tp, torch.tensor(tgt), ign_first_ch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g), atol=1e-5 * np.abs(g).max())


def test_dice_regions_and_wrapper_classes_match_jax(rng):
    pred = rng.random((2, 3, 5, 6, 7)).astype(np.float32)
    tgt = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5, 6, 7))].transpose(0, 4, 1, 2, 3)
    want = jlosses.hard_dice_loss(jnp.asarray(pred), jnp.asarray(tgt), return_regions=True)
    got = losses.hard_dice_loss(torch.tensor(pred), torch.tensor(tgt), return_regions=True)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for kw in (dict(hard=False), dict(hard=True), dict(hard=True, return_regions=True)):
        w = jlosses.DiceLoss(**kw)(jnp.asarray(pred), jnp.asarray(tgt), ign_first_ch=True)
        g = losses.DiceLoss(**kw)(torch.tensor(pred), torch.tensor(tgt), ign_first_ch=True)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    with pytest.raises(ValueError):
        losses.soft_dice_loss(torch.tensor(pred), torch.tensor(tgt)[:, :2])


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def test_affine_matrix_and_flow_match_jax(rng):
    """M = Shear @ Scale @ Translate @ R3 R2 R1 and the dense xy grid of its
    inverse: 1e-5 (fp32 4x4 products and an inverse)."""
    params = _params(rng, 3)
    want = np.asarray(jaugment.build_affine_matrix_3d(*(jnp.asarray(p) for p in params)))
    M = augment.build_affine_matrix_3d(*(torch.tensor(p) for p in params))
    np.testing.assert_allclose(M.numpy(), want, atol=1e-6)
    assert torch.equal(augment.build_affine_matrix(tuple(torch.tensor(p) for p in params)), M)
    inv = np.linalg.inv(want).astype(np.float32)
    flow = affine_flow(torch.tensor(inv), (5, 6, 7))
    assert flow.shape == (3, 5, 6, 7, 3)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jaffine_flow(jnp.asarray(inv), (5, 6, 7))),
                               atol=1e-5)


def test_augment_with_params_matches_jax(rng):
    """Image (trilinear), segmentation (nearest) and points through one
    parameter set. The image within 1e-4 (sample coordinates differ by fp32
    rounding of the inverse, times the image gradient); the nearest labels
    may flip where a coordinate lands within that rounding of a voxel
    boundary: at most 0.5% of voxels."""
    B, S = 2, 12
    params = _params(rng, B, amp=0.5)
    axes = np.linspace(-1, 1, S)
    zz, yy, xx = np.meshgrid(axes, axes, axes, indexing="ij")
    img = np.stack([np.exp(-((zz - 0.2 * b) ** 2 + yy ** 2 + (xx + 0.1) ** 2) / 0.2)
                    for b in range(B)])[:, None].astype(np.float32)
    seg = rng.integers(0, 4, (B, 1, S, S, S)).astype(np.float32)
    pts = rng.uniform(-0.8, 0.8, (B, 5, 3)).astype(np.float32)
    jimg, jseg, jpts, jM = jaugment.affine_augment_with_params(
        jnp.asarray(img), tuple(jnp.asarray(p) for p in params), seg=jnp.asarray(seg),
        points=jnp.asarray(pts), return_affine_matrix=True)
    timg, tseg, tpts, tM = augment.affine_augment_with_params(
        torch.tensor(img), tuple(torch.tensor(p) for p in params), seg=torch.tensor(seg),
        points=torch.tensor(pts), return_affine_matrix=True)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), atol=1e-6)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-6)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-4)
    assert np.mean(tseg.numpy() != np.asarray(jseg)) <= 5e-3
    assert set(np.unique(tseg.numpy())) <= {0.0, 1.0, 2.0, 3.0}
    # a lone image comes back bare, as keymorph_tpu returns it
    alone = augment.affine_augment_with_params(torch.tensor(img),
                                               tuple(torch.tensor(p) for p in params))
    assert torch.equal(alone, timg)


def test_fixed_params_and_deterministic_augment_match_jax(rng):
    fixed = (0.1, -0.05, 0.3, 0.02)
    want = jaugment.fixed_affine_params(2, 3, fixed)
    got = augment.fixed_affine_params(2, 3, fixed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    img = rng.random((2, 1, 8, 9, 10)).astype(np.float32)
    np.testing.assert_allclose(augment.affine_augment(torch.tensor(img), fixed).numpy(),
                               np.asarray(jaugment.affine_augment(jnp.asarray(img), fixed)),
                               atol=1e-4)


def test_random_augment_draws_from_the_generator(rng):
    """Parameters stay inside their ranges, scale with the ramp factor, repeat
    for a repeated seed, and a pair shares one transform. (The two packages
    draw different numbers from a seed, so only the ranges are comparable.)"""
    mx = (0.2, 0.1, 0.5, 0.05)
    g = torch.Generator().manual_seed(3)
    scale, offset, theta, shear = augment.sample_affine_params(g, 64, 3, mx, scale_params=0.5)
    assert scale.shape == (64, 3) and shear.shape == (64, 6)
    for t, lo, hi in ((scale, 0.9, 1.1), (offset, -0.05, 0.05), (theta, -0.25, 0.25),
                      (shear, -0.025, 0.025)):
        assert float(t.min()) >= lo and float(t.max()) <= hi and float(t.std()) > 0
    jp = jaugment.sample_affine_params(jax.random.PRNGKey(0), 64, 3, mx, 0.5)
    for t, j in zip((scale, offset, theta, shear), jp):
        assert t.shape == j.shape
        assert abs(float(t.max() - t.min()) - float(j.max() - j.min())) < 0.1 * float(
            j.max() - j.min())
    img = torch.tensor(rng.random((1, 1, 8, 8, 8)).astype(np.float32))
    a = augment.random_affine_augment(torch.Generator().manual_seed(5), img, max_random_params=mx)
    b = augment.random_affine_augment(torch.Generator().manual_seed(5), img, max_random_params=mx)
    assert torch.equal(a, b) and not torch.equal(a, img)
    m1, m2 = augment.random_affine_augment_pair(torch.Generator().manual_seed(5), img, 2.0 * img,
                                                max_random_params=mx)
    torch.testing.assert_close(m2, 2.0 * m1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(m1, a, atol=0, rtol=0)


def test_augment_rejects_2d(rng):
    """Named for the time the port refused 2D augmentation; 2D is ported now
    and nothing of it is refused, as in keymorph_tpu: the 2D draws take
    keymorph_tpu's parameter layout ((B, 2), (B, 2), (B, 1), (B, 2)) and
    ranges, and ``affine_flow`` of a (B, 3, 3) matrix is keymorph_tpu's 2D
    grid (within 1e-6)."""
    drawn = augment.sample_affine_params(torch.Generator().manual_seed(0), 64, dim=2,
                                         max_random_params=(0.2, 0.3, 0.4, 0.1))
    want = jaugment.sample_affine_params(jax.random.PRNGKey(0), 64, 2, (0.2, 0.3, 0.4, 0.1))
    for t, j, hi in zip(drawn, want, (1.2, 0.3, 0.4, 0.1)):
        assert t.shape == j.shape and float(t.max()) <= hi
    m = np.eye(3, dtype=np.float32)[None] + rng.normal(0, 0.1, (2, 3, 3)).astype(np.float32)
    m[:, 2] = [0, 0, 1]
    np.testing.assert_allclose(affine_flow(torch.tensor(m), (5, 7)).numpy(),
                               np.asarray(jaffine_flow(jnp.asarray(m), (5, 7))),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# keypoint head and training helpers
# ---------------------------------------------------------------------------


def test_center_of_mass_gradient_matches_jax(rng):
    """bf16 heatmaps, fp32 sums: keypoints 1e-6, and the gradient to the
    heatmaps (rounded to bf16 in both packages) within one bf16 ulp of the
    largest value."""
    vol = torch.tensor(rng.normal(size=(2, 6, 7, 8, 5)).astype(np.float32)).to(torch.bfloat16)
    cot = rng.normal(size=(2, 5, 3)).astype(np.float32)
    jvol = jnp.asarray(vol.float().numpy()).astype(jnp.bfloat16)
    want, vjp = jax.vjp(jcenter_of_mass, jvol)
    (jg,) = vjp(jnp.asarray(cot))
    tv = vol.clone().requires_grad_(True)
    got = center_of_mass(tv)
    got.backward(torch.tensor(cot))
    assert got.dtype == torch.float32 and tv.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    jg = np.asarray(jg.astype(jnp.float32))
    np.testing.assert_allclose(tv.grad.float().numpy(), jg, atol=2.0 ** -7 * np.abs(jg).max())
    assert not np.any(tv.grad.float().numpy()[vol.float().numpy() < 0])  # behind the ReLU


def test_transform_type_parsing_matches_jax():
    for s in ("tps_0.1", "tps_10", "tps_loguniform", "tps_uniform", "affine", "rigid"):
        assert keymorph.parse_transform_type(s) == jkeymorph.parse_transform_type(s)
        assert keymorph.is_supported_transform_type(s)
    assert not keymorph.is_supported_transform_type("bspline")
    with pytest.raises(ValueError):
        keymorph.parse_transform_type("bspline")


def test_sample_tps_lmbda(rng):
    """A constant is exact; the random specs stay in keymorph_tpu's ranges
    ([0, max) and [1e-6, max)) and repeat for a repeated seed."""
    const = keymorph.sample_tps_lmbda(None, 3, 0.25)
    np.testing.assert_array_equal(
        const.numpy(), np.asarray(jkeymorph.sample_tps_lmbda(jax.random.PRNGKey(0), 3, 0.25)))
    g = torch.Generator().manual_seed(1)
    uni = keymorph.sample_tps_lmbda(g, 256, "uniform", 4.0)
    log = keymorph.sample_tps_lmbda(g, 256, "loguniform", 4.0)
    assert 0.0 <= float(uni.min()) and float(uni.max()) < 4.0
    assert 1e-6 <= float(log.min()) and float(log.max()) < 4.0
    # log-uniform: half of the draws lie below the geometric middle of the range
    assert 0.35 < float((log < np.sqrt(1e-6 * 4.0)).float().mean()) < 0.65
    again = keymorph.sample_tps_lmbda(torch.Generator().manual_seed(1), 256, "uniform", 4.0)
    assert torch.equal(again, uni)


def test_subsample_keypoints_takes_injected_indices(rng):
    """With the indices keymorph_tpu drew, the port picks the same keypoints;
    without, a seeded permutation's first entries."""
    pf = rng.normal(size=(2, 10, 3)).astype(np.float32)
    pm = rng.normal(size=(2, 10, 3)).astype(np.float32)
    w = rng.random((2, 10)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jf, jm, jw = jkeymorph.subsample_keypoints(key, jnp.asarray(pf), jnp.asarray(pm),
                                               jnp.asarray(w), 4)
    idx = np.array(jax.random.permutation(key, 10)[:4])
    tf, tm, tw = keymorph.subsample_keypoints(None, torch.tensor(pf), torch.tensor(pm),
                                              torch.tensor(w), 4, idx=idx)
    for t, j in ((tf, jf), (tm, jm), (tw, jw)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g = torch.Generator().manual_seed(2)
    want = torch.randperm(10, generator=torch.Generator().manual_seed(2))[:4]
    tf, _, tw = keymorph.subsample_keypoints(g, torch.tensor(pf), torch.tensor(pm), None, 4)
    assert tw is None and torch.equal(tf, torch.tensor(pf)[:, want])
