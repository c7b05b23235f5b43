"""2D registration in the port against keymorph_tpu on the CPU: the 2D
U-Net and ConvNet, the 2D warp, the 2D augmentation, ``align_pair`` at
d = 2, ``KeyMorph(dim=2)`` and the 2D training step.

Both packages get the same numpy inputs (seeded) and the same weights
(flax-initialized, carried by ``tools/import_flax_params.py``). keymorph_tpu
reaches no Pallas kernel in 2D (its TPS kernel and its warp kernel take 3D
only, its conv executor 3D U-Nets only), so every comparison here is fp32
against fp32 XLA, and the port's 2D route moves no kernel counter and no
plain-version counter. Each test states its tolerance.

Every case of ``tests/test_2d_pipeline.py`` runs on the port too
(``test_2d_pipeline_case_on_the_port``).
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu import augment as jaugment
from keymorph_tpu.models import convnet as jconvnet
from keymorph_tpu.models import keymorph as jkeymorph
from keymorph_tpu.models import unet as junet
from keymorph_tpu.ops import resample as jresample
from keymorph_tpu.tools.import_torch_weights import import_backbone_state_dict
from keymorph_tpu.training import config as jconfig
from keymorph_tpu.training import train as jtrain
from keymorph_tpu_torch import augment
from keymorph_tpu_torch.models.convnet import ConvNet
from keymorph_tpu_torch.models.keymorph import KeyMorph, KeyMorphNet, align_pair
from keymorph_tpu_torch.models.unet import UNet2D, init_weights
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.ops import resample
from keymorph_tpu_torch.tools.import_flax_params import (
    backbone_state_dict_from_flax,
    state_dict_from_flax,
)
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config, build_backbone, build_model

K, SUB = 8, 6
UNET = dict(out_channels=K, f_maps=4, num_levels=2)
SPATIAL = (16, 20)
HEATMAP_REL = 1e-5     # x max |heatmap|, fp32 in both packages
KEYPOINT_ABS = 1e-5    # normalized units
GRID_ABS = 1e-6        # align_pair from identical keypoints
WARP_ABS = 1e-6        # bilinear warp of values in [0, 1]
AUG_ABS = 1e-6         # matrices, augmented images and points
GRAD_REL = 1e-4        # the step's gradients, relative L2 per parameter
LOSS_REL = 1e-5
KEY = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables, rng):
    """Norm scales 1 + 0.2 N(0, 1), norm and conv biases 0.1 N(0, 1)."""
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():
        if path[-1] == "scale":
            flat[path] = jnp.asarray(1.0 + 0.2 * rng.normal(size=v.shape).astype(np.float32))
        elif path[-1] == "bias":
            flat[path] = jnp.asarray(0.1 * rng.normal(size=v.shape).astype(np.float32))
    return flax.traverse_util.unflatten_dict(flat)


def _blobs(rng, spatial=SPATIAL, n=2):
    """``n`` smooth blob images with a little noise, (n, 1, *spatial)."""
    axes = [np.linspace(-1, 1, s) for s in spatial]
    yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(-0.3, 0.3, 2)
        v = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.2)
        v = v + 0.5 * np.exp(-((yy + cy) ** 2 + (xx + 0.4) ** 2) / 0.05)
        out.append(v + 0.02 * rng.random(v.shape))
    return np.stack(out)[:, None].astype(np.float32)


def _counters_still():
    return all(c["launches"] == 0 and c["plain_calls"] == 0
               for c in kernels.counters().values())


# ---------------------------------------------------------------------------
# the cases of tests/test_2d_pipeline.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def km2d():
    net = init_weights(UNet2D(out_channels=12, f_maps=4, num_levels=2),
                       torch.Generator().manual_seed(0))
    return KeyMorph(net, 12, dim=2, device="cpu")


def _case_forward_contract(km2d, rng):
    img_f = torch.tensor(rng.normal(size=(1, 1, 24, 24)).astype(np.float32))
    img_m = torch.tensor(rng.normal(size=(1, 1, 24, 24)).astype(np.float32))
    res = km2d(img_f, img_m, transform_type=["rigid", "affine", "tps_0.1"],
               return_aligned_points=True)
    for name, r in res.items():
        assert r["grid"].shape == (1, 24, 24, 2)
        assert r["points_f"].shape == (1, 12, 2) and r["points_a"].shape == (1, 12, 2)
        warped = resample.align_img(r["grid"], img_m)
        assert warped.shape == img_m.shape and bool(torch.isfinite(warped).all())
        if name in ("rigid", "affine"):
            assert r["matrix"].shape == (1, 3, 3)


def _case_self_registration(km2d, rng):
    img = torch.tensor(rng.normal(size=(1, 1, 24, 24)).astype(np.float32))
    res = km2d(img, img, transform_type="affine")
    np.testing.assert_allclose(res["affine"]["matrix"][0].numpy(), np.eye(3), atol=1e-3)


def _case_augment_consistency(km2d, rng):
    """2D augmentation: an impulse follows its keypoint."""
    N = 33
    img = np.zeros((1, 1, N, N), np.float32)
    img[0, 0, 8, 20] = 1.0
    pt = np.array([[[8 / (N - 1) * 2 - 1, 20 / (N - 1) * 2 - 1]]], np.float32)
    params = augment.fixed_affine_params(1, 2, (0.0, 0.1, 0.4, 0.0))
    img_a, pt_a = augment.affine_augment_with_params(torch.tensor(img), params,
                                                     points=torch.tensor(pt))
    loc = np.unravel_index(np.argmax(img_a[0, 0].numpy()), (N, N))
    loc_norm = np.asarray(loc) / (N - 1) * 2 - 1
    np.testing.assert_allclose(loc_norm, pt_a[0, 0].numpy(), atol=0.15)


def _case_convnet_pipeline(km2d, rng):
    net = init_weights(ConvNet(out_dim=8, dim=2, norm_type="instance"),
                       torch.Generator().manual_seed(1))
    km = KeyMorph(net, 8, dim=2, device="cpu")
    img = torch.tensor(rng.normal(size=(1, 1, 32, 32)).astype(np.float32))
    pts = km.get_keypoints(img)
    assert pts.shape == (1, 8, 2) and bool((pts.abs() <= 1).all())


def _case_train_step(km2d, rng):
    net = KeyMorphNet(init_weights(UNet2D(out_channels=8, f_maps=4, num_levels=2),
                                   torch.Generator().manual_seed(0)), 8, dim=2)
    config = Config(num_keypoints=8, transform_type="affine", loss_fn="mse", lr=1e-4, dim=2,
                    max_random_affine_augment_params=(0.1, 0.1, 0.3, 0.05))
    img = torch.tensor(rng.normal(size=(2, 1, 16, 16)).astype(np.float32))
    state = train.TrainState.create(net, train.make_optimizer(config, net))
    state, metrics = train.make_train_step(net, config)(
        state, torch.Generator().manual_seed(1), img, img, None, None, 1.0)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


PIPELINE_CASES = {"forward_contract": _case_forward_contract,
                  "self_registration": _case_self_registration,
                  "augment_consistency": _case_augment_consistency,
                  "convnet_pipeline": _case_convnet_pipeline,
                  "train_step": _case_train_step}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_2d_pipeline_case_on_the_port(case, km2d, rng):
    """``tests/test_2d_pipeline.py``'s case of the same name with the port's
    objects (the weights are the port's seeded ones); none moves a kernel
    counter."""
    kernels.reset_counters()
    PIPELINE_CASES[case](km2d, rng)
    assert _counters_still(), kernels.counters()


# ---------------------------------------------------------------------------
# the 2D backbones against flax
# ---------------------------------------------------------------------------


BACKBONES = [
    ("unet2d", lambda: junet.UNet2D(**UNET), lambda **kw: UNet2D(**UNET, **kw), (1, 16, 20)),
    ("convnet2d", lambda: jconvnet.ConvNet(out_dim=K, dim=2, norm_type="instance"),
     lambda **kw: ConvNet(out_dim=K, dim=2, **kw), (1, 32, 48)),
    # a 2D backbone on volumes, as keymorph_tpu's register CLI runs it at
    # --dim 2: convs and pools per slice, norms over the volume
    ("unet2d_on_volumes", lambda: junet.UNet2D(**UNET), lambda **kw: UNet2D(**UNET, **kw),
     (2, 3, 16, 20)),
]


@pytest.mark.parametrize("case", BACKBONES, ids=[c[0] for c in BACKBONES])
def test_2d_backbone_heatmaps_and_keypoints_match_jax(case, rng):
    """fp32 heatmaps within HEATMAP_REL of their largest value, or within
    twice keymorph_tpu's distance from the float64 evaluation (the port's
    modules in float64), whichever is larger: the ConvNet's instance norm
    takes E[x^2] - mean^2 of single channels over few pixels, where flax's
    fp32 reduction lies far from float64. The center-of-mass keypoints of
    those heatmaps within KEYPOINT_ABS, or twice keymorph_tpu's distance from
    the port's float64 keypoints."""
    name, jctor, tctor, shape = case
    x = rng.uniform(0, 1, size=(shape[0], *shape[1:], 1)).astype(np.float32)
    jm = jctor()
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    want_kp = np.asarray(jkeymorph.center_of_mass(jnp.asarray(want)))
    sd = backbone_state_dict_from_flax(_np(variables["params"]))
    kernels.reset_counters()
    outs = {}
    for dtype in (torch.float32, torch.float64):
        tm = tctor(dtype=dtype)
        tm.load_state_dict(sd)  # strict
        with torch.no_grad():
            outs[dtype] = tm(torch.tensor(x).movedim(-1, 1)).movedim(1, -1)
    assert _counters_still()
    out, out64 = outs[torch.float32], outs[torch.float64]
    assert tuple(out.shape) == want.shape and out.dtype == torch.float32
    ref = float(out64.abs().max())
    err = float((out.double() - torch.tensor(want, dtype=torch.float64)).abs().max()) / ref
    err_jax = float(np.abs(want - out64.numpy()).max()) / ref
    from keymorph_tpu_torch.models.layers import center_of_mass

    kp, kp64 = center_of_mass(out), center_of_mass(out64.float())
    kerr = float(np.abs(kp.numpy() - want_kp).max())
    kerr_jax = float(np.abs(want_kp - kp64.numpy()).max())
    print(f"{name}: heatmaps rel {err:.3g} (keymorph_tpu from float64 {err_jax:.3g}); "
          f"keypoints {kerr:.3g} (keymorph_tpu from float64 {kerr_jax:.3g})")
    assert err <= max(HEATMAP_REL, 2.0 * err_jax)
    assert kerr <= max(KEYPOINT_ABS, 2.0 * kerr_jax)


def test_2d_weights_round_trip_through_both_importers(rng):
    """UNet2D and the 2D ConvNet: flax -> the port (``state_dict_from_flax``,
    HWIO -> OIHW) -> keymorph_tpu's ``import_torch_weights`` -> flax again,
    bit for bit; and the port's ``build_backbone`` at dim 2 builds the
    modules keymorph_tpu's does (UNet2D with f_maps 64)."""
    for jm, shape in ((junet.UNet2D(**UNET), (1, 16, 16, 1)),
                      (jconvnet.ConvNet(out_dim=K, dim=2), (1, 32, 32, 1))):
        params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros(shape)),
                            rng)["params"]
        sd = backbone_state_dict_from_flax(_np(params))
        if isinstance(jm, junet.UNet2D):
            assert sd["encoders.0.basic_module.SingleConv1.conv.weight"].shape == (2, 1, 3, 3)
        back = import_backbone_state_dict({k: v.numpy() for k, v in sd.items()}, params)
        flat, flat_back = (flax.traverse_util.flatten_dict(_np(t)) for t in (params, back))
        assert set(flat) == set(flat_back)
        for k in flat:
            np.testing.assert_array_equal(flat_back[k], flat[k], err_msg="/".join(k))
    unet = build_backbone(Config(num_keypoints=K, backbone="unet", dim=2))
    assert isinstance(unet, UNet2D) and unet.f_maps == [64, 128, 256, 512]
    jnet = jconfig.build_backbone(jconfig.Config(num_keypoints=K, backbone="unet", dim=2))
    assert isinstance(jnet, junet.UNet2D) and jnet.f_maps == 64
    conv = build_backbone(Config(num_keypoints=K, backbone="conv", dim=2))
    assert isinstance(conv, ConvNet) and conv.block1.conv.weight.shape == (32, 1, 3, 3)


# ---------------------------------------------------------------------------
# the 2D warp, the augmentation, align_pair
# ---------------------------------------------------------------------------


def test_2d_warp_matches_jax_grid_sample(rng):
    """``ops.resample.grid_sample`` on a 2D grid (the gather route,
    ``grid_sample_2d``) against keymorph_tpu's ``grid_sample``: bilinear
    within WARP_ABS, nearest bit for bit, on grids reaching past the border;
    the bilinear warp's gradients to the image and to the grid against
    jax.vjp within 1e-5 relative L2 (a clamp tie splits its gradient in
    half in both). 3D grids still take the warp kernel's wrapper."""
    img = rng.uniform(0, 1, size=(2, 3, 13, 17)).astype(np.float32)
    grid = rng.uniform(-1.15, 1.15, size=(2, 9, 11, 2)).astype(np.float32)
    kernels.reset_counters()
    for mode in ("bilinear", "nearest"):
        want = np.asarray(jresample.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode))
        got = resample.grid_sample(torch.tensor(img), torch.tensor(grid), mode=mode).numpy()
        if mode == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=WARP_ABS, rtol=0)
    cot = rng.normal(size=(2, 3, 9, 11)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g: jresample.grid_sample(a, g), jnp.asarray(img),
                     jnp.asarray(grid))
    want_gi, want_gg = (np.asarray(v) for v in vjp(jnp.asarray(cot)))
    ti, tg = torch.tensor(img, requires_grad=True), torch.tensor(grid, requires_grad=True)
    (resample.align_img(tg, ti) * torch.tensor(cot)).sum().backward()
    for got, want in ((ti.grad.numpy(), want_gi), (tg.grad.numpy(), want_gg)):
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert _counters_still()
    resample.grid_sample(torch.zeros((1, 1, 4, 4, 4)), torch.zeros((1, 2, 2, 2, 3)))
    assert kernels.counters()["warp_planes"]["plain_calls"] == 1


def test_2d_augmentation_matches_jax(rng):
    """``build_affine_matrix_2d`` (the (B, 3, 3) Shear @ Scale @ Translate @
    Rotation), the parameter layout of the fixed and random draws ((B, 2),
    (B, 2), (B, 1), (B, 2)), and the augmented image (bilinear), label map
    (nearest) and points, against keymorph_tpu's on the same parameters:
    within AUG_ABS, labels exactly."""
    B = 3
    params = [rng.uniform(lo, hi, size=(B, n)).astype(np.float32)
              for lo, hi, n in ((0.8, 1.2, 2), (-0.2, 0.2, 2), (-0.6, 0.6, 1), (-0.1, 0.1, 2))]
    want = np.asarray(jaugment.build_affine_matrix_2d(*(jnp.asarray(p) for p in params)))
    got = augment.build_affine_matrix([torch.tensor(p) for p in params], 2)
    np.testing.assert_allclose(got.numpy(), want, atol=AUG_ABS, rtol=0)
    for tp, jp in zip(augment.fixed_affine_params(B, 2, (0.1, 0.2, 0.3, 0.05)),
                      jaugment.fixed_affine_params(B, 2, (0.1, 0.2, 0.3, 0.05))):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    drawn = augment.sample_affine_params(torch.Generator().manual_seed(0), B, 2)
    assert [tuple(t.shape) for t in drawn] == [(B, 2), (B, 2), (B, 1), (B, 2)]

    img = _blobs(rng, n=B)
    seg = rng.integers(0, 4, size=(B, 1, *SPATIAL)).astype(np.float32)
    pts = rng.uniform(-0.8, 0.8, size=(B, 5, 2)).astype(np.float32)
    j_img, j_seg, j_pts, j_m = jaugment.affine_augment_with_params(
        jnp.asarray(img), [jnp.asarray(p) for p in params], seg=jnp.asarray(seg),
        points=jnp.asarray(pts), return_affine_matrix=True)
    kernels.reset_counters()
    t_img, t_seg, t_pts, t_m = augment.affine_augment_with_params(
        torch.tensor(img), [torch.tensor(p) for p in params], seg=torch.tensor(seg),
        points=torch.tensor(pts), return_affine_matrix=True)
    assert _counters_still()
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=AUG_ABS, rtol=0)
    np.testing.assert_array_equal(t_seg.numpy(), np.asarray(j_seg))
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), atol=AUG_ABS, rtol=0)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=AUG_ABS, rtol=0)


@pytest.mark.parametrize("align", ["rigid", "affine", "tps_0.1"])
def test_2d_align_pair_from_identical_keypoints_matches_jax(align, rng):
    """``align_pair`` at d = 2 from the same keypoints (and weights): the
    ``xy`` grid, the (B, 3, 3) matrix and the aligned points within
    GRID_ABS, and the grid's warp within WARP_ABS; in normalized and in
    real-world coordinates (anisotropic (B, 3, 3) pixel -> world affines,
    the moving one turned), the latter held to 1e-4 (a fit on millimetre
    coordinates in fp32 in both packages)."""
    B, T = 2, 10
    pf = rng.uniform(-0.7, 0.7, (B, T, 2)).astype(np.float32)
    pm = (pf + rng.normal(0, 0.05, (B, T, 2))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    img = _blobs(rng, n=B)
    align_type, lmbda = jkeymorph.parse_transform_type(align)
    lm = None if lmbda is None else np.full((B,), lmbda, np.float32)
    aff_f = np.diag([1.1, 0.9, 1.0]).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    aff_m = (np.array([[c, -s, 3.0], [s, c, -2.0], [0, 0, 1]]) @ np.diag([1.2, 1.0, 1.0]))
    affs = np.stack([aff_f] * B), np.stack([aff_m.astype(np.float32)] * B)
    kernels.reset_counters()
    for rw, tol in ((False, GRID_ABS), (True, 1e-4)):
        kw = dict(aff_f=affs[0], aff_m=affs[1]) if rw else {}
        want = jkeymorph.align_pair(jnp.asarray(pf), jnp.asarray(pm), align_type, SPATIAL,
                                    lmbda=None if lm is None else jnp.asarray(lm),
                                    weights=jnp.asarray(w), num_chunks=4,
                                    compute_aligned_points=True,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
        got = align_pair(torch.tensor(pf), torch.tensor(pm), align_type, SPATIAL,
                         lmbda=None if lm is None else torch.tensor(lm),
                         weights=torch.tensor(w), num_chunks=4, compute_aligned_points=True,
                         **{k: torch.tensor(v) for k, v in kw.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, rtol=0,
                                       err_msg=f"{align} rw={rw} {k}")
        warped = resample.align_img(got["grid"], torch.tensor(img)).numpy()
        jwarped = np.asarray(jresample.align_img(want["grid"], jnp.asarray(img)))
        np.testing.assert_allclose(warped, jwarped, atol=WARP_ABS + tol * 30, rtol=0)
    assert _counters_still()


# ---------------------------------------------------------------------------
# KeyMorph(dim=2) and the training step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(7)
    jnet = jkeymorph.KeyMorphNet(backbone=junet.UNet2D(**UNET), num_keypoints=K, dim=2)
    img = _blobs(rng)
    variables = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(4), jnp.asarray(img),
                                              jnp.asarray(img)), rng)
    return {"variables": variables, "f": img, "m": _blobs(rng)}


def test_keymorph_2d_forward_matches_jax(shared):
    """``KeyMorph(dim=2).forward`` with rigid, affine and tps_0.1 and the
    aligned points, on keymorph_tpu's weights (``load_flax_params``): the
    keypoints within KEYPOINT_ABS, and each grid, matrix and aligned point
    set within 1e-5 (the fits carry the keypoints' fp32 rounding); no kernel
    counter moves."""
    jkm = jkeymorph.KeyMorph(junet.UNet2D(**UNET), K, dim=2)
    jkm.params = shared["variables"]
    km = KeyMorph(UNet2D(**UNET), K, dim=2, device="cpu").load_flax_params(
        _np(shared["variables"]))
    types = ["rigid", "affine", "tps_0.1"]
    want = jkm(shared["f"], shared["m"], transform_type=types, return_aligned_points=True)
    kernels.reset_counters()
    got = km(shared["f"], shared["m"], transform_type=types, return_aligned_points=True)
    assert _counters_still()
    worst = 0.0
    for t in types:
        np.testing.assert_allclose(got[t]["points_f"].numpy(), np.asarray(want[t]["points_f"]),
                                   atol=KEYPOINT_ABS, rtol=0)
        for k in ("grid", "points_a") + (("matrix",) if t != "tps_0.1" else ()):
            d = float(np.abs(got[t][k].numpy() - np.asarray(want[t][k])).max())
            worst = max(worst, d)
            assert d <= 1e-5, (t, k, d)
    print(f"KeyMorph(dim=2): worst grid/matrix/points distance {worst:.3g}")


def _jax_draws(key, B, spec=None):
    """keymorph_tpu's step's draws from ``key``: augmentation parameters,
    lambda (TPS), keypoint subset."""
    k_aug, k_lmbda, k_sub = jax.random.split(key, 3)
    aug = jaugment.sample_affine_params(k_aug, B, 2, (0.1, 0.1, 0.3, 0.05), 1.0)
    lm = None if spec is None else np.asarray(jkeymorph.sample_tps_lmbda(k_lmbda, B, spec, 10.0))
    idx = np.array(jax.random.permutation(k_sub, K)[:SUB])
    return [torch.tensor(np.asarray(p)) for p in aug], lm, idx


def _jax_step(shared, transform_type, sameres):
    jnet = jkeymorph.KeyMorphNet(backbone=junet.UNet2D(**UNET), num_keypoints=K, dim=2)
    cfg = jconfig.Config(num_keypoints=K, transform_type=transform_type, loss_fn="mse", lr=1e-4,
                         dim=2, max_train_keypoints=SUB, img_size=SPATIAL,
                         max_random_affine_augment_params=(0.1, 0.1, 0.3, 0.05))
    tx = jtrain.make_optimizer(cfg)
    make = jtrain.make_train_step_sameres if sameres else jtrain.make_train_step
    step = make(jnet, cfg, tx)
    s1, m1 = step(jtrain.TrainState.create(shared["variables"], tx), jax.random.PRNGKey(KEY),
                  jnp.asarray(shared["f"]), jnp.asarray(shared["m"]), None, None,
                  jnp.float32(1.0))
    grads = state_dict_from_flax(_np(jax.tree_util.tree_map(lambda v: v / 0.1,
                                                            s1.opt_state[0].mu)))
    return float(m1["loss"]), float(m1["grad_norm"]), grads


# keymorph_tpu's make_train_step sends 2D TPS to its planes path, which
# unpacks three sizes and fails; its same-resolution step, at the images'
# own size (an identity resize), trains 2D TPS on the grid path. The port
# takes the grid path for 2D TPS in both factories.
STEP_CASES = [("affine", "make_train_step", False),
              ("tps_loguniform", "make_train_step", True),
              ("tps_loguniform", "make_train_step_sameres", True)]


@pytest.mark.parametrize("transform_type,factory,jax_sameres", STEP_CASES)
def test_2d_training_step_matches_jax(shared, transform_type, factory, jax_sameres):
    """One 2D step (MSE, augmentation (0.1, 0.1, 0.3, 0.05), 6 of 8
    keypoints) with keymorph_tpu's draws injected, on its weights: loss
    within LOSS_REL, grad_norm within GRAD_REL, every parameter's gradient
    within GRAD_REL relative L2 (against the larger of its own norm and 1e-3
    of the whole gradient's: a conv bias ahead of a GroupNorm has a gradient
    that is 0 up to rounding); no kernel counter moves."""
    spec = "loguniform" if transform_type.startswith("tps") else None
    loss_r, gn_r, want = _jax_step(shared, transform_type, jax_sameres)
    aug, lm, idx = _jax_draws(jax.random.PRNGKey(KEY), 2, spec)

    net = KeyMorphNet(UNet2D(**UNET), K, dim=2)
    net.load_state_dict(state_dict_from_flax(_np(shared["variables"])))
    cfg = Config(num_keypoints=K, transform_type=transform_type, loss_fn="mse", lr=1e-4, dim=2,
                 max_train_keypoints=SUB, img_size=SPATIAL,
                 max_random_affine_augment_params=(0.1, 0.1, 0.3, 0.05))
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    step = getattr(train, factory)(net, cfg)
    kernels.reset_counters()
    state, m1 = step(state, None, torch.tensor(shared["f"]), torch.tensor(shared["m"]), None,
                     None, 1.0, lmbda=None if lm is None else torch.tensor(lm),
                     keypoint_idx=idx, aug_params=aug)
    assert _counters_still(), kernels.counters()
    d_loss = abs(float(m1["loss"]) - loss_r) / abs(loss_r)
    d_gn = abs(float(m1["grad_norm"]) - gn_r) / gn_r
    whole = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    rel = {k: float(np.linalg.norm(p.grad.numpy() - want[k].numpy())
                    / max(np.linalg.norm(want[k].numpy()), 1e-3 * whole))
           for k, p in net.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"[{transform_type} {factory}] loss rel {d_loss:.3g}, grad_norm rel {d_gn:.3g}, "
          f"worst gradient {worst} {rel[worst]:.3g}")
    assert d_loss <= LOSS_REL and d_gn <= GRAD_REL
    assert rel[worst] <= GRAD_REL


def test_2d_pretrain_step_runs_on_images():
    """The pretrain step at dim 2: reference points sampled in 2D
    (``config.dim``), one step, a finite loss, no kernel counter."""
    from keymorph_tpu_torch.training.pretrain import make_pretrain_step, pick_reference_subject

    img = _blobs(np.random.default_rng(1), n=1)
    cfg = Config(num_keypoints=K, dim=2, lr=1e-4)
    _, pts, aff = pick_reference_subject([{"img": img}], cfg, seed=0)
    assert pts.shape == (1, K, 2) and aff is None
    net = KeyMorphNet(init_weights(UNet2D(**UNET), torch.Generator().manual_seed(3)), K, dim=2)
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    kernels.reset_counters()
    state, m = make_pretrain_step(net, cfg)(state, torch.Generator().manual_seed(0),
                                            torch.tensor(img), pts, 1.0)
    assert np.isfinite(float(m["loss"])) and state.step == 1 and _counters_still()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_2d_refusals_match_jax():
    """Where keymorph_tpu refuses a 2D case the port refuses too: the
    3D-only backbones at dim 2 (its factory asserts), the planes form of
    ``align_pair`` (its planes path unpacks three sizes), the displacement
    converters (3D fields only). (The CUDA wrappers' own refusal of a 2D
    CUDA tensor is held on the card, tests/test_torch_kernels_gpu.py.)"""
    for backbone in ("truncatedunet", "residualunet", "residualunetse"):
        with pytest.raises(AssertionError):
            jconfig.build_backbone(jconfig.Config(backbone=backbone, dim=2))
        with pytest.raises(ValueError, match="3D only"):
            build_backbone(Config(backbone=backbone, dim=2))
        with pytest.raises(ValueError, match="3D only"):
            build_model(Config(backbone=backbone, dim=2), device="cpu")
    p = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(ValueError):
        jkeymorph.align_pair(jnp.asarray(p), jnp.asarray(p), "tps", (8, 8), lmbda=jnp.ones(1),
                             compute_grid="planes")
    with pytest.raises(ValueError, match="3D only"):
        align_pair(torch.tensor(p), torch.tensor(p), "tps", (8, 8), lmbda=1.0,
                   compute_grid="planes")
    field = np.zeros((1, 8, 8, 2), np.float32)
    with pytest.raises(ValueError):
        jresample.displacement2flow(jnp.asarray(field))
    with pytest.raises((ValueError, TypeError)):
        jresample.flow2displacement(jnp.asarray(field))
    for fn in (resample.displacement2flow, resample.flow2displacement):
        with pytest.raises(ValueError, match="3D"):
            fn(torch.tensor(field))
    with pytest.raises(ValueError, match="2D or 3D"):
        KeyMorph(UNet2D(**UNET), K, dim=4, device="cpu")
