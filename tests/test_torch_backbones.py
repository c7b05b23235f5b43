"""Slice 8's backbones, heads, resize and reference-point sampling against
keymorph_tpu on the CPU.

Every backbone family the CLI builds (the U-Net in the layer orders 'gcr',
'bcr', 'gcl', 'cre'; the residual U-Net and its SE form; the ConvNet with
every ``norm_type``; the linear keypoint head) runs in fp32 through both
packages on the same seeded numpy volume and the same weights (flax-
initialized, norm affines and biases moved off their init, carried by
``tools/import_flax_params.py``): heatmaps within 1e-5 of their largest
value, every parameter's gradient of a fixed random projection of them
within 1e-4 relative L2, or within twice keymorph_tpu's own distance from
the float64 evaluation of the same net (the port's modules in float64),
whichever is larger: a norm of single channels over few voxels (the
ConvNet's instance and batch norms on 32 x 32 x 16) takes ``E[x^2] - mean^2`` with
cancellation, where flax's fp32 reduction lies ~50x further from float64
than the port's. The bf16 'cr' U-Net runs through the port's
executor (the conv kernels' plain versions on the CPU) against keymorph_tpu's
Pallas executor (interpret mode) and its flax module, held to their own
spread. The resize is held against ``jax.image.resize`` (1e-6 abs) and the
point sampler against keymorph_tpu's bit for bit.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu import utils as jutils
from keymorph_tpu.models import convnet as jconvnet
from keymorph_tpu.models import fast_unet as jfast_unet
from keymorph_tpu.models import unet as junet
from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu_torch import utils as tutils
from keymorph_tpu_torch.models import convnet as tconvnet
from keymorph_tpu_torch.models import unet as tunet
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.ops.resize import resize_trilinear
from keymorph_tpu_torch.tools.import_flax_params import (
    backbone_state_dict_from_flax,
    state_dict_from_flax,
)

HEATMAP_REL = 1e-5     # x max |heatmap|, fp32 in both packages
GRAD_REL = 1e-4        # relative L2 per parameter
RESIZE_ABS = 1e-6
K = 4


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


# (id, keymorph_tpu module, port module, input spatial shape)
UNET = dict(out_channels=K, f_maps=4, num_levels=2)
TRUNC = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
BACKBONES = [
    (f"unet_{o}", lambda o=o: junet.UNet3D(layer_order=o, **UNET),
     lambda o=o, **kw: tunet.UNet3D(layer_order=o, **UNET, **kw), (8, 8, 12))
    for o in ("gcr", "bcr", "gcl", "cre")
] + [
    ("truncated", lambda: junet.TruncatedUNet3D(**TRUNC),
     lambda **kw: tunet.TruncatedUNet3D(**TRUNC, **kw), (8, 8, 12)),
    ("residual", lambda: junet.ResidualUNet3D(**UNET),
     lambda **kw: tunet.ResidualUNet3D(**UNET, **kw), (8, 6, 10)),
    ("residual_se", lambda: junet.ResidualUNetSE3D(**UNET),
     lambda **kw: tunet.ResidualUNetSE3D(**UNET, **kw), (8, 6, 10)),
] + [
    (f"convnet_{nt}", lambda nt=nt: jconvnet.ConvNet(out_dim=K, norm_type=nt),
     lambda nt=nt, **kw: tconvnet.ConvNet(out_dim=K, norm_type=nt, **kw), (32, 32, 16))
    for nt in ("instance", "batch", "group", "none")
]


def _grad_rel(got, want):
    """Per-parameter relative L2 against the larger of the parameter's own
    gradient norm and 1e-3 of the whole gradient's: a conv bias ahead of an
    instance or batch norm has a gradient that is 0 up to rounding in either
    package."""
    whole = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    return {k: float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-3 * whole))
            for k, w in want.items()}


@pytest.mark.parametrize("case", BACKBONES, ids=[c[0] for c in BACKBONES])
def test_fp32_backbone_heatmaps_and_gradients_match_jax(case, rng):
    name, jctor, tctor, spatial = case
    x = rng.uniform(0, 1, size=(1, *spatial, 1)).astype(np.float32)
    jm = jctor()
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    out_shape = jax.eval_shape(jm.apply, variables, jnp.asarray(x)).shape
    proj = rng.normal(size=out_shape).astype(np.float32)

    def projected(v):
        y = jm.apply(v, jnp.asarray(x))
        return jnp.sum(y * proj), y

    (_, want), jgrads = jax.jit(jax.value_and_grad(projected, has_aux=True))(variables)
    want = np.asarray(want)

    sd = backbone_state_dict_from_flax(_np(variables["params"]))
    want_g = {k: v.numpy() for k, v in backbone_state_dict_from_flax(
        _np(jgrads["params"])).items()}

    def port(dtype):
        tm = tctor(dtype=dtype)
        tm.load_state_dict(sd)  # strict
        out = tm(torch.tensor(x).movedim(-1, 1)).movedim(1, -1)
        assert out.dtype == dtype and tuple(out.shape) == want.shape
        (out * torch.tensor(proj, dtype=dtype)).sum().backward()
        return out.detach().double().numpy(), {k: p.grad.numpy()
                                               for k, p in tm.named_parameters()}

    out, got_g = port(torch.float32)
    out64, g64 = port(torch.float64)
    ref = np.abs(out64).max()
    err, err_jax = np.abs(out - want).max() / ref, np.abs(want - out64).max() / ref
    assert set(got_g) == set(want_g)
    rel, rel_jax = _grad_rel(got_g, want_g), _grad_rel(want_g, g64)
    share = {k: rel[k] / max(GRAD_REL, 2.0 * rel_jax[k]) for k in rel}
    worst = max(share, key=share.get)
    print(f"{name}: heatmaps rel {err:.3g} (keymorph_tpu from float64 {err_jax:.3g}, port "
          f"{np.abs(out - out64).max() / ref:.3g}); gradients worst {worst} {rel[worst]:.3g} "
          f"(keymorph_tpu from float64 {rel_jax[worst]:.3g})")
    assert err <= max(HEATMAP_REL, 2.0 * err_jax)
    assert share[worst] <= 1.0


def test_linear_keypoint_head_matches_jax(rng):
    """KeyMorphNet with ``keypoint_layer="linear"`` on an fp32 U-Net: the
    keypoints (fp32 mean pool -> dense -> sigmoid * 2 - 1) and the gradient of
    every parameter, the head's dense included."""
    jnet = JKeyMorphNet(backbone=junet.UNet3D(out_channels=K, f_maps=4, num_levels=2),
                        num_keypoints=K, keypoint_layer="linear")
    img = rng.uniform(0, 1, size=(1, 1, 8, 8, 8)).astype(np.float32)
    variables = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(2), jnp.asarray(img),
                                              jnp.asarray(img)), rng)

    def keypoints(v):
        return jnet.apply(v, jnp.asarray(img), method=JKeyMorphNet.get_keypoints)

    proj = rng.normal(size=(1, K, 3)).astype(np.float32)

    def projected(v):
        p = keypoints(v)
        return jnp.sum(p * proj), p

    (_, want), jgrads = jax.jit(jax.value_and_grad(projected, has_aux=True))(variables)
    want = np.asarray(want)

    net = KeyMorphNet(tunet.UNet3D(out_channels=K, f_maps=4, num_levels=2), K,
                      keypoint_layer="linear")
    net.load_state_dict(state_dict_from_flax(_np(variables)))  # strict
    points = net.get_keypoints(torch.tensor(img))
    assert points.shape == (1, K, 3) and float(points.detach().abs().max()) < 1.0
    (points * torch.tensor(proj)).sum().backward()
    err = float(np.abs(points.detach().numpy() - want).max())
    want_g = {k: v.numpy() for k, v in state_dict_from_flax(_np(jgrads)).items()}
    rel = _grad_rel({k: p.grad.numpy() for k, p in net.named_parameters()}, want_g)
    print(f"linear head: keypoints max abs {err:.3g}; gradients worst {max(rel.values()):.3g}")
    assert err <= HEATMAP_REL
    assert max(rel.values()) <= GRAD_REL


def test_residual_unet_refuses_odd_skip_sizes_as_jax_does():
    """An odd size at a skip level (10 -> 5 -> 2 along z) leaves the
    transposed conv's output one voxel short of the skip: keymorph_tpu's sum
    raises, and so does the port (the reference's ConvTranspose3d refuses
    that output size too); even sizes join."""
    shape = (10, 8, 8)
    jm = junet.ResidualUNet3D(out_channels=K, f_maps=4, num_levels=3)
    with pytest.raises(TypeError, match="broadcast"):
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *shape, 1)))
    tm = tunet.ResidualUNet3D(out_channels=K, f_maps=4, num_levels=3)
    with pytest.raises(ValueError, match="odd skip"):
        tm(torch.zeros((1, 1, *shape)))
    assert tm(torch.zeros((1, 1, 8, 8, 12))).shape == (1, K, 8, 8, 12)


def test_bf16_cr_unet_executor_within_jax_spread(rng, monkeypatch):
    """The bf16 'cr' U-Net (no norm, conv biases) on the executor: no norm
    operands, the bias into the conv, no statistics emitted. Its heatmaps
    against keymorph_tpu's Pallas executor (interpret mode) and its flax
    module, each within 2x keymorph_tpu's own Pallas-vs-flax spread + 1e-3
    of the fp32 truth's max; its gradient against the fp32 module's within
    2x the port's bf16 module's distance from it + 1e-2 (relative L2 of the
    whole gradient)."""
    monkeypatch.setenv("KM_FORCE_FAST_CONV", "1")
    cfg = dict(out_channels=K, f_maps=8, num_levels=3, num_truncated_layers=1, layer_order="cr")
    jm = junet.TruncatedUNet3D(dtype=jnp.bfloat16, **cfg)
    img = rng.uniform(0, 1, size=(1, 1, 16, 16, 128)).astype(np.float32)
    x_cl = jnp.moveaxis(jnp.asarray(img), 1, -1)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(3), x_cl), rng)
    assert jfast_unet.supports_fast_unet(jm)
    truth = np.asarray(jax.jit(jm.clone(dtype=jnp.float32).apply)(variables, x_cl), np.float32)
    ref = np.abs(truth).max()
    flax_bf16 = np.asarray(jax.jit(jm.apply)(variables, x_cl.astype(jnp.bfloat16)), np.float32)
    pallas = np.asarray(jax.jit(lambda p, x: jfast_unet.fast_unet_forward(jm, p, x))(
        variables["params"], jnp.asarray(img)), np.float32)
    spread = np.abs(pallas - flax_bf16).max() / ref

    sd = backbone_state_dict_from_flax(_np(variables["params"]))
    unet = tunet.TruncatedUNet3D(dtype=torch.bfloat16, **cfg)
    unet.load_state_dict(sd)
    assert tunet.supports_fast_unet(unet)
    net = KeyMorphNet(unet, K)
    kernels.reset_counters()
    feat = net.features(torch.tensor(img))
    counts = kernels.counters()
    assert feat.dtype == torch.bfloat16 and tuple(feat.shape) == truth.shape
    assert counts["conv3x3_fused_flat"]["plain_calls"] > 0
    assert counts["conv3x3_fused_flat_upconv"]["plain_calls"] > 0
    got = feat.detach().float().numpy()
    bar = 2.0 * spread + 1e-3
    for name, other in (("pallas", pallas), ("flax bf16", flax_bf16), ("fp32 truth", truth)):
        d = np.abs(got - other).max() / ref
        print(f"'cr' executor vs keymorph_tpu {name}: {d:.3g} (spread {spread:.3g}, bar {bar:.3g})")
        assert d <= bar, name

    proj = torch.tensor(rng.normal(size=truth.shape).astype(np.float32))

    def grads(module_dtype, executor):
        u = tunet.TruncatedUNet3D(dtype=module_dtype, **cfg)
        u.load_state_dict(sd)
        f = KeyMorphNet(u, K).features(torch.tensor(img)) if executor \
            else u(torch.tensor(img)).movedim(1, -1)
        (f.float() * proj).sum().backward()
        return torch.cat([p.grad.ravel() for p in u.parameters()])

    g32, g_module, g_exec = grads(torch.float32, False), grads(torch.bfloat16, False), \
        grads(torch.bfloat16, True)
    d_exec = float((g_exec - g32).norm() / g32.norm())
    d_module = float((g_module - g32).norm() / g32.norm())
    print(f"'cr' gradient vs fp32: executor {d_exec:.3g}, bf16 module {d_module:.3g}")
    assert d_exec <= 2.0 * d_module + 1e-2


RESIDUAL_BF16 = [
    ("residual", junet.ResidualUNet3D, tunet.ResidualUNet3D),
    ("residual_se", junet.ResidualUNetSE3D, tunet.ResidualUNetSE3D),
]


@pytest.mark.parametrize("case", RESIDUAL_BF16, ids=[c[0] for c in RESIDUAL_BF16])
def test_bf16_residual_executor_within_jax_spread(case, rng):
    """The bf16 'gcr' residual U-Nets on the serving executor
    (``fast_resunet_forward``; its plain route, the kernels' plain versions,
    on the CPU) and on the port's bf16 module, against keymorph_tpu's bf16
    flax module on the same weights. keymorph_tpu has no kernel executor for
    these nets, so its own spread is its bf16 module's distance from the
    float64 evaluation of the same net (the port's module in float64): the
    executor and the port's module each lie within twice that of float64
    and of keymorph_tpu's bf16 heatmaps (x the float64 heatmaps' max)."""
    name, jcls, tcls = case
    cfg = dict(out_channels=K, f_maps=8, num_levels=3)
    jm = jcls(dtype=jnp.bfloat16, **cfg)
    img = rng.uniform(0, 1, size=(1, 1, 16, 16, 24)).astype(np.float32)
    x_cl = jnp.moveaxis(jnp.asarray(img), 1, -1)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(4), x_cl), rng)
    flax_bf16 = np.asarray(jax.jit(jm.apply)(variables, x_cl.astype(jnp.bfloat16)), np.float64)

    sd = backbone_state_dict_from_flax(_np(variables["params"]))
    n64 = tcls(dtype=torch.float64, **cfg)
    n64.load_state_dict(sd)  # strict
    unet = tcls(dtype=torch.bfloat16, **cfg)
    unet.load_state_dict(sd)
    assert tunet.supports_fast_resunet(unet)
    kernels.reset_counters()
    with torch.no_grad():
        truth = n64(torch.tensor(img, dtype=torch.float64)).movedim(1, -1).numpy()
        feat = KeyMorphNet(unet, K).features(torch.tensor(img), plain=True)
        module = unet(torch.tensor(img)).movedim(1, -1).float().numpy()
    counts = kernels.counters()
    assert counts["conv3x3_fused_flat_res"]["plain_calls"] == 2 * cfg["num_levels"] - 1
    assert counts["conv_transpose3x3s2_flat"]["plain_calls"] == cfg["num_levels"] - 1
    assert feat.dtype == torch.bfloat16 and tuple(feat.shape) == truth.shape
    got = feat.float().numpy()
    ref = np.abs(truth).max()
    spread = np.abs(flax_bf16 - truth).max() / ref
    assert spread > 0
    bar = 2.0 * spread
    for port_name, port in (("executor", got), ("bf16 module", module)):
        for other_name, other in (("flax bf16", flax_bf16), ("float64", truth)):
            d = np.abs(port - other).max() / ref
            print(f"{name} {port_name} vs {other_name}: {d:.3g} (keymorph_tpu from float64 "
                  f"{spread:.3g}, bar {bar:.3g})")
            assert d <= bar, (port_name, other_name)


def test_bf16_residual_executor_gradient_within_jax_spread(rng):
    """The gradient of the heatmaps' inner product with a fixed projection,
    over every parameter of a bf16 'gcr' ResidualUNetSE3D: the port's executor
    under autograd (``KeyMorphNet.features`` with grad enabled; its plain
    route on the CPU) against ``jax.grad`` of keymorph_tpu's bf16 flax module
    on the same weights. keymorph_tpu's own spread is its bf16 gradient's
    distance from the float64 module's (the port's module in float64): the
    executor's lies within twice that of keymorph_tpu's and of float64's
    (relative L2 over all leaves; bf16 rounding flips of an untrained net
    move a gradient by tens of percent in either package)."""
    cfg = dict(out_channels=K, f_maps=4, num_levels=3)
    jm = junet.ResidualUNetSE3D(dtype=jnp.bfloat16, **cfg)
    img = rng.uniform(0, 1, size=(1, 1, 16, 16, 16)).astype(np.float32)
    x_cl = jnp.moveaxis(jnp.asarray(img), 1, -1).astype(jnp.bfloat16)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(5), x_cl), rng)
    proj = rng.normal(size=(1, 16, 16, 16, K)).astype(np.float32)

    def inner(params):
        out = jm.apply({**variables, "params": params}, x_cl)
        return jnp.sum(out.astype(jnp.float32) * proj)

    g_jax = backbone_state_dict_from_flax(_np(jax.jit(jax.grad(inner))(variables["params"])))
    sd = backbone_state_dict_from_flax(_np(variables["params"]))

    def port(dtype, executor):
        u = tunet.ResidualUNetSE3D(dtype=dtype, **cfg)
        u.load_state_dict(sd)
        if dtype == torch.float64:
            u = u.double()
        x = torch.tensor(img, dtype=dtype if dtype == torch.float64 else torch.float32)
        f = KeyMorphNet(u, K).features(x) if executor else u(x).movedim(1, -1)
        (f.double() * torch.tensor(proj, dtype=torch.float64)).sum().backward()
        return {n: p.grad.double() for n, p in u.named_parameters()}

    kernels.reset_counters()
    g_exec = port(torch.bfloat16, True)
    assert kernels.counters()["conv_transpose3x3s2_input_grad"]["plain_calls"] == 2
    g64 = port(torch.float64, False)

    def flat(g):
        return torch.cat([g[n].double().ravel() for n in sorted(g64)])

    def d(a, b):
        return float((flat(a) - flat(b)).norm() / flat(b).norm())

    spread = d(g_jax, g64)
    print(f"residual_se gradient: executor vs keymorph_tpu {d(g_exec, g_jax):.3g}, vs float64 "
          f"{d(g_exec, g64):.3g}; keymorph_tpu vs float64 {spread:.3g}")
    assert 0 < spread
    assert d(g_exec, g_jax) <= 2 * spread and d(g_exec, g64) <= 2 * spread


@pytest.mark.parametrize("src,dst", [((14, 12, 10), (8, 8, 8)), ((6, 5, 7), (12, 16, 9)),
                                     ((20, 8, 9), (10, 8, 16))],
                         ids=["downsample", "upsample", "mixed"])
def test_resize_matches_jax_image_resize(src, dst, rng):
    """``ops/resize.py:resize_trilinear`` against
    ``jax.image.resize(method="trilinear")`` (antialiased): a kept axis is
    left alone, a shrunk one low-passed by the widened triangle."""
    x = rng.random((2, 3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *dst), method="trilinear"))
    got = resize_trilinear(torch.tensor(x), dst).numpy()
    err = float(np.abs(got - want).max())
    print(f"{src} -> {dst}: max abs {err:.3g}")
    assert got.shape == want.shape and err <= RESIZE_ABS


@pytest.mark.parametrize("kw", [dict(), dict(point_space="voxel", indexing="ij"),
                                dict(indexing="ij", seed=7)], ids=["norm_xy", "voxel_ij", "seed7"])
def test_sample_valid_coordinates_matches_jax_exactly(kw, rng):
    x = rng.random((1, 1, 10, 12, 14)).astype(np.float32)
    x[..., :3] = 0.0  # a region outside the support
    want = np.asarray(jutils.sample_valid_coordinates(x, 32, 3, **kw))
    got = tutils.sample_valid_coordinates(x, 32, 3, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
