"""The port's U-Net module and kernel executor (keymorph_tpu_torch/models/
unet.py, fast_unet.py) and the flax parameter import
(tools/import_flax_params.py), on weights carried from keymorph_tpu.

On the CPU the executor's convs run their plain versions. keymorph_tpu's
executor runs its Pallas conv in interpret mode (KM_FORCE_FAST_CONV=1), as
its own tests run it.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu.models import fast_unet as jfast_unet
from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.tools.import_torch_weights import import_backbone_state_dict
from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.tools.import_flax_params import (
    backbone_state_dict_from_flax,
    state_dict_from_flax,
)

CFG = dict(out_channels=8, f_maps=4, num_levels=3, num_truncated_layers=1)
IMG_SHAPE = (1, 1, 16, 16, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net_and_params(rng, weight_keypoints=None):
    """keymorph_tpu KeyMorphNet (bf16 backbone) with flax-initialized convs
    and GroupNorm affines perturbed away from (1, 0) by numpy noise (scale
    stays near 1, never 0)."""
    backbone = JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG)
    net = JKeyMorphNet(backbone=backbone, num_keypoints=CFG["out_channels"],
                       compute_dtype=jnp.bfloat16, weight_keypoints=weight_keypoints)
    img = jnp.zeros((1, 1, 4, 4, 4), jnp.float32)  # parameters do not depend on it
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), img, img)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():
        if path[-2] == "GroupNorm_0" or path[-1] in ("scales", "biases"):
            noise = rng.normal(size=v.shape).astype(np.float32)
            base = 1.0 if path[-1] in ("scale", "scales") else 0.0
            flat[path] = jnp.asarray(base + 0.2 * noise)
        elif path[-2:] == ("Conv_0", "bias"):
            flat[path] = jnp.asarray(0.1 * rng.normal(size=v.shape).astype(np.float32))
    return net, flax.traverse_util.unflatten_dict(flat)


def _port_unet(state_dict):
    unet = TruncatedUNet3D(dtype=torch.bfloat16, **CFG)
    unet.load_state_dict(state_dict)
    return unet


def test_state_dict_round_trips_through_torch_importer(rng):
    """state_dict_from_flax -> keymorph_tpu's import_backbone_state_dict gives
    back the flax tree exactly (the two mappings are inverses)."""
    _, variables = _jax_net_and_params(rng)
    backbone = variables["params"]["backbone"]
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    back = import_backbone_state_dict(sd, backbone)
    a = flax.traverse_util.flatten_dict(backbone)
    b = flax.traverse_util.flatten_dict(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=str(k))
    # ... and the port's modules take it with every key accounted for
    _port_unet(backbone_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, backbone)))


def test_keymorphnet_state_dict_keys(rng):
    """The full KeyMorphNet tree maps onto the port's KeyMorphNet, variance
    weighting parameters included."""
    _, variables = _jax_net_and_params(rng, weight_keypoints="variance")
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), CFG["out_channels"],
                      weight_keypoints="variance")
    net.load_state_dict(sd)  # strict: no missing or unexpected keys
    np.testing.assert_array_equal(net.scales.detach().numpy(),
                                  np.asarray(variables["params"]["scales"]))


def test_keymorphnet_rejects_backbones_the_executor_cannot_run(rng):
    """The executor behind ``KeyMorphNet.features`` refuses every backbone
    outside keymorph_tpu's ``supports_fast_unet`` (fp32, another layer order,
    residual blocks, a ConvNet) before any conv runs, so
    ``features`` never hands it one."""
    from keymorph_tpu_torch.models.convnet import ConvNet
    from keymorph_tpu_torch.models.unet import ResidualUNet3D, supports_fast_unet
    from keymorph_tpu_torch.ops import cuda as kernels

    img = torch.tensor(rng.uniform(0, 1, size=(1, 1, 8, 8, 8)).astype(np.float32))
    refused = (TruncatedUNet3D(dtype=torch.float32, **CFG),
               TruncatedUNet3D(dtype=torch.bfloat16, layer_order="bcr", **CFG),
               ResidualUNet3D(CFG["out_channels"], num_levels=2, f_maps=4, dtype=torch.bfloat16),
               ConvNet(CFG["out_channels"], dtype=torch.bfloat16))
    kernels.reset_counters()
    for backbone in refused:
        assert not supports_fast_unet(backbone)
        with pytest.raises(ValueError, match="executor runs bf16 'gcr'/'cr'"):
            fast_unet_forward(backbone, img)
    assert all(c["launches"] == 0 and c["plain_calls"] == 0
               for c in kernels.counters().values())


def test_keymorphnet_takes_module_path_for_non_executor_backbones(rng):
    """An fp32 U-Net's heatmaps are its module's forward (as keymorph_tpu's
    ``features`` applies the flax module there), channel-last and bit for
    bit, and no conv of the executor runs."""
    from keymorph_tpu_torch.ops import cuda as kernels

    g = torch.Generator().manual_seed(0)
    from keymorph_tpu_torch.models.unet import init_weights

    unet = init_weights(TruncatedUNet3D(dtype=torch.float32, **CFG), g)
    net = KeyMorphNet(unet, CFG["out_channels"])
    img = torch.tensor(rng.uniform(0, 1, size=(1, 1, 8, 8, 8)).astype(np.float32))
    kernels.reset_counters()
    with torch.no_grad():
        feat = net.features(img)
        want = unet(img).movedim(1, -1)
    assert feat.dtype == torch.float32 and feat.shape == (1, 4, 4, 4, CFG["out_channels"])
    torch.testing.assert_close(feat, want, atol=0, rtol=0)
    assert all(c["launches"] == 0 and c["plain_calls"] == 0
               for c in kernels.counters().values())


def test_heatmaps_within_bf16_noise_of_jax(rng, monkeypatch):
    """The port's module and executor against keymorph_tpu's flax apply and
    fast_unet_forward (Pallas conv forced, interpret mode), all held to the
    bar of tests/test_fast_unet.py: deviation from the fp32 flax truth at
    most 2x the flax bf16 path's own deviation + 1e-3 (relative to the
    heatmaps' max). bf16 U-Nets carry real rounding noise; the claim is the
    same arithmetic, not bit equality."""
    monkeypatch.setenv("KM_FORCE_FAST_CONV", "1")
    net, variables = _jax_net_and_params(rng)
    backbone = net.backbone
    bparams = {"params": variables["params"]["backbone"]}
    img = rng.uniform(0, 1, size=IMG_SHAPE).astype(np.float32)
    x_cl = jnp.moveaxis(jnp.asarray(img), 1, -1)
    # whole-program jit: one compile instead of op-by-op dispatch
    truth = np.asarray(jax.jit(backbone.clone(dtype=jnp.float32).apply)(bparams, x_cl),
                       np.float32)
    ref = np.abs(truth).max() + 1e-6
    flax_bf16 = np.asarray(jax.jit(backbone.apply)(bparams, x_cl.astype(jnp.bfloat16)),
                           np.float32)
    noise = np.abs(flax_bf16 - truth).max() / ref
    jfast = np.asarray(jax.jit(lambda p, x: jfast_unet.fast_unet_forward(backbone, p, x))(
        bparams["params"], jnp.asarray(img)), np.float32)

    unet = _port_unet(backbone_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]["backbone"])))
    timg = torch.tensor(img)
    with torch.no_grad():  # serving: nothing is kept for a backward
        module = torch.movedim(unet(timg), 1, -1).float().numpy()
        executor = fast_unet_forward(unet, timg)
    assert executor.dtype == torch.bfloat16
    executor = executor.float().numpy()
    assert executor.shape == truth.shape == module.shape
    bar = 2.0 * noise + 1e-3
    for name, got in (("jax fast_unet", jfast), ("port module", module),
                      ("port executor", executor)):
        err = np.abs(got - truth).max() / ref
        print(f"{name}: rel err {err:.3g} (flax bf16 noise {noise:.3g})")
        assert err <= bar, (name, err, noise)
    # the executor and keymorph_tpu's executor share every GN/fold step:
    # they agree to the same bar around each other
    assert np.abs(executor - jfast).max() / ref <= bar


def test_executor_parts_fallback_on_odd_sizes(rng):
    """Where a skip is not exactly twice the deeper tensor (odd sizes: 10 ->
    5 -> 2 along z), the executor materializes the nearest resize and runs
    the concat-free parts conv. Held against the fp32 flax truth under the
    same 2 x noise + 1e-3 bar (keymorph_tpu's flax path handles odd sizes;
    its Pallas executor does not)."""
    from keymorph_tpu_torch.ops.cuda import conv3d

    net, variables = _jax_net_and_params(rng)
    backbone = net.backbone
    bparams = {"params": variables["params"]["backbone"]}
    img = rng.uniform(0, 1, size=(1, 1, 10, 12, 20)).astype(np.float32)
    x_cl = jnp.moveaxis(jnp.asarray(img), 1, -1)
    truth = np.asarray(jax.jit(backbone.clone(dtype=jnp.float32).apply)(bparams, x_cl),
                       np.float32)
    ref = np.abs(truth).max() + 1e-6
    flax_bf16 = np.asarray(jax.jit(backbone.apply)(bparams, x_cl.astype(jnp.bfloat16)),
                           np.float32)
    noise = np.abs(flax_bf16 - truth).max() / ref
    unet = _port_unet(backbone_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]["backbone"])))
    calls = conv3d.conv3x3_fused_flat_parts_plain.calls
    with torch.no_grad():
        got = fast_unet_forward(unet, torch.tensor(img)).float().numpy()
    assert conv3d.conv3x3_fused_flat_parts_plain.calls == calls + 1
    assert got.shape == truth.shape
    assert np.abs(got - truth).max() / ref <= 2.0 * noise + 1e-3


def test_executor_plain_flag_matches_default_on_cpu(rng):
    """plain=True routes the convs through their plain versions explicitly;
    on CPU tensors the wrappers do so anyway, so the results are identical."""
    g = torch.Generator().manual_seed(0)
    from keymorph_tpu_torch.models.unet import init_weights

    unet = init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), g)
    img = torch.tensor(rng.uniform(0, 1, size=(1, 1, 8, 8, 16)).astype(np.float32))
    with torch.no_grad():
        a = fast_unet_forward(unet, img)
        b = fast_unet_forward(unet, img, plain=True)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
