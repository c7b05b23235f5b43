"""The same-resolution training step (keymorph_tpu_torch/training/train.py:
make_train_step_sameres) against keymorph_tpu's, on the CPU.

Both images come at an original resolution other than the model's
(``img_size``): after the augmentation they are resized to ``img_size`` for
keypoint extraction (ops/resize.py, antialiased as ``jax.image.resize``),
and the TPS flow, the warp and the MSE are taken at the original
resolution on the grid path. The step runs in both packages on the same
volumes, weights (tools/import_flax_params.py), lambda, keypoint subset and
augmentation draw (keymorph_tpu's, injected), in normalized and in
real-world coordinates (the augmentation composed into the moving affine).
keymorph_tpu runs once with its Pallas kernels in interpret mode and once
through its XLA VJPs; their spread is the yardstick, as in
tests/test_torch_training.py.
"""

import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu import augment as jaugment
from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.training import config as jconfig
from keymorph_tpu.training import train as jtrain
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax
from keymorph_tpu_torch.training import config as tconfig
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config

K, SUB = 8, 6
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
MODEL_SIZE = (16, 16, 128)
ORIGINAL = (20, 24, 150)
LR = 1e-4
KEY = 7
AUG_MAX = (0.05, 0.05, 0.1, 0.02)
_JAX_ENV = {"pallas": {"KM_FORCE_FAST_CONV": "1", "KM_FORCE_FAST_WARP": "1"},
            "xla": {"KM_NO_FAST_CONV": "1", "KM_NO_FAST_TPS": "1", "KM_NO_WARP_GRAD": "1"}}


def _affine(spacing, angle, shift):
    a = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    a[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]]) @ np.diag(spacing)
    a[:3, 3] = shift
    return a[None]


AFF_F = _affine((1.0, 0.9, 1.1), 0.0, (-10.0, -11.0, -80.0))
AFF_M = _affine((1.0, 0.9, 1.1), 0.05, (-9.0, -12.0, -79.0))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _blobs(rng):
    """A smooth fixed volume and a shifted moving one at ORIGINAL."""
    axes = [np.linspace(-1, 1, s) for s in ORIGINAL]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for cz, cy, cx in ((0.1, -0.2, 0.3), (-0.05, -0.1, 0.2)):
        v = np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 0.3)
        v = v + 0.5 * np.exp(-((zz + cz) ** 2 + (yy + 0.4) ** 2 + (xx + cx) ** 2) / 0.1)
        out.append((v + 0.02 * rng.random(v.shape))[None, None].astype(np.float32))
    return out


def _config(pkg, rw):
    return pkg.Config(num_keypoints=K, transform_type="tps_1.0", loss_fn="mse", lr=LR,
                      max_train_keypoints=SUB, img_size=MODEL_SIZE, train_same_resolution=True,
                      max_random_affine_augment_params=AUG_MAX,
                      align_keypoints_in_real_world_coords=rw)


@pytest.fixture(scope="module")
def jax_sameres():
    """keymorph_tpu's first same-resolution step per coordinate mode and
    reference mode (metrics and the gradient from Adam's first moment), and
    the draws it made: the augmentation and the keypoint subset."""
    rng = np.random.default_rng(0)
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG), num_keypoints=K,
                        compute_dtype=jnp.bfloat16)
    small = jnp.zeros((1, 1, 4, 4, 4), jnp.float32)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(1), small, small)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():  # GroupNorm affines away from (1, 0), never 0
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    variables = flax.traverse_util.unflatten_dict(flat)
    f, m = _blobs(rng)
    k_aug, _, k_sub = jax.random.split(jax.random.PRNGKey(KEY), 3)
    out = {"variables": variables, "f": f, "m": m,
           "aug": _np(jaugment.sample_affine_params(k_aug, 1, 3, AUG_MAX, 1.0)),
           "idx": np.array(jax.random.permutation(k_sub, K)[:SUB])}
    for rw in (False, True):
        jcfg = _config(jconfig, rw)
        affines = (jnp.asarray(AFF_F), jnp.asarray(AFF_M)) if rw else ()
        for mode, env in _JAX_ENV.items():
            old = {k: os.environ.get(k) for names in _JAX_ENV.values() for k in names}
            for k in old:
                os.environ.pop(k, None)
            os.environ.update(env)
            try:
                tx = jtrain.make_optimizer(jcfg)
                step = jtrain.make_train_step_sameres(jnet, jcfg, tx)
                s1, m1 = step(jtrain.TrainState.create(variables, tx), jax.random.PRNGKey(KEY),
                              jnp.asarray(f), jnp.asarray(m), None, None, jnp.float32(1.0),
                              *affines)
                out[(rw, mode)] = {
                    "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
                    "grads": state_dict_from_flax(_np(jax.tree_util.tree_map(
                        lambda v: v / 0.1, s1.opt_state[0].mu)))}
            finally:
                for k, v in old.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
    return out


def _whole_rel_l2(ga, gb):
    num = sum(float(((ga[k] - gb[k]) ** 2).sum()) for k in gb)
    return float(np.sqrt(num / sum(float((gb[k] ** 2).sum()) for k in gb)))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("rw", [False, True], ids=["normalized", "real_world"])
def test_sameres_step_matches_jax(jax_sameres, rw, ref):
    """One same-resolution step with keymorph_tpu's lambda (1), keypoint
    subset and augmentation: ``loss``, ``grad_norm`` and the whole gradient
    within 2x keymorph_tpu's own Pallas-vs-XLA spread plus the floors of
    tests/test_torch_training.py (1e-3, 1e-2, 5e-2). Through the port's
    autograd Functions on their plain versions: the conv forms and the input
    gradient, the TPS flow in points mode (the grid path) and the warp and
    its gradient; the planes kernels stay unused."""
    want, other = jax_sameres[(rw, ref)], jax_sameres[(rw, "xla" if ref == "pallas" else "pallas")]
    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_np(jax_sameres["variables"])))
    cfg = _config(tconfig, rw)
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    step = train.make_train_step_sameres(net, cfg)
    affines = (torch.tensor(AFF_F), torch.tensor(AFF_M)) if rw else ()
    kernels.reset_counters()
    state, m = step(state, None, torch.tensor(jax_sameres["f"]), torch.tensor(jax_sameres["m"]),
                    None, None, 1.0, *affines, keypoint_idx=jax_sameres["idx"],
                    aug_params=tuple(torch.tensor(a) for a in jax_sameres["aug"]))
    counts = kernels.counters()
    assert state.step == 1 and set(m) == {"loss", "mse", "grad_norm"}
    assert all(c["launches"] == 0 for c in counts.values())
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
                 "tps_flow", "warp_planes", "warp_planes_grad"):
        assert counts[name]["plain_calls"] > 0, name
    assert counts["tps_planes"]["plain_calls"] == counts["tps_planes_bwd"]["plain_calls"] == 0

    def rel(a, b):
        return abs(a - b) / abs(b)

    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(want["grads"])
    d_loss, y_loss = rel(float(m["loss"]), want["loss"]), rel(other["loss"], want["loss"])
    d_gn = rel(float(m["grad_norm"]), want["grad_norm"])
    y_gn = rel(other["grad_norm"], want["grad_norm"])
    whole = _whole_rel_l2(got, want["grads"])
    y_whole = _whole_rel_l2(other["grads"], want["grads"])
    print(f"[{'rw' if rw else 'norm'} {ref}] loss {float(m['loss']):.6g} vs {want['loss']:.6g}: "
          f"rel {d_loss:.3g} (references {y_loss:.3g}); grad_norm rel {d_gn:.3g} (references "
          f"{y_gn:.3g}); whole gradient rel L2 {whole:.3g} (references {y_whole:.3g})")
    assert d_loss <= 2.0 * y_loss + 1e-3
    assert d_gn <= 2.0 * y_gn + 1e-2
    assert whole <= 2.0 * y_whole + 5e-2


def test_sameres_at_the_model_size_is_the_plain_step(jax_sameres):
    """Where the volumes already have the model's size (what the CLI feeds
    it: ``get_data`` resizes on load), the resize is the identity and the
    same-resolution step equals the canonical step on the grid path: same
    loss and gradients bit for bit as ``make_train_step`` in real-world mode
    with the identity affines (which takes the grid path too)."""
    rng = np.random.default_rng(1)
    img_f = torch.tensor(rng.random((1, 1, *MODEL_SIZE)).astype(np.float32))
    img_m = img_f.flip(4)
    out = []
    for make in (train.make_train_step_sameres, train.make_train_step):
        net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
        net.load_state_dict(state_dict_from_flax(_np(jax_sameres["variables"])))
        cfg = Config(num_keypoints=K, transform_type="tps_1.0", lr=LR, max_train_keypoints=SUB,
                     img_size=MODEL_SIZE, align_keypoints_in_real_world_coords=True)
        state = train.TrainState.create(net, train.make_optimizer(cfg, net))
        eye = torch.eye(4)[None]
        _, m = make(net, cfg)(state, None, img_f, img_m, None, None, 1.0, eye, eye,
                              keypoint_idx=jax_sameres["idx"])
        out.append((float(m["loss"]), [p.grad.clone() for p in net.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
