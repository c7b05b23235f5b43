"""Self-supervised pretraining (keymorph_tpu_torch/training/pretrain.py)
against keymorph_tpu's, on the CPU.

The reference subject and its points come out of both packages'
``pick_reference_subject`` from the same batch. The pretrain step (augment
the image and the points with one affine -> keypoints of the augmented
image -> MSE -> backward -> Adam) runs in both packages on the same volume,
the same weights (tools/import_flax_params.py) and keymorph_tpu's
augmentation draw (``aug_params=``), in normalized and in real-world
coordinates. keymorph_tpu runs once with its Pallas kernels in interpret
mode (KM_FORCE_FAST_CONV=1, KM_FORCE_FAST_WARP=1) and once through XLA
(KM_NO_FAST_CONV, KM_NO_WARP_GRAD): its two modes' spread on this
ill-conditioned bf16 step is the yardstick, as in
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
from keymorph_tpu.training import pretrain as jpretrain
from keymorph_tpu.training import train as jtrain
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax
from keymorph_tpu_torch.training import pretrain, train
from keymorph_tpu_torch.training.config import Config

K = 8
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
SPATIAL = (16, 16, 128)
LR = 1e-4
KEY = 11
AUG_SCALE = 0.5
_JAX_ENV = {"pallas": {"KM_FORCE_FAST_CONV": "1", "KM_FORCE_FAST_WARP": "1"},
            "xla": {"KM_NO_FAST_CONV": "1", "KM_NO_WARP_GRAD": "1"}}
# a scanner affine: anisotropic voxels, turned about the first axis, shifted
AFFINE = np.array([[1.2, 0.0, 0.0, -10.0], [0.0, 0.9, -0.2, -7.0],
                   [0.0, 0.2, 0.9, -60.0], [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _volume(rng):
    """A smooth (1, 1, *SPATIAL) volume: two Gaussian blobs, a little noise,
    a background below the sampler's 0.1 support threshold."""
    axes = [np.linspace(-1, 1, s) for s in SPATIAL]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    v = np.exp(-((zz - 0.1) ** 2 + (yy + 0.2) ** 2 + (xx - 0.3) ** 2) / 0.3)
    v = v + 0.5 * np.exp(-((zz + 0.1) ** 2 + (yy - 0.4) ** 2 + (xx + 0.2) ** 2) / 0.1)
    return (v + 0.02 * rng.random(v.shape))[None, None].astype(np.float32)


def _batch(img, rw):
    return [{"img": img, "affine": AFFINE} if rw else {"img": img}]


@pytest.fixture(scope="module")
def jax_pretrain():
    """keymorph_tpu's reference subject and one pretrain step from it, per
    coordinate mode and reference mode: loss, gradient (from Adam's first
    moment, (1 - b1) g after one step) and the augmentation it drew."""
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
    img = _volume(rng)
    aug = jaugment.sample_affine_params(jax.random.PRNGKey(KEY), 1, 3, (0.2, 0.2, 3.1416, 0.1),
                                        AUG_SCALE)
    out = {"variables": variables, "img": img, "aug": _np(aug)}
    for rw in (False, True):
        jcfg = jconfig.Config(num_keypoints=K, lr=LR, align_keypoints_in_real_world_coords=rw)
        j_img, j_points, j_aff = jpretrain.pick_reference_subject(_batch(img, rw), jcfg, seed=3)
        for mode, env in _JAX_ENV.items():
            old = {k: os.environ.get(k) for names in _JAX_ENV.values() for k in names}
            for k in old:
                os.environ.pop(k, None)
            os.environ.update(env)
            try:
                tx = jtrain.make_optimizer(jcfg)
                step = jpretrain.make_pretrain_step(jnet, jcfg, tx)
                s1, m1 = step(jtrain.TrainState.create(variables, tx), jax.random.PRNGKey(KEY),
                              j_img, j_points, jnp.float32(AUG_SCALE), j_aff)
                grads = state_dict_from_flax(_np(jax.tree_util.tree_map(
                    lambda v: v / 0.1, s1.opt_state[0].mu)))
                out[(rw, mode)] = {"loss": float(m1["loss"]), "grads": grads}
            finally:
                for k, v in old.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
        out[rw] = {"img": np.asarray(j_img), "points": np.asarray(j_points),
                   "aff": None if j_aff is None else np.asarray(j_aff)}
    return out


@pytest.mark.parametrize("rw", [False, True], ids=["normalized", "real_world"])
def test_pick_reference_subject_matches_jax(jax_pretrain, rw):
    """The same subject and the same voxels (numpy's default_rng(seed) in
    both): normalized points bit for bit ([0, 1] xy -> [-1, 1] ij), real-world
    ones through the subject's affine within fp32 rounding of millimetres."""
    img = jax_pretrain["img"]
    want = jax_pretrain[rw]
    cfg = Config(num_keypoints=K, align_keypoints_in_real_world_coords=rw)
    got_img, got_points, got_aff = pretrain.pick_reference_subject(_batch(img, rw), cfg, seed=3)
    np.testing.assert_array_equal(got_img.numpy(), want["img"])
    assert got_points.shape == (1, K, 3) and got_points.dtype == torch.float32
    if rw:
        np.testing.assert_array_equal(got_aff.numpy(), want["aff"])
        np.testing.assert_allclose(got_points.numpy(), want["points"], rtol=0, atol=1e-5)
    else:
        assert got_aff is None
        np.testing.assert_array_equal(got_points.numpy(), want["points"])
        assert float(got_points.abs().max()) <= 1.0


def _whole_rel_l2(ga, gb):
    num = sum(float(((ga[k] - gb[k]) ** 2).sum()) for k in gb)
    return float(np.sqrt(num / sum(float((gb[k] ** 2).sum()) for k in gb)))


def _norm(g):
    return float(np.sqrt(sum(float((v ** 2).sum()) for v in g.values())))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("rw", [False, True], ids=["normalized", "real_world"])
def test_pretrain_step_matches_jax(jax_pretrain, rw, ref):
    """One pretrain step with keymorph_tpu's augmentation draw injected: the
    loss, the gradient's norm and the whole gradient (relative L2) lie no
    further from keymorph_tpu's than 2x its two modes' distance from each
    other, plus the floors of tests/test_torch_training.py (1e-3, 1e-2,
    5e-2). Every conv runs its plain version through the port's autograd
    Functions, the input-gradient one included; in real-world mode the
    predictions go to millimetres through the original affine."""
    want, other = jax_pretrain[(rw, ref)], jax_pretrain[(rw, "xla" if ref == "pallas" else "pallas")]
    pts = jax_pretrain[rw]
    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_np(jax_pretrain["variables"])))
    cfg = Config(num_keypoints=K, lr=LR, align_keypoints_in_real_world_coords=rw)
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    step = pretrain.make_pretrain_step(net, cfg)
    aug = tuple(torch.tensor(a) for a in jax_pretrain["aug"])
    aff = None if pts["aff"] is None else torch.tensor(pts["aff"])
    kernels.reset_counters()
    state, m = step(state, None, torch.tensor(pts["img"]), torch.tensor(pts["points"]),
                    AUG_SCALE, aff, aug_params=aug)
    counts = kernels.counters()
    assert state.step == 1 and set(m) == {"mse", "loss"}
    assert all(c["launches"] == 0 for c in counts.values())
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad"):
        assert counts[name]["plain_calls"] > 0, name
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(want["grads"])
    want_g = {k: v.numpy() for k, v in want["grads"].items()}
    other_g = {k: v.numpy() for k, v in other["grads"].items()}

    def rel(a, b):
        return abs(a - b) / abs(b)

    d_loss, y_loss = rel(float(m["loss"]), want["loss"]), rel(other["loss"], want["loss"])
    d_gn, y_gn = rel(_norm(got), _norm(want_g)), rel(_norm(other_g), _norm(want_g))
    whole, y_whole = _whole_rel_l2(got, want_g), _whole_rel_l2(other_g, want_g)
    print(f"[{'rw' if rw else 'norm'} {ref}] loss {float(m['loss']):.6g} vs {want['loss']:.6g}: "
          f"rel {d_loss:.3g} (references {y_loss:.3g}); grad_norm rel {d_gn:.3g} (references "
          f"{y_gn:.3g}); whole gradient rel L2 {whole:.3g} (references {y_whole:.3g})")
    assert d_loss <= 2.0 * y_loss + 1e-3
    assert d_gn <= 2.0 * y_gn + 1e-2
    assert whole <= 2.0 * y_whole + 5e-2


def test_run_pretrain_epoch(jax_pretrain):
    """``run_pretrain`` in debug mode: 3 steps at the affine-slope ramp's
    scale, keymorph_tpu's stats keys, parameters moved, draws from the
    generator (the same seed gives the same epoch)."""
    pts = jax_pretrain[False]
    cfg = Config(num_keypoints=K, lr=LR, debug_mode=True, affine_slope=4)

    def epoch():
        net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
        net.load_state_dict(state_dict_from_flax(_np(jax_pretrain["variables"])))
        state = train.TrainState.create(net, train.make_optimizer(cfg, net))
        before = [p.detach().clone() for p in net.parameters()]
        gen = torch.Generator().manual_seed(5)
        state, stats, gen = pretrain.run_pretrain(
            torch.tensor(pts["img"]), torch.tensor(pts["points"]), state,
            pretrain.make_pretrain_step(net, cfg), cfg, 2, gen)
        moved = all(not torch.equal(a, p) for a, p in zip(before, net.parameters()))
        return state, stats, moved

    state, stats, moved = epoch()
    assert state.step == 3 and moved
    assert set(stats) == {"mse", "loss", "epoch_time"}
    assert np.isfinite(stats["loss"]) and stats["loss"] == stats["mse"]
    assert epoch()[1]["loss"] == stats["loss"]
