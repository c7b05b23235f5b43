"""The port's training step for affine, rigid and real-world-coordinate
registration against keymorph_tpu's, and ``run_train``'s real-world
affines.

Each case runs one step in both packages on the same numpy volumes, the
same weights (carried by tools/import_flax_params.py), the same lambda
(``tps_0.1``) and the keypoint subset keymorph_tpu drew. These steps take
the grid path in both packages: ``align_pair(compute_grid=True)`` then
``align_img``. The bars follow tests/test_torch_training.py: twice a spread
of keymorph_tpu's own two modes, plus a floor. The two modes here are its
bf16 backbone (``use_amp``, the reference's AMP) and its fp32 backbone,
both through XLA: its Pallas kernels in interpret mode take about 70 s a
step on one CPU thread, which four cases cannot afford.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.training import config as jconfig
from keymorph_tpu.training import train as jtrain
from keymorph_tpu_torch import augment
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config

K, SUB = 8, 6
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
SPATIAL = (16, 16, 64)
LR = 1e-4
KEY = 5
CASES = [("affine", False), ("rigid", False), ("affine", True), ("tps_0.1", True)]
YARD_CAP = 0.25  # the step test's yardstick term, at most this share of the reference's norm


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _affines():
    """Anisotropic voxel -> world affines (tests/test_keymorph_rw.py's), the
    moving one also rotated, (1, 4, 4)."""
    aff_f = np.eye(4, dtype=np.float32)
    aff_f[:3, :3] = np.diag([1.0, 1.25, 2.0])
    aff_f[:3, 3] = [-40, -50, 30]
    c, s = np.cos(0.1), np.sin(0.1)
    aff_m = np.eye(4, dtype=np.float32)
    aff_m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag([1.1, 1.2, 1.9])
    aff_m[:3, 3] = [-42, -48, 28]
    return aff_f[None], aff_m[None]


def _blobs(rng):
    axes = [np.linspace(-1, 1, s) for s in SPATIAL]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for cz, cy, cx in ((0.1, -0.2, 0.3), (-0.05, -0.1, 0.2)):
        v = np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 0.3)
        v = v + 0.5 * np.exp(-((zz + cz) ** 2 + (yy + 0.4) ** 2 + (xx + cx) ** 2) / 0.1)
        if rng is not None:
            v = v + 0.02 * rng.random(v.shape)
        out.append(v[None, None].astype(np.float32))
    return out


def _variables(rng):
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG), num_keypoints=K,
                        compute_dtype=jnp.bfloat16)
    small = jnp.zeros((1, 1, 4, 4, 4), jnp.float32)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(1), small, small)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():  # GroupNorm affines away from (1, 0), never 0
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    return flax.traverse_util.unflatten_dict(flat)


def _subset(seed):
    """The keypoint subset keymorph_tpu's step draws from PRNGKey(seed)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    return np.array(jax.random.permutation(key, K)[:SUB])


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    f, m = _blobs(rng)
    return {"variables": _variables(rng), "f": f, "m": m}


def _jax_step(shared, transform_type, rw, dtype):
    """keymorph_tpu's first step through XLA with a ``dtype`` backbone:
    loss, grad_norm and the gradients (Adam's first moment / (1 - b1))."""
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=dtype, **CFG), num_keypoints=K,
                        compute_dtype=dtype)
    jcfg = jconfig.Config(num_keypoints=K, transform_type=transform_type, loss_fn="mse", lr=LR,
                          max_train_keypoints=SUB, align_keypoints_in_real_world_coords=rw)
    tx = jtrain.make_optimizer(jcfg)
    step = jtrain.make_train_step(jnet, jcfg, tx)
    args = (jnp.asarray(shared["f"]), jnp.asarray(shared["m"]), None, None, jnp.float32(1.0))
    if rw:
        args += tuple(jnp.asarray(a) for a in _affines())
    s1, m1 = step(jtrain.TrainState.create(shared["variables"], tx), jax.random.PRNGKey(KEY),
                  *args)
    grads = state_dict_from_flax(_to_np(jax.tree_util.tree_map(lambda v: v / 0.1,
                                                               s1.opt_state[0].mu)))
    return float(m1["loss"]), float(m1["grad_norm"]), grads


def _whole_rel_l2(ga, gb):
    num = sum(float(((ga[k] - gb[k]) ** 2).sum()) for k in gb)
    return float(np.sqrt(num / sum(float((gb[k] ** 2).sum()) for k in gb)))


@pytest.mark.parametrize("transform_type,rw", CASES)
def test_training_step_matches_jax(shared, transform_type, rw, monkeypatch):
    """One step against keymorph_tpu's bf16 step (XLA). Yardstick: the same
    step with keymorph_tpu's fp32 backbone. ``loss``, ``grad_norm``, the
    whole gradient (relative L2) and each parameter's gradient (L2 distance)
    lie no further from the bf16 reference than twice the yardstick's
    distance from it, plus test_torch_training.py's floors (loss 1e-3,
    grad_norm 1e-2, gradients 5e-2 of their norm, and 5e-3 of the whole
    gradient's norm for a single parameter). For the whole gradient and
    each parameter's, the yardstick's term is capped at YARD_CAP of the
    reference's norm: the yardstick reads 0.45-0.52 there, near what a zero
    gradient reads (1.0). So a zero gradient fails the whole bar (at most
    0.3) and the bar of every parameter whose gradient holds more than 0.7%
    of the whole gradient's norm. Measured (printed): whole gradient
    0.030-0.039 from the reference; the worst parameter at 0.33-0.43 of its
    bar. (The first GroupNorm's weight lies 0.63 of its own norm away: its
    gradient nearly cancels, and the 5e-3 floor holds it.) (The step is
    ill-conditioned either way: the bf16 step on volumes moved by half a
    bf16 ulp lies 0.34-0.53 from it.) The alignment's own gradient is held
    in fp32 by test_alignment_gradient_matches_jax."""
    monkeypatch.delenv("KM_FORCE_FAST_CONV", raising=False)
    monkeypatch.delenv("KM_FORCE_FAST_WARP", raising=False)
    for name in ("KM_NO_FAST_CONV", "KM_NO_FAST_TPS", "KM_NO_WARP_GRAD"):
        monkeypatch.setenv(name, "1")
    loss_r, gn_r, want = _jax_step(shared, transform_type, rw, jnp.bfloat16)
    loss_y, gn_y, other = _jax_step(shared, transform_type, rw, jnp.float32)

    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_to_np(shared["variables"])))
    cfg = Config(num_keypoints=K, transform_type=transform_type, loss_fn="mse", lr=LR,
                 max_train_keypoints=SUB, align_keypoints_in_real_world_coords=rw)
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    step = train.make_train_step(net, cfg)
    aff = tuple(torch.tensor(a) for a in _affines()) if rw else ()
    kernels.reset_counters()
    state, m1 = step(state, None, torch.tensor(shared["f"]), torch.tensor(shared["m"]), None,
                     None, 1.0, *aff, keypoint_idx=_subset(KEY))
    assert state.step == 1 and set(m1) == {"loss", "mse", "grad_norm"}
    counts = kernels.counters()
    for name in ("conv3x3_fused_flat", "conv3x3_input_grad", "warp_planes", "warp_planes_grad"):
        assert counts[name]["plain_calls"] > 0, name
    assert counts["tps_flow"]["plain_calls"] == (1 if transform_type.startswith("tps") else 0)
    assert counts["tps_planes"]["plain_calls"] == 0  # the grid path

    def rel(a, b):
        return abs(a - b) / abs(b)

    got = {k: p.grad for k, p in net.named_parameters()}
    d_loss, y_loss = rel(float(m1["loss"]), loss_r), rel(loss_y, loss_r)
    d_gn, y_gn = rel(float(m1["grad_norm"]), gn_r), rel(gn_y, gn_r)
    whole, y_whole = _whole_rel_l2(got, want), _whole_rel_l2(other, want)
    print(f"[{transform_type} rw={rw}] loss rel {d_loss:.3g} (yardstick {y_loss:.3g}); "
          f"grad_norm rel {d_gn:.3g} ({y_gn:.3g}); whole gradient rel L2 {whole:.3g} "
          f"({y_whole:.3g})")
    assert d_loss <= 2.0 * y_loss + 1e-3
    assert d_gn <= 2.0 * y_gn + 1e-2
    assert whole <= min(2.0 * y_whole, YARD_CAP) + 5e-2
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    worst = 0.0
    for k, g in got.items():
        w, o = want[k].numpy(), other[k].numpy()
        err, yard = np.linalg.norm(g.numpy() - w), np.linalg.norm(o - w)
        own = np.linalg.norm(w)
        bar = min(2.0 * yard, YARD_CAP * own) + 5e-2 * own + 5e-3 * total
        worst = max(worst, err / bar)
        assert err <= bar, (k, err, bar)
    print(f"[{transform_type} rw={rw}] worst share of a parameter's bar {worst:.3g}")


def _jax_alignment(transform_type, rw, dtype, pf, pm, w):
    """keymorph_tpu's ``align_pair(compute_grid=True)`` + ``align_img`` (XLA)
    in ``dtype`` on the smooth volumes: the MSE and its gradient to the
    keypoints and their weights."""
    from keymorph_tpu.losses import mse_loss as jmse
    from keymorph_tpu.models.keymorph import align_pair as jalign_pair
    from keymorph_tpu.ops.resample import align_img as jalign_img

    f_img, m_img = (jnp.asarray(v, dtype) for v in _blobs(None))
    align_type, lmbda = ("tps", 0.1) if transform_type.startswith("tps") else (transform_type, None)
    aff_f, aff_m = (jnp.asarray(a, dtype) for a in _affines()) if rw else (None, None)

    def loss(pf, pm, w):
        lm = None if lmbda is None else jnp.full((1,), lmbda, dtype)
        grid = jalign_pair(pf, pm, align_type, SPATIAL, lmbda=lm, weights=w, compute_grid=True,
                           aff_f=aff_f, aff_m=aff_m, moving_shape=SPATIAL,
                           allow_pallas=False)["grid"]
        return jmse(f_img, jalign_img(grid, m_img, allow_pallas=False))

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (pf, pm, w)))
    return float(value), [np.asarray(g, np.float64) for g in grads]


@pytest.mark.parametrize("transform_type,rw", CASES)
def test_alignment_gradient_matches_jax(transform_type, rw, monkeypatch):
    """The part of the step this slice adds, held on its own in fp32: the
    MSE of ``align_img(align_pair(compute_grid=True)["grid"], m)`` against
    ``f`` and its gradient to the keypoints and their weights, against
    jax.grad of keymorph_tpu's ``align_pair`` + ``align_img`` (XLA) on the
    same numpy inputs. The fit, the real-world conversions, the rigid SVD's
    backward, the spline and the warp's gradient to the grid all lie on
    this path.

    Yardstick: how far keymorph_tpu's own fp32 answer lies from the same
    computation with float64 enabled (its solvers still fit in fp32): for
    the loss, and for the gradients the largest of the three. The loss and
    each gradient (relative L2) lie within twice that, plus a floor of 1e-5
    (the mean of 16k fp32 squares summed in another order). A gradient with
    one axis dropped reads about 0.5. Measured (loss; gradients; gradient
    bar): affine 2.8e-6; 3.0e-6-1.2e-5; 1.9e-5. Rigid 4.0e-6; 1.1e-6-1.6e-6;
    1.3e-5. Real-world tps_0.1 3.7e-7; 3.7e-6-8.4e-6; 4.5e-5. Real-world
    affine 1.8e-5; 5.4e-4-6.4e-4; 2.6e-3: both packages fit the affine in
    fp32 on millimetre coordinates, and keymorph_tpu's gradients there lie
    up to 1.3e-3 from its float64 run. The moving keypoints are a turned,
    scaled copy of the fixed ones: near the identity the samples sit on
    voxel centres, where the warp's gradient to the grid jumps and either
    package's fp32 rounding picks a side (the rigid gradients then read
    2e-4 apart)."""
    for name in ("KM_NO_FAST_CONV", "KM_NO_FAST_TPS", "KM_NO_WARP_GRAD"):
        monkeypatch.setenv(name, "1")
    from keymorph_tpu_torch.losses import mse_loss
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_img

    rng = np.random.default_rng(3)
    pf = rng.uniform(-0.7, 0.7, (1, K, 3)).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    turn = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag([1.05, 0.95, 1.0])
    pm = (pf @ turn.T + [0.03, -0.02, 0.05] + rng.normal(0.0, 0.02, pf.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (1, K)).astype(np.float32)

    loss_j, grads_j = _jax_alignment(transform_type, rw, jnp.float32, pf, pm, w)
    with jax.enable_x64(True):
        loss_64, grads_64 = _jax_alignment(transform_type, rw, jnp.float64, pf, pm, w)

    args = [torch.tensor(a, requires_grad=True) for a in (pf, pm, w)]
    align_type, lmbda = ("tps", 0.1) if transform_type.startswith("tps") else (transform_type, None)
    aff_f, aff_m = (torch.tensor(a) for a in _affines()) if rw else (None, None)
    f_img, m_img = (torch.tensor(v) for v in _blobs(None))
    grid = align_pair(args[0], args[1], align_type, SPATIAL,
                      lmbda=None if lmbda is None else torch.full((1,), lmbda),
                      weights=args[2], compute_grid=True, aff_f=aff_f, aff_m=aff_m,
                      moving_shape=SPATIAL)["grid"]
    loss = mse_loss(f_img, align_img(grid, m_img))
    loss.backward()

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))

    d_loss, y_loss = abs(loss.item() - loss_j) / abs(loss_j), abs(loss_j - loss_64) / abs(loss_64)
    errs = {name: rel(a.grad.numpy(), g)
            for name, a, g in zip(("points_f", "points_m", "weights"), args, grads_j)}
    yard = max(rel(g, g64) for g, g64 in zip(grads_j, grads_64))
    print(f"[{transform_type} rw={rw}] loss rel {d_loss:.3g} (yardstick {y_loss:.3g}); gradients "
          f"rel L2 {errs} (yardstick {yard:.3g})")
    assert d_loss <= 2.0 * y_loss + 1e-5
    for name, err in errs.items():
        assert err <= 2.0 * yard + 1e-5, (name, err, yard)


def test_real_world_step_composes_the_augmentation_into_the_moving_affine(shared, monkeypatch):
    """With augmentation the fit sees ``aff_m @ aug``: the matrix the
    augmentation returned, composed into the moving image's affine; the
    fixed affine is passed as it is. Without affines the step raises."""
    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_to_np(shared["variables"])))
    cfg = Config(num_keypoints=K, transform_type="affine", loss_fn="mse", lr=LR,
                 align_keypoints_in_real_world_coords=True,
                 max_random_affine_augment_params=(0.1, 0.1, 0.1, 0.05))
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    aug = torch.eye(4)[None].clone()
    aug[0, :3, 3] = torch.tensor([0.1, -0.2, 0.05])
    seen = {}
    real_align = train.align_pair

    def fake_augment(generator, img, seg=None, return_affine_matrix=False, **kw):
        return img, aug

    def spy(*args, **kw):
        seen.update(kw)
        return real_align(*args, **kw)

    monkeypatch.setattr(augment, "random_affine_augment", fake_augment)
    monkeypatch.setattr(train, "align_pair", spy)
    aff_f, aff_m = (torch.tensor(a) for a in _affines())
    step = train.make_train_step(net, cfg)
    state, m = step(state, None, torch.tensor(shared["f"]), torch.tensor(shared["m"]), None,
                    None, 1.0, aff_f, aff_m)
    assert np.isfinite(float(m["loss"])) and seen["compute_grid"] is True
    torch.testing.assert_close(seen["aff_m"], aff_m @ aug, rtol=0, atol=0)
    torch.testing.assert_close(seen["aff_f"], aff_f, rtol=0, atol=0)
    with pytest.raises(ValueError, match="aff_f and aff_m"):
        step(state, None, torch.tensor(shared["f"]), torch.tensor(shared["m"]), None, None, 1.0)


def test_run_train_reads_each_batchs_affine(shared):
    """In real-world mode ``run_train`` hands the step each batch's
    ``"affine"`` ((4, 4) broadcast over the batch, or (B, 4, 4)) and the
    identity for a batch without one; outside it, no affines at all. The
    real step then trains on them."""
    af, am = _affines()
    img = shared["f"]
    loader = [({"img": img, "affine": af[0]}, {"img": img}),
              ({"img": img}, {"img": img, "affine": am})]
    cfg = Config(num_keypoints=K, transform_type="affine", steps_per_epoch=2,
                 align_keypoints_in_real_world_coords=True)
    calls = []

    def record(state, generator, *args, **kw):
        calls.append(kw)
        return state, {"loss": torch.tensor(0.0)}

    train.run_train(loader, None, record, cfg, 1, None, device="cpu")
    eye = torch.eye(4)[None]
    torch.testing.assert_close(calls[0]["aff_f"], torch.tensor(af))
    torch.testing.assert_close(calls[0]["aff_m"], eye)
    torch.testing.assert_close(calls[1]["aff_f"], eye)
    torch.testing.assert_close(calls[1]["aff_m"], torch.tensor(am))
    calls.clear()
    cfg_plain = Config(num_keypoints=K, transform_type="affine", steps_per_epoch=1)
    train.run_train(loader, None, record, cfg_plain, 1, None, device="cpu")
    assert calls == [{}]

    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_to_np(shared["variables"])))
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    state, stats, _ = train.run_train(loader, state, train.make_train_step(net, cfg), cfg, 1,
                                      None, device="cpu")
    assert state.step == 2 and np.isfinite(stats["loss"])
