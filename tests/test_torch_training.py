"""Slice 2 end to end: the port's training step, optimizer, epoch loop,
config and checkpoints (keymorph_tpu_torch/training/) against keymorph_tpu's.

The whole step (extract with autograd -> TPS fit -> planes flow -> warp ->
MSE -> backward -> Adam) runs in both packages on the same numpy volumes,
the same weights (carried by tools/import_flax_params.py), lambda = 1 and
the keypoint subset keymorph_tpu drew. On the CPU the port's wrappers run
their kernels' plain versions through the same autograd Functions the card
uses. keymorph_tpu runs once with its Pallas kernels in interpret mode
(KM_FORCE_FAST_CONV=1, KM_FORCE_FAST_WARP=1; the TPS kernels interpret by
themselves) and once through its XLA VJPs (KM_NO_FAST_CONV, KM_NO_FAST_TPS,
KM_NO_WARP_GRAD).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.training import config as jconfig
from keymorph_tpu.training import train as jtrain
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.tools.import_flax_params import load_adam_state, state_dict_from_flax
from keymorph_tpu_torch.training import checkpoint as ckpt
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config, build_backbone

K, SUB = 8, 6
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
SPATIAL = (16, 16, 128)
LR = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _blobs(rng, spatial=SPATIAL):
    """A smooth fixed volume and a shifted moving one, (1, 1, *spatial)."""
    axes = [np.linspace(-1, 1, s) for s in spatial]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for cz, cy, cx in ((0.1, -0.2, 0.3), (-0.05, -0.1, 0.2)):
        v = np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 0.3)
        v = v + 0.5 * np.exp(-((zz + cz) ** 2 + (yy + 0.4) ** 2 + (xx + cx) ** 2) / 0.1)
        out.append((v + 0.02 * rng.random(v.shape))[None, None].astype(np.float32))
    return out


def _jax_setup(rng):
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG),
                        num_keypoints=K, compute_dtype=jnp.bfloat16)
    small = jnp.zeros((1, 1, 4, 4, 4), jnp.float32)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(1), small, small)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():  # GroupNorm affines away from (1, 0), never 0
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    jcfg = jconfig.Config(num_keypoints=K, transform_type="tps_1.0", loss_fn="mse", lr=LR,
                          max_train_keypoints=SUB)
    return jnet, flax.traverse_util.unflatten_dict(flat), jcfg


def _port_setup(variables, **cfg_kw):
    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    net.load_state_dict(state_dict_from_flax(_to_np(variables)))
    cfg = Config(num_keypoints=K, transform_type="tps_1.0", loss_fn="mse", lr=LR,
                 max_train_keypoints=SUB, **cfg_kw)
    return net, cfg, train.TrainState.create(net, train.make_optimizer(cfg, net))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


_JAX_ENV = {"pallas": {"KM_FORCE_FAST_CONV": "1", "KM_FORCE_FAST_WARP": "1"},
            "xla": {"KM_NO_FAST_CONV": "1", "KM_NO_FAST_TPS": "1", "KM_NO_WARP_GRAD": "1"}}
KEY1, KEY2 = 5, 6


def _subset(seed):
    """The keypoint subset keymorph_tpu's step draws from PRNGKey(seed)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    return np.array(jax.random.permutation(key, K)[:SUB])


@pytest.fixture(scope="module")
def jax_steps():
    """Two keymorph_tpu training steps on the shared inputs, once per
    reference mode: {mode: first-step metrics and gradients, the state after
    it (parameters and Adam moments), second-step loss and parameters}."""
    rng = np.random.default_rng(0)
    jnet, variables, jcfg = _jax_setup(rng)
    f, m = _blobs(rng)
    out = {"variables": variables, "f": f, "m": m}
    for mode, env in _JAX_ENV.items():
        old = {k: os.environ.get(k) for names in _JAX_ENV.values() for k in names}
        for k in old:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            tx = jtrain.make_optimizer(jcfg)
            step = jtrain.make_train_step(jnet, jcfg, tx)  # traced under this mode's switches
            args = (jnp.asarray(f), jnp.asarray(m), None, None, jnp.float32(1.0))
            s1, m1 = step(jtrain.TrainState.create(variables, tx), jax.random.PRNGKey(KEY1), *args)
            s2, m2 = step(s1, jax.random.PRNGKey(KEY2), *args)
            adam = s1.opt_state[0]
            out[mode] = {
                "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
                # Adam's first moment after one step is (1 - b1) g
                "grads": state_dict_from_flax(_to_np(jax.tree_util.tree_map(
                    lambda v: v / 0.1, adam.mu))),
                "params1": _to_np(s1.params), "mu": _to_np(adam.mu), "nu": _to_np(adam.nu),
                "count": int(adam.count), "loss2": float(m2["loss"]),
                "params2": state_dict_from_flax(_to_np(s2.params)),
            }
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
def test_training_step_matches_jax(jax_steps, ref):
    """One whole step against keymorph_tpu's, per reference mode.

    A randomly initialized net puts its center-of-mass keypoints close
    together, the TPS extrapolates from them, and bf16 rounds every
    activation and conv cotangent: the step is ill-conditioned, and
    keymorph_tpu's own two modes (Pallas kernels, XLA VJPs) differ visibly on
    it (printed). That difference is the yardstick: ``loss``, ``grad_norm``,
    the whole gradient (relative L2 over all parameters) and each
    parameter's gradient (L2 distance) lie no further from the reference than
    2x what the two references lie from each other, plus a floor: loss 1e-3,
    grad_norm 1e-2, gradients 5e-2 of their norm (the bars the card's run
    starts from), and for a single parameter also 5e-3 of the whole
    gradient's norm (the first GroupNorm's scalar weight and bias nearly
    cancel, while the noise they receive scales with their neighbours')."""
    other = jax_steps["xla" if ref == "pallas" else "pallas"]
    want = jax_steps[ref]
    net, cfg, state = _port_setup(jax_steps["variables"])
    step = train.make_train_step(net, cfg)
    kernels.reset_counters()
    tf, tm = torch.tensor(jax_steps["f"]), torch.tensor(jax_steps["m"])
    state, m1 = step(state, None, tf, tm, None, None, 1.0, keypoint_idx=_subset(KEY1))
    assert state.step == 1 and set(m1) == {"loss", "mse", "grad_norm"}
    counts = kernels.counters()
    assert all(c["launches"] == 0 for c in counts.values())
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
                 "tps_planes", "tps_planes_bwd", "warp_planes", "warp_planes_grad"):
        assert counts[name]["plain_calls"] > 0, name

    def rel(a, b):
        return abs(a - b) / abs(b)

    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(want["grads"])
    d_loss, y_loss = rel(float(m1["loss"]), want["loss"]), rel(other["loss"], want["loss"])
    d_gn = rel(float(m1["grad_norm"]), want["grad_norm"])
    y_gn = rel(other["grad_norm"], want["grad_norm"])
    whole = _whole_rel_l2(got, want["grads"])
    y_whole = _whole_rel_l2(other["grads"], want["grads"])
    print(f"[{ref}] loss rel {d_loss:.3g} (references {y_loss:.3g}); grad_norm rel {d_gn:.3g} "
          f"(references {y_gn:.3g}); whole gradient rel L2 {whole:.3g} (references "
          f"{y_whole:.3g})")
    assert d_loss <= 2.0 * y_loss + 1e-3
    assert d_gn <= 2.0 * y_gn + 1e-2
    assert whole <= 2.0 * y_whole + 5e-2
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want["grads"].values()))
    worst = 0.0
    for k, g in got.items():
        w, o = want["grads"][k].numpy(), other["grads"][k].numpy()
        err, yard = np.linalg.norm(g.numpy() - w), np.linalg.norm(o - w)
        bar = 2.0 * yard + 5e-2 * np.linalg.norm(w) + 5e-3 * total
        worst = max(worst, err / bar)
        print(f"[{ref}]   {k}: rel L2 {_rel_l2(g.numpy(), w):.3g} (references "
              f"{_rel_l2(o, w):.3g}), share of the bar {err / bar:.3g}")
        assert err <= bar, (k, err, bar)
    print(f"[{ref}] worst share of a parameter's bar {worst:.3g}")


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_second_step_from_carried_state_matches_jax(jax_steps, ref):
    """keymorph_tpu's parameters and optax Adam moments after its first step,
    carried into the port (state_dict_from_flax, load_adam_state): both take
    the second step from the same point. Adam normalizes every element's
    update to about lr whatever the gradient's size, so an element whose
    gradient is inside the noise measured above can land anywhere within
    +-lr in either package; what is held is the update as a whole: its cosine
    with keymorph_tpu's at least 0.7 (unrelated updates give ~0, the two
    references' first-step gradients have cosine ~0.9 between themselves),
    most elements within 0.1 lr, none further than the 2 lr a sign flip
    costs, and every parameter moved. The exact optimizer arithmetic is
    test_adam_on_the_same_gradients_matches_optax's."""
    want = jax_steps[ref]
    net, cfg, state = _port_setup(want["params1"])
    load_adam_state(state.optimizer, net, want["mu"], want["nu"], want["count"])
    state.step = 1
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    step = train.make_train_step(net, cfg)
    state, m2 = step(state, None, torch.tensor(jax_steps["f"]), torch.tensor(jax_steps["m"]),
                     None, None, 1.0, keypoint_idx=_subset(KEY2))
    got = torch.cat([(p.detach() - before[k]).ravel() for k, p in net.named_parameters()])
    ref_up = torch.cat([(want["params2"][k] - before[k]).ravel()
                        for k, _ in net.named_parameters()])
    cos = float(torch.dot(got, ref_up) / (got.norm() * ref_up.norm()))
    diff = (got - ref_up).abs()
    near = float((diff <= 0.1 * LR).float().mean())
    moved = min(float((p.detach() - before[k]).abs().max()) for k, p in net.named_parameters())
    print(f"[{ref}] second step: loss {float(m2['loss']):.6g} vs {want['loss2']:.6g}; update "
          f"cosine {cos:.3f}; {near:.3f} of all elements within 0.1 lr, largest difference "
          f"{float(diff.max()) / LR:.3g} lr; every parameter moved by at least "
          f"{moved / LR:.3g} lr")
    assert state.step == 2
    assert cos >= 0.7
    assert near >= 0.5
    assert float(diff.max()) <= 2.05 * LR
    assert moved > 0.0


def test_adam_on_the_same_gradients_matches_optax(rng):
    """torch.optim.Adam(lr) from a carried optax state, fed the gradients
    optax is fed: three steps agree to 5e-5 of an update of size lr plus two
    fp32 ulps of the parameter (optax forms the bias correction 1 - b2^t in
    fp32, where it loses ~2e-5 relative at small t; PyTorch forms it in
    double) (the same
    fp32 formula; optax adds eps outside the bias-corrected root as PyTorch
    does)."""
    _, variables, jcfg = _jax_setup(rng)
    params = variables
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(params)
    net, cfg, state = _port_setup(variables)

    def grads_like(tree, scale):
        return jax.tree_util.tree_map(
            lambda v: jnp.asarray(scale * rng.normal(size=v.shape).astype(np.float32)), tree)

    # one optax step alone, then carry its state into the port
    g = grads_like(params, 1.0)
    updates, opt_state = tx.update(g, opt_state, params)
    params = optax.apply_updates(params, updates)
    net.load_state_dict(state_dict_from_flax(_to_np(params)))
    load_adam_state(state.optimizer, net, _to_np(opt_state[0].mu), _to_np(opt_state[0].nu),
                    opt_state[0].count)
    for scale in (0.3, 3.0, 1e-3):
        g = grads_like(params, scale)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = state_dict_from_flax(_to_np(g))
        for k, p in net.named_parameters():
            p.grad = tg[k].reshape(p.shape).clone()
        state.optimizer.step()
        want = state_dict_from_flax(_to_np(params))
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0,
                                       atol=5e-5 * LR + 2.4e-7 * float(want[k].abs().max()))
    with pytest.raises(KeyError):
        load_adam_state(state.optimizer, net, {"backbone": {"Conv_0": _to_np(
            variables["params"]["backbone"]["Conv_0"])}}, {}, 1)


def _tiny(rng, **cfg_kw):
    gen = torch.Generator().manual_seed(0)
    weight = cfg_kw.pop("weight_keypoints", None)
    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), gen), K,
                      weight_keypoints=weight)
    cfg = Config(num_keypoints=K, max_train_keypoints=SUB, lr=1e-3, **cfg_kw)
    return net, cfg, train.TrainState.create(net, train.make_optimizer(cfg, net)), gen


def test_run_train_debug_mode_dice_augment_and_kpconsistency(rng, tmp_path):
    """The epoch loop on a synthetic loader: 3 steps in debug_mode over a
    2-batch loader (it re-cycles), Dice on one-hot labels with the channel
    count pinned on the step function, affine augmentation with the slope
    ramp, per-sample loguniform lambda, power keypoint weights, and a
    keypoint-consistency update per step."""
    net, cfg, state, gen = _tiny(
        rng, transform_type="tps_loguniform", loss_fn="dice", debug_mode=True,
        max_random_affine_augment_params=(0.1, 0.1, 0.2, 0.05), affine_slope=4,
        kpconsistency_coeff=1.0, weight_keypoints="power")
    S = (16, 16, 16)
    loader = [tuple({"img": rng.random((1, 1, *S)).astype(np.float32),
                     "seg": rng.integers(0, 3, (1, 1, *S))} for _ in range(2))
              for _ in range(2)]
    mods = {"a": [{"img": rng.random((1, *S)).astype(np.float32)}],
            "b": [{"img": rng.random((1, *S)).astype(np.float32)}]}
    step = train.make_train_step(net, cfg)
    kp = train.make_kpconsistency_step(net, cfg)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    state, stats, gen2 = train.run_train(loader, state, step, cfg, 2, gen, kp_step_fn=kp,
                                         modality_datasets=mods, device="cpu")
    assert gen2 is gen and state.step == 6  # 3 training + 3 consistency updates
    assert set(stats) >= {"loss", "softdice", "softdiceloss", "grad_norm", "kploss",
                          "epoch_time", "steps_per_sec"}
    assert all(np.isfinite(v) for v in stats.values())
    assert 0.0 <= stats["softdiceloss"] <= 1.0
    assert abs(stats["softdice"] + stats["softdiceloss"] - 1.0) < 1e-6
    assert step._n_cls_pin == 3
    for k, p in net.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k


def test_run_train_skips_large_volumes_and_counts_steps(rng, monkeypatch):
    """steps_per_epoch batches outside debug_mode; a batch at or above the
    large-volume guard is skipped, not trained on."""
    net, cfg, state, gen = _tiny(rng, transform_type="tps_0.5", steps_per_epoch=2)
    S = (16, 16, 16)
    loader = [({"img": rng.random((1, 1, *S)).astype(np.float32)},) * 2]
    step = train.make_train_step(net, cfg)
    state, stats, _ = train.run_train(loader, state, step, cfg, 1, gen, device="cpu")
    assert state.step == 2 and np.isfinite(stats["mse"])
    monkeypatch.setattr(train, "LARGE_VOLUME", 16 ** 3)
    state, stats, _ = train.run_train(loader, state, step, cfg, 1, gen, device="cpu")
    assert state.step == 2 and "loss" not in stats


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(rng):
    """device=None means the CUDA card: without one it raises, it never
    falls back to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    net, cfg, state, gen = _tiny(rng, transform_type="tps_0.5")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.run_train([], state, train.make_train_step(net, cfg), cfg, 1, gen)
    from keymorph_tpu_torch.tools import train_step_bench

    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_step_bench.build(8)
    net2, cfg2, state2, imgs = train_step_bench.build(8, keypoints=4, device="cpu")
    assert cfg2.transform_type == "tps_loguniform" and cfg2.max_train_keypoints == 64
    assert imgs[0].shape == (1, 1, 8, 8, 8) and state2.step == 0


def test_config_fields_and_round_trip_match_jax(tmp_path):
    """The port's Config carries every field of keymorph_tpu's with the same
    default, and a file saved by either loads in the other."""
    jf = {f.name: f for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f for f in dataclasses.fields(Config)}
    assert set(jf) == set(tf)
    ja, ta = dataclasses.asdict(jconfig.Config()), dataclasses.asdict(Config())
    assert ja == ta
    cfg = Config(job_name="x", transform_type="tps_loguniform", img_size=(32, 48, 64),
                 max_random_affine_augment_params=(0.1, 0.2, 0.3, 0.4), save_dir=str(tmp_path))
    path = os.path.join(tmp_path, "config.json")
    cfg.save(path)
    assert Config.load(path) == cfg
    assert dataclasses.asdict(jconfig.Config.load(path)) == dataclasses.asdict(cfg)
    assert cfg.model_dir == os.path.join(str(tmp_path), "x") and not cfg.seg_available
    with open(path) as fh:  # unknown keys from a newer writer are dropped
        d = json.load(fh)
    d["not_a_field"] = 1
    with open(path, "w") as fh:
        json.dump(d, fh)
    assert Config.load(path) == cfg


def test_build_backbone_variants():
    """Every 3D family of keymorph_tpu's factory, fp32 by default and bf16
    with use_amp; only the bf16 DoubleConv U-Nets run on the conv kernels."""
    from keymorph_tpu_torch.models.convnet import ConvNet
    from keymorph_tpu_torch.models.unet import ResidualUNetSE3D, supports_fast_unet

    unet = build_backbone(Config(backbone="unet", num_keypoints=5, num_levels_for_unet=2))
    trunc = build_backbone(Config(backbone="truncatedunet", num_keypoints=5, use_amp=True,
                                  use_checkpoint=True))
    assert unet.final_conv.out_channels == 5 and len(unet.encoders) == 2
    assert trunc.dtype == torch.bfloat16 and trunc.use_checkpoint and len(trunc.decoders) == 2
    assert supports_fast_unet(trunc) and not supports_fast_unet(unet)
    conv = build_backbone(Config(backbone="conv", num_keypoints=5, norm_type="batch"))
    assert isinstance(conv, ConvNet) and conv.dtype == torch.float32 and conv.norm_type == "batch"
    assert conv.block9.conv.out_channels == 5 and not supports_fast_unet(conv)
    for name in ("residualunet", "residualunetse"):
        res = build_backbone(Config(backbone=name, num_keypoints=5, num_levels_for_unet=3,
                                    use_amp=True))
        assert res.basic_module == name[len("residual"):].replace("unet", "resnet")
        assert res.dtype == torch.bfloat16 and len(res.encoders) == 3 and len(res.decoders) == 2
        assert isinstance(res, ResidualUNetSE3D) == (name == "residualunetse")
        assert not supports_fast_unet(res)
    with pytest.raises(ValueError):
        build_backbone(Config(backbone="nope"))


def test_checkpoint_round_trip_latest_and_corrupt(rng, tmp_path):
    """keymorph_tpu's payload keys and directory names on torch.save; the
    optimizer's moments and the step come back; a corrupt file raises."""
    net, cfg, state, gen = _tiny(rng, transform_type="tps_0.5")
    step = train.make_train_step(net, cfg)
    img = torch.tensor(rng.random((1, 1, 16, 16, 16)).astype(np.float32))
    state, _ = step(state, gen, img, img.flip(2), None, None, 1.0)
    ref_points = rng.normal(size=(1, K, 3)).astype(np.float32)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, ref_points=ref_points)
    ckpt.save_checkpoint(str(tmp_path), 12, state)
    assert os.path.basename(path) == "epoch3_model"
    assert os.path.basename(ckpt.latest_epoch_checkpoint(str(tmp_path))) == "epoch12_model"
    assert ckpt.latest_epoch_checkpoint(os.path.join(tmp_path, "missing")) is None

    net2, cfg2, state2, _ = _tiny(rng, transform_type="tps_0.5")
    torch.nn.init.zeros_(net2.backbone.final_conv.bias)
    payload = ckpt.load_checkpoint(path, state2)
    assert set(payload) == {"params", "opt_state", "step", "epoch", "ref_points"}
    assert payload["epoch"] == 3 and state2.step == 1
    np.testing.assert_array_equal(np.asarray(payload["ref_points"]), ref_points)
    for (k, a), (_, b) in zip(net.state_dict().items(), net2.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(net.parameters(), net2.parameters()):
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][name], state2.optimizer.state[q][name])
    # both take the same next step
    state, ma = step(state, None, img, img.flip(3), None, None, 1.0, lmbda=torch.ones(1),
                     keypoint_idx=np.arange(SUB))
    state2, mb = train.make_train_step(net2, cfg2)(
        state2, None, img, img.flip(3), None, None, 1.0, lmbda=torch.ones(1),
        keypoint_idx=np.arange(SUB))
    assert float(ma["loss"]) == float(mb["loss"])
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, q)

    with open(os.path.join(path, "checkpoint.pt"), "wb") as fh:
        fh.write(b"not a checkpoint")
    with pytest.raises(Exception):
        ckpt.load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(os.path.join(tmp_path, "epoch99_model"))


def test_aggregate_dicts_and_one_hot(rng):
    from keymorph_tpu_torch.utils import aggregate_dicts, one_hot, one_hot_subsampled_pair

    assert aggregate_dicts([{"a": 1.0, "b": torch.tensor(2.0)}, {"a": 3.0}]) == {"a": 2.0, "b": 2.0}
    seg = rng.integers(0, 4, (2, 1, 3, 4, 5))
    oh = one_hot(torch.tensor(seg))
    assert oh.shape == (2, 4, 3, 4, 5) and torch.equal(oh.argmax(1), torch.tensor(seg[:, 0]))
    assert one_hot(torch.tensor(seg), 6).shape[1] == 6
    a, b = one_hot_subsampled_pair(seg, seg, subsample_num=2, seed=0, device="cpu")
    assert a.shape == (2, 2, 3, 4, 5) and torch.equal(a, b) and float(a.sum()) > 0
