"""The port's parallel layer (keymorph_tpu_torch/parallel/): the device mesh
and the sharded training step, in gloo processes on the CPU.

Workers (``tests/torch_parallel_workers.py``, jax-free) run each mesh as 2
or 4 processes; the parent holds what they return against the port's
unsharded step (``training.train.make_train_step``) on the whole batch with
the same generator state, and against keymorph_tpu's sharded step on its 4-
or 8-device CPU mesh (``tests/conftest.py``) on the same weights
(``tools/import_flax_params.py``) and, with augmentation, keymorph_tpu's
draws injected. The net is ``tests/test_sharded_eval.py``'s:
UNet3D(out_channels=8, f_maps=4, num_levels=2) in fp32, K = 8, 12^3.

Bars (measured values are printed):
  * sharded vs unsharded port step: the order of fp32 sums differs (the
    loss over slabs and ranks, the gradients over ranks, and a conv of one
    row against one of several), so the loss within 1e-5 relative. The
    gradient of an untrained net is chaotic at that level: its clustered
    keypoints make the fit ill-conditioned, and the unsharded step itself
    moves its gradients by up to ~7e-3 x their largest entry when its
    volumes move by one fp32 ulp (the yardstick: the larger distance at
    scales 1 +- PERTURB). So grad_norm and each
    parameter's gradient are held to the larger of a floor (1e-5 relative;
    2e-5 x the largest entry) and NOISE x that yardstick, the rule of
    chip_smoke.py's phase 6;
  * port vs keymorph_tpu, both sharded: keymorph_tpu's own
    sharded-vs-single bars (tests/test_training.py:230-232): the loss within
    1e-4 relative and the parameters after Adam within 3e-4 at lr 1e-4
    (Adam turns a tiny gradient's reduction-order noise into a +-lr step).
    grad_norm is printed, not held: for the reason above it moves by up to
    6% between the packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_workers as W
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.parallel import mesh as pmesh
from keymorph_tpu_torch.parallel import sharded
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config

LR = 1e-4
AUG = (0.1, 0.1, 0.5, 0.05)
NO_AUG = (0.0, 0.0, 0.0, 0.0)
LOSS_REL, GRAD_REL = 1e-5, 2e-5
PERTURB, NOISE = 1e-7, 2.0
JAX_REL, JAX_PARAM_ABS = 1e-4, 3e-4

# name -> (transform, loss, augmentation, aug_scale, JAX key, volumes, port world and mesh,
#          keymorph_tpu's mesh or None)
CASES = {
    "flat": ("affine", "mse", NO_AUG, 1.0, 7, (4, 12, 12, 12), 2, dict(space=1),
             dict(num_devices=4, space=1)),
    "flat_space": ("affine", "mse", NO_AUG, 1.0, 7, (4, 12, 12, 12), 4, dict(space=2), None),
    "aug": ("affine", "mse", AUG, 0.7, 9, (4, 12, 12, 12), 2, dict(space=1),
            dict(num_devices=4, space=1)),
    "aug_space": ("affine", "mse", AUG, 0.7, 9, (4, 12, 12, 12), 2, dict(data=1, space=2),
                  None),
    "dcn": ("affine", "mse", NO_AUG, 1.0, 7, (4, 12, 12, 12), 4, dict(dcn=2, space=2),
            dict(num_devices=8, dcn=2, space=2)),
    "warp_slabs": ("affine", "mse", NO_AUG, 1.0, 7, (2, 32, 16, 64), 4, dict(space=2),
                   dict(num_devices=4, space=2)),
    "tps": ("tps_1.0", "mse", NO_AUG, 1.0, 7, (4, 12, 12, 12), 4, dict(space=2),
            dict(num_devices=4, space=2)),
    "dice": ("tps_loguniform", "dice", AUG, 1.0, None, (2, 12, 12, 12), 4, dict(space=2),
             None),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net():
    from keymorph_tpu.models import UNet3D
    from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet

    return JKeyMorphNet(backbone=UNet3D(**W.UNET), num_keypoints=W.K)


def _jconfig(transform, loss, aug):
    from keymorph_tpu.training.config import Config as JConfig

    return JConfig(num_keypoints=W.K, transform_type=transform, loss_fn=loss, lr=LR,
                   max_random_affine_augment_params=aug)


def _config_fields(name):
    """The port's Config fields of a case: keymorph_tpu's defaults, and
    where the draws are the port's own (no JAX key) a subset of 6 of the 8
    keypoints."""
    transform, loss, aug, _, key, *_ = CASES[name]
    return dict(num_keypoints=W.K, transform_type=transform, loss_fn=loss, lr=LR,
                max_random_affine_augment_params=aug,
                max_train_keypoints=6 if key is None else 64)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """keymorph_tpu's initial parameters of the net and the port's state
    dict of the same weights (saved for the workers)."""
    root = tmp_path_factory.mktemp("parallel")
    x = jnp.zeros((1, 1, 12, 12, 12))
    params = _jax_net().init(jax.random.PRNGKey(0), x, x)
    path = root / "weights.pt"
    torch.save(state_dict_from_flax(params), path)
    return root, params, str(path)


def _inputs(root, name):
    """The case's volumes (and segmentations, and keymorph_tpu's drawn
    augmentation parameters), saved for the workers."""
    transform, loss, aug, scale, key, shape, *_ = CASES[name]
    n, spatial = shape[0], shape[1:]
    data = {"img_f": W.volumes(1, n, spatial), "img_m": W.volumes(2, n, spatial)}
    if loss == "dice":
        labels = np.random.default_rng(3).integers(0, 3, (2, n, 1, *spatial))
        for side, lab in zip(("seg_f", "seg_m"), labels):
            data[side] = np.moveaxis(np.eye(3, dtype=np.float32)[lab[:, 0]], -1, 1)
    if key is not None and any(aug):
        from keymorph_tpu import augment as jaugment

        k_aug = jax.random.split(jax.random.PRNGKey(key), 3)[0]
        for i, p in enumerate(jaugment.sample_affine_params(k_aug, n, 3, aug, scale)):
            data[f"aug_params_{i}"] = np.array(p)
        data["aug_params"] = np.zeros(0)
    path = root / f"{name}.npz"
    np.savez(path, **data)
    return str(path), data


@pytest.fixture(scope="module")
def port_runs(weights):
    """Every case through the workers: {name: [rank results]}, plus the
    negative control (the flat case with the gradient all-reduce taken out)."""
    root, _, wpath = weights
    by_world = {}
    for name, (_, _, _, scale, _, _, world, mesh, _) in CASES.items():
        path, _ = _inputs(root, name)
        by_world.setdefault(world, []).append(
            (name, dict(mesh=mesh, config=_config_fields(name), data=path, aug_scale=scale,
                        seed=5)))
    by_world[2].append(("control", dict(by_world[2][0][1], skip_reduce=True)))
    out = {}
    for world, cases in by_world.items():
        res = W.run("train", world, root / f"train{world}", deadline=150,
                    cases=[c for _, c in cases], weights=wpath)
        for i, (name, _) in enumerate(cases):
            out[name] = [r[i] for r in res]
    return out


def _unsharded(weights, name, perturb=0.0):
    """The port's unsharded step on the whole batch, the generator seeded as
    the workers' (5); the volumes scaled by ``1 + perturb``."""
    root, _, wpath = weights
    transform, loss, aug, scale, *_ = CASES[name]
    _, data = _inputs(root, name)
    net = W.make_net(wpath)
    config = Config(**_config_fields(name))
    state = train.TrainState.create(net, train.make_optimizer(config, net))
    gen = torch.Generator().manual_seed(5)
    kw = {}
    if "aug_params" in data:
        kw["aug_params"] = tuple(torch.as_tensor(data[f"aug_params_{i}"]) for i in range(4))
    seg = [torch.as_tensor(data[k]) if k in data else None for k in ("seg_f", "seg_m")]
    state, metrics = train.make_train_step(net, config)(
        state, gen, torch.as_tensor(data["img_f"] * (1 + perturb)),
        torch.as_tensor(data["img_m"] * (1 + perturb)), *seg, scale, **kw)
    return net, {k: float(v) for k, v in metrics.items()}, gen


def _grad_error(got, net):
    top = max(float(p.grad.abs().max()) for p in net.parameters() if p.grad is not None)
    return max(float((got[k] - p.grad).abs().max()) for k, p in net.named_parameters()
               if p.grad is not None) / top


def _bars(weights, name):
    """(the unsharded step's net, metrics and generator; the gradient bar;
    the grad_norm bar) of a case, by the module docstring's rule."""
    net, want, gen = _unsharded(weights, name)
    yard = yard_norm = 0.0
    for perturb in (PERTURB, -PERTURB):
        moved, moved_metrics, _ = _unsharded(weights, name, perturb)
        yard = max(yard, _grad_error({k: p.grad for k, p in moved.named_parameters()}, net))
        yard_norm = max(yard_norm, abs(moved_metrics["grad_norm"] - want["grad_norm"])
                        / want["grad_norm"])
    return net, want, gen, max(GRAD_REL, NOISE * yard), max(LOSS_REL, NOISE * yard_norm)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_unsharded(port_runs, weights, name):
    """Each case's sharded step (2 or 4 ranks; 'space' 1 and 2; a dcn mesh;
    augmentation; TPS on the planes path; Dice over 'space') against the
    unsharded step: loss, grad_norm and gradients within the module's bars;
    every rank returns the same metrics and the same parameters after Adam,
    and the generator advanced as the unsharded step's did."""
    net, want, gen, grad_bar, norm_bar = _bars(weights, name)
    ranks = port_runs[name]
    got = ranks[0]
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"]
        for k, v in got["params"].items():
            assert torch.equal(r["params"][k], v), k
    err = _grad_error(got["grads"], net)
    d_loss = abs(got["metrics"]["loss"] - want["loss"]) / abs(want["loss"])
    d_norm = abs(got["metrics"]["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    print(f"{name}: loss {d_loss:.3g}, grad_norm {d_norm:.3g} (bar {norm_bar:.3g}), "
          f"gradients {err:.3g} x max (bar {grad_bar:.3g})")
    assert set(got["metrics"]) == set(want)
    assert d_loss <= LOSS_REL and d_norm <= norm_bar and err <= grad_bar
    assert torch.equal(got["generator"], gen.get_state())


def test_sharded_train_without_gradient_reduce_fails_the_comparison(port_runs, weights):
    """The negative control: the flat case with the gradient all-reduce
    taken out (each rank keeps its half batch's gradient) fails the
    comparison above."""
    net, _, _, grad_bar, _ = _bars(weights, "flat")
    err = _grad_error(port_runs["control"][0]["grads"], net)
    print(f"control: gradients {err:.3g} x max (bar {grad_bar:.3g})")
    assert err > grad_bar


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1] is not None])
def test_sharded_train_step_matches_jax_sharded(port_runs, weights, name):
    """Against keymorph_tpu's sharded step on its CPU mesh (counterparts of
    tests/test_training.py:202, :235 and :269 and
    tests/test_sharded_eval.py::test_dcn_mesh_train_step): the loss within
    JAX_REL, the parameters after Adam within JAX_PARAM_ABS."""
    from keymorph_tpu.parallel import make_mesh, make_sharded_train_step
    from keymorph_tpu.training.train import TrainState, make_optimizer

    root, params, _ = weights
    transform, loss, aug, scale, key, _, _, _, jmesh = CASES[name]
    _, data = _inputs(root, name)
    config = _jconfig(transform, loss, aug)
    tx = make_optimizer(config)
    dummy = jnp.zeros((1,), jnp.float32)
    mesh = make_mesh(**jmesh)
    state, metrics = make_sharded_train_step(_jax_net(), config, mesh, tx)(
        TrainState.create(params, tx), jax.random.PRNGKey(key), jnp.asarray(data["img_f"]),
        jnp.asarray(data["img_m"]), dummy, dummy, jnp.float32(scale))
    got = port_runs[name][0]
    want = state_dict_from_flax(jax.device_get(state.params))
    d_loss = abs(got["metrics"]["loss"] - float(metrics["loss"])) / float(metrics["loss"])
    d_norm = (abs(got["metrics"]["grad_norm"] - float(metrics["grad_norm"]))
              / float(metrics["grad_norm"]))
    d_par = max(float((got["params"][k] - v).abs().max()) for k, v in want.items())
    print(f"{name} vs keymorph_tpu {jmesh}: loss {d_loss:.3g}, grad_norm {d_norm:.3g} (not "
          f"held), parameters {d_par:.3g}")
    assert d_loss <= JAX_REL and d_par <= JAX_PARAM_ABS


def _fake_mesh(**shape):
    """A Mesh that no collective is called on (for the refusals)."""
    return pmesh.Mesh(device_mesh=None, shape={"data": 1, "space": 1, **shape},
                      device=torch.device("cpu"), rank=0, data_index=0, space_index=0,
                      data_group=None, space_group=None, world_group=None)


def test_mesh_layout_shards_and_collectives(tmp_path):
    """make_mesh at 4 ranks as ('data', 'space') 2 x 2 and as ('dcn', 'data',
    'space') 2 x 1 x 2: keymorph_tpu's axis names, 'dcn' slowest (rank r at
    the row-major coordinate of r), shard_batch's contiguous rows over the
    data-parallel axes, the groups' members, and the gathers of unequal
    blocks and of JSON."""
    res = W.run("mesh", 4, tmp_path, meshes={"ds": dict(space=2), "dcn": dict(dcn=2, space=2)},
                bad={})
    for r, out in enumerate(res):
        ds, dcn = out["ds"], out["dcn"]
        assert ds["axis_names"] == ("data", "space") and ds["shape"] == {"data": 2, "space": 2}
        assert dcn["axis_names"] == ("dcn", "data", "space")
        assert dcn["shape"] == {"dcn": 2, "data": 1, "space": 2}
        assert list(ds["coordinate"]) == [r // 2, r % 2]
        assert list(dcn["coordinate"]) == [r // 2, 0, r % 2]
        for m in (ds, dcn):
            assert (m["data_index"], m["space_index"]) == (r // 2, r % 2)
            rows = np.arange(16).reshape(8, 2)[4 * (r // 2): 4 * (r // 2) + 4].tolist()
            assert m["rows"] == rows and m["none"] is None
            assert m["data_sum"] == (r % 2) + (r % 2 + 2)  # ranks s and s + 2
            assert m["space_sum"] == 2 * (r // 2) * 2 + 1  # ranks 2d and 2d + 1
            first = 2 * (r // 2)
            assert m["gather"] == [[first] * 2] + [[first + 1] * 2] * 2
            assert m["json"] == [{"rank": i, "x": [i / 3]} for i in range(4)]


def test_make_mesh_refuses_what_keymorph_tpu_asserts(tmp_path):
    """Sizes that do not divide or multiply to the device count raise
    ValueError (keymorph_tpu asserts); a non-mesh object is a TypeError;
    shard_batch and the steps refuse batches that do not divide over the
    data-parallel axes; the sharded step has no real-world mode."""
    res = W.run("mesh", 2, tmp_path, meshes={}, bad={
        "indivisible": dict(space=3), "product": dict(data=3, space=1),
        "subset": dict(num_devices=1)})
    errs = res[0]["errors"]
    assert "not divisible" in errs["indivisible"] and "must equal" in errs["product"]
    assert "spans every process" in errs["subset"]
    with pytest.raises(TypeError, match="Mesh"):
        pmesh.require_mesh(object())
    with pytest.raises(ValueError, match="divide"):
        pmesh.local_rows(_fake_mesh(data=2), 3)
    net = KeyMorphNet(torch.nn.Identity(), W.K)
    with pytest.raises(ValueError, match="real-world"):
        sharded.make_sharded_train_step(net, Config(align_keypoints_in_real_world_coords=True),
                                        _fake_mesh())
    assert pmesh.split_sizes(12, 4, 2) == [4, 4, 2, 2]
    assert pmesh.split_sizes(13, 2) == [7, 6] and pmesh.split_sizes(9, 2, 4) == [4, 5]
    with pytest.raises(ValueError, match="fewer"):
        pmesh.split_sizes(12, 8, 2)
