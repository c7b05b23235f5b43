"""The port's parallel registration paths (keymorph_tpu_torch/parallel/):
the sharded register, groupwise and spatial factories,
``KeyMorph.groupwise_register(mesh=...)``, ``run_eval(mesh=...)`` with
``skip_if_completed``, and the register CLI at 2 ranks, in gloo processes
on the CPU (``tests/torch_parallel_workers.py``).

Each is held against the port's unsharded counterpart in this process and
against keymorph_tpu's sharded counterpart on its CPU mesh
(``tests/test_sharded_eval.py``'s cases), on the same weights
(``tools/import_flax_params.py``): ``tests/test_sharded_eval.py``'s net,
UNet3D(out_channels=8, f_maps=4, num_levels=2) in fp32, K = 8, 12^3.

Bars (measured values are printed):
  * against the port unsharded: a sharded run changes only the order of
    fp32 sums (a conv of a few rows against one of all, the GroupNorm and
    centre-of-mass sums over slabs, the groupwise mean over ranks), which the
    closed-form fits of an untrained net's clustered keypoints amplify:
    keymorph_tpu's own bars for its sharded-vs-single runs (grids and
    metrics 5e-4, groupwise aligned points 5e-3, spatial keypoints 2e-4,
    grid 2e-3 + 2e-3 relative, warped image 1e-2);
  * against keymorph_tpu: the fp32 backbones agree within ~1e-5
    (tests/test_torch_backbones.py), so keypoints within KEYPOINT_ABS
    (measured <= 2.6e-6). What follows the keypoints is held to what
    keymorph_tpu's own alignment makes of the port's keypoints
    (tests/test_torch_keymorph.py's rule), within STAGE_ABS: the two
    packages' fp32 fits of the same clustered keypoints differ by up to
    1.4e-4 in the grid (the spatial TPS; the affine 7.0e-5); where only the
    end result is returned (run_eval), within keymorph_tpu's
    sharded-vs-single bar;
  * the groupwise grids, both ways, within the larger of those bars and
    NOISE x how far the port's own grids move when the keypoints move by
    one fp32 ulp (PERTURB): keymorph_tpu holds only its affine grids, and
    a TPS to the mean of clustered keypoints turns the keypoints' last bits
    into ~1e-3 of grid.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_workers as W
from keymorph_tpu_torch.cli.eval_pairwise import run_eval
from keymorph_tpu_torch.data.nifti import save_nifti
from keymorph_tpu_torch.models.keymorph import KeyMorph, KeyMorphNet, align_pair
from keymorph_tpu_torch.models.unet import UNet3D
from keymorph_tpu_torch.ops.resample import align_img
from keymorph_tpu_torch.parallel import make_spatial_register_fn, sharded
from keymorph_tpu_torch.parallel import mesh as pmesh
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax
from keymorph_tpu_torch.training.config import Config

SINGLE_ABS = 5e-4  # keymorph_tpu's sharded-vs-single bar (tests/test_sharded_eval.py)
KEYPOINT_ABS = 1e-4
STAGE_ABS = 2e-4
PERTURB, NOISE = 1e-7, 2.0
METRICS, ALIGNS = ["mse", "harddice", "jdstd"], ["affine", "tps_1"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _dist(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


class _Args:
    early_stop_eval_subjects = None
    dim = 3

    def __init__(self, path, seg, skip=False):
        self.model_eval_dir, self.seg_available, self.skip_if_completed = path, seg, skip


def _eval_pairs(seed, n, seg):
    rng = np.random.default_rng(seed)
    data = {"img_f": rng.normal(size=(n, 1, 12, 12, 12)).astype(np.float32),
            "img_m": rng.normal(size=(n, 1, 12, 12, 12)).astype(np.float32)}
    if seg:
        data["seg_f"] = rng.integers(0, 3, size=(n, 1, 12, 12, 12))
        data["seg_m"] = rng.integers(0, 4, size=(n, 1, 12, 12, 12))
    return data


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """keymorph_tpu's KeyMorph with its initial parameters, the port's net
    and KeyMorph on the same weights, and the inputs of every case (saved
    for the workers)."""
    from keymorph_tpu.models import UNet3D as JUNet3D
    from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph

    root = tmp_path_factory.mktemp("parallel_eval")
    jm = JKeyMorph(backbone=JUNet3D(**W.UNET), num_keypoints=W.K)
    jm.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 1, 12, 12, 12)))
    jm.eval()
    wpath = str(root / "weights.pt")
    torch.save(state_dict_from_flax(jm.params), wpath)
    tm = KeyMorph(UNet3D(**W.UNET), W.K, device="cpu")
    tm.load_flax_params(jm.params)
    tm.eval()
    rng = np.random.default_rng(0)
    inputs = {"pairs": {"img_f": rng.normal(size=(8, 1, 12, 12, 12)).astype(np.float32),
                        "img_m": rng.normal(size=(8, 1, 12, 12, 12)).astype(np.float32)},
              "group": {"imgs": np.random.default_rng(11).uniform(
                  0, 1, (6, 1, 12, 12, 12)).astype(np.float32)},
              "eval": _eval_pairs(3, 5, True), "skip": _eval_pairs(7, 3, False)}
    inputs["one"] = {k: v[:1] for k, v in inputs["pairs"].items()}
    paths = {}
    for name, data in inputs.items():
        paths[name] = str(root / f"{name}.npz")
        np.savez(paths[name], **data)
    return dict(root=root, jm=jm, tm=tm, wpath=wpath, inputs=inputs, paths=paths)


def _cli_inputs(root):
    """Three NIfTI pairs (directories of fixed and moving scans, one
    segmentation each side) and a group of 4, with a bf16 U-Net's
    reference-format checkpoint (tests/test_torch_eval.py's CLI inputs)."""
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import build_backbone

    imgs = W.blobs(4, 10, (12, 12, 12))[:, 0]
    labels = (imgs > np.median(imgs)).astype(np.int16) + (imgs > np.quantile(imgs, 0.9))
    for sub in ("fixed", "moving", "group", "groupseg"):
        (root / sub).mkdir()
    for i in range(3):
        save_nifti(str(root / "fixed" / f"f{i}.nii.gz"), imgs[i])
        save_nifti(str(root / "moving" / f"m{i}.nii.gz"), imgs[3 + i])
    save_nifti(str(root / "fseg.nii.gz"), labels[0])
    save_nifti(str(root / "mseg.nii.gz"), labels[3])
    for i in range(4):
        save_nifti(str(root / "group" / f"s{i}.nii.gz"), imgs[6 + i])
        save_nifti(str(root / "groupseg" / f"s{i}_seg.nii.gz"), labels[6 + i])
    backbone = build_backbone(Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2,
                                     use_amp=True))
    init_weights(backbone, torch.Generator().manual_seed(5))
    torch.save({"state_dict": {"backbone." + k: v for k, v in backbone.state_dict().items()}},
               root / "cli_weights.pt")
    net = ["--num_keypoints", "8", "--backbone", "unet", "--num_levels_for_unet", "2",
           "--use_amp", "--load_path", str(root / "cli_weights.pt"), "--size", "12", "--device",
           "cpu", "--list_of_metrics", "mse", "harddice", "jdstd"]
    pairwise = net + ["--fixed", str(root / "fixed"), "--moving", str(root / "moving"),
                      "--fixed_seg", str(root / "fseg.nii.gz"), "--moving_seg",
                      str(root / "mseg.nii.gz"), "--list_of_aligns", "affine", "tps_1"]
    groupwise = net + ["--moving", str(root / "group"), "--moving_seg", str(root / "groupseg"),
                       "--groupwise", "--group_size", "4", "--list_of_aligns", "affine"]
    return {"pairwise": pairwise, "groupwise": groupwise}


@pytest.fixture(scope="module")
def port_runs(setup):
    """Every parallel case through the workers, 2 and 4 ranks."""
    root, paths, wpath = setup["root"], setup["paths"], setup["wpath"]
    cli = _cli_inputs(root)

    def reg(name, kind, mesh, transform, data, **kw):
        return ("register", dict(cases=[dict(name=name, kind=kind, mesh=mesh, data=data,
                                             transform_type=transform, **kw)],
                                 weights=wpath))

    two = [
        reg("affine", "register", dict(space=1), "affine", paths["pairs"]),
        reg("groupwise", "groupwise", dict(space=1), "affine", paths["pairs"], num_iters=3),
        reg("spatial2", "spatial", dict(data=1, space=2), "tps_1.0", paths["one"]),
        ("groupwise_register", dict(mesh=dict(space=1), weights=wpath, data=paths["group"],
                                    types=["affine", "tps_1"])),
        ("eval", dict(mesh=dict(space=1), weights=wpath, data=paths["eval"], seg=True,
                      metrics=METRICS, aligns=ALIGNS,
                      runs=[dict(dir=str(root / "fan"), skip=False)])),
        ("eval", dict(mesh=dict(space=1), weights=wpath, data=paths["skip"], seg=False,
                      metrics=["mse"], aligns=["affine"],
                      runs=[dict(dir=str(root / "skip"), skip=False),
                            dict(dir=str(root / "skip"), skip=True),
                            dict(dir=str(root / "skip"), skip=True, remove=str(
                                root / "skip" / "eval" / "1_T1_T1" / "metrics-rot0-affine.json"))])),
        ("cli", dict(argv=cli["pairwise"] + ["--save_dir", str(root / "cli_pair2")])),
        ("cli", dict(argv=cli["groupwise"] + ["--save_dir", str(root / "cli_group2")])),
    ]
    four = [
        reg("tps", "register", dict(space=2), "tps_0.5", paths["pairs"]),
        reg("spatial4", "spatial", dict(data=1, space=4), "tps_1.0", paths["one"]),
    ]
    out = {}
    for world, tasks in ((2, two), (4, four)):
        res = W.run("tasks", world, root / f"tasks{world}", deadline=150, tasks=tasks)
        for i, (job, spec) in enumerate(tasks):
            if job == "register":
                name = spec["cases"][0]["name"]
                out[name] = [r[i][name] for r in res]
            else:
                out[f"{job}{i}"] = [r[i] for r in res]
    out["cli"] = cli
    return out


def _same_on_every_rank(ranks, key=None):
    first = ranks[0] if key is None else ranks[0][key]
    for r in ranks[1:]:
        other = r if key is None else r[key]
        for a, b in zip(first, other):
            assert torch.equal(a, b)
    return first


def _register_single(tm, f, m, align_type, lmbda=None):
    """The port unsharded, pair by pair: keypoints, then align_pair's grid."""
    grids, pfs, pms = [], [], []
    with torch.no_grad():
        for i in range(len(f)):
            pf, pm, _ = tm.net(torch.as_tensor(f[i: i + 1]), torch.as_tensor(m[i: i + 1]))
            lm = None if lmbda is None else torch.full((1,), lmbda)
            grids.append(align_pair(pf, pm, align_type, f.shape[2:], lmbda=lm)["grid"])
            pfs.append(pf)
            pms.append(pm)
    return torch.cat(grids), torch.cat(pfs), torch.cat(pms)


@pytest.mark.parametrize("name,align_type,lmbda,jmesh", [
    ("affine", "affine", None, dict(num_devices=8, space=1)),
    ("tps", "tps", 0.5, dict(num_devices=4, space=2))], ids=["affine", "tps"])
def test_sharded_register_matches_single_and_jax(port_runs, setup, name, align_type, lmbda,
                                                 jmesh):
    """make_sharded_register_fn (2 ranks 'data'; 4 ranks 2 x 2 with 'space'):
    every rank gets the whole (grid, points_f, points_m); against the port
    pair by pair within SINGLE_ABS; against keymorph_tpu's sharded register
    (counterparts of test_sharded_register_matches_single and
    test_sharded_register_tps): keypoints within KEYPOINT_ABS, the grid
    within STAGE_ABS of keymorph_tpu's alignment of the port's keypoints."""
    from keymorph_tpu.models.keymorph import align_pair as jalign_pair
    from keymorph_tpu.parallel import make_mesh, make_sharded_register_fn
    from keymorph_tpu.training.config import Config as JConfig

    f, m = setup["inputs"]["pairs"]["img_f"], setup["inputs"]["pairs"]["img_m"]
    grid, pf, pm = _same_on_every_rank(port_runs[name])
    ref = _register_single(setup["tm"], f, m, align_type, lmbda)
    transform = align_type if lmbda is None else f"tps_{lmbda}"
    jfn = make_sharded_register_fn(setup["jm"].net, JConfig(num_keypoints=W.K,
                                                              transform_type=transform),
                                   make_mesh(**jmesh))
    jgrid, jpf, jpm = jfn(setup["jm"].params, jnp.asarray(f), jnp.asarray(m))
    stage = jalign_pair(jnp.asarray(_np(pf)), jnp.asarray(_np(pm)), align_type, f.shape[2:],
                        lmbda=None if lmbda is None else jnp.full((len(f),), lmbda),
                        compute_grid=True)["grid"]
    d = {"single grid": _dist(grid, ref[0]), "single keypoints": _dist(pf, ref[1]),
         "keymorph_tpu keypoints": max(_dist(pf, jpf), _dist(pm, jpm)),
         "keymorph_tpu stage": _dist(grid, stage),
         "keymorph_tpu grid (not held)": _dist(grid, jgrid)}
    print(f"{name}: {d}")
    assert grid.shape == (8, 12, 12, 12, 3) and torch.isfinite(grid).all()
    assert d["single grid"] <= SINGLE_ABS and d["single keypoints"] <= SINGLE_ABS
    assert d["keymorph_tpu keypoints"] <= KEYPOINT_ABS and d["keymorph_tpu stage"] <= STAGE_ABS


def test_sharded_factories_refuse_a_distributional_lambda():
    """keymorph_tpu's ValueError for a non-numeric TPS lambda, in the
    register, groupwise and spatial factories."""
    mesh = pmesh.Mesh(device_mesh=None, shape={"data": 1, "space": 1},
                      device=torch.device("cpu"), rank=0, data_index=0, space_index=0,
                      data_group=None, space_group=None, world_group=None)
    net = KeyMorphNet(UNet3D(**W.UNET), W.K)
    for make in (sharded.make_sharded_register_fn, sharded.make_spatial_register_fn):
        with pytest.raises(ValueError, match="numeric"):
            make(net, Config(transform_type="tps_loguniform"), mesh)
    with pytest.raises(ValueError, match="numeric"):
        sharded.make_sharded_groupwise_fn(net, Config(), mesh, "tps_uniform")
    with pytest.raises(TypeError, match="Mesh"):
        sharded.make_sharded_register_fn(net, Config(), object())


def test_sharded_groupwise_matches_single_and_jax(port_runs, setup):
    """make_sharded_groupwise_fn over 2 ranks ('data'), affine, 3 iterations
    (the counterpart of test_sharded_groupwise_matches_single): the
    subjects' keypoints against the port's batched extraction within
    SINGLE_ABS, the aligned points against the unsharded iteration within
    5e-3 (keymorph_tpu's bar); against keymorph_tpu's sharded groupwise:
    keypoints within KEYPOINT_ABS and the aligned points within STAGE_ABS of
    keymorph_tpu's iteration from the port's keypoints."""
    from keymorph_tpu.models.keymorph import _groupwise_iterate as j_iterate
    from keymorph_tpu.parallel import make_mesh
    from keymorph_tpu.parallel.sharded import make_sharded_groupwise_fn
    from keymorph_tpu.training.config import Config as JConfig

    from keymorph_tpu_torch.models.keymorph import _groupwise_iterate

    imgs = setup["inputs"]["pairs"]["img_f"]
    pts, aligned = _same_on_every_rank(port_runs["groupwise"])
    with torch.no_grad():
        ref_pts = setup["tm"].net.get_keypoints(torch.as_tensor(imgs))
        ref_aligned, _ = _groupwise_iterate(ref_pts, None, None, "affine", 3)
    jpts, _ = make_sharded_groupwise_fn(setup["jm"].net, JConfig(num_keypoints=W.K),
                                        make_mesh(num_devices=8, space=1), "affine", 3)(
        setup["jm"].params, jnp.asarray(imgs))
    jstage, _ = j_iterate(jnp.asarray(_np(pts)), None, None, align_type="affine", num_iters=3)
    d = {"single keypoints": _dist(pts, ref_pts), "single aligned": _dist(aligned, ref_aligned),
         "keymorph_tpu keypoints": _dist(pts, jpts),
         "keymorph_tpu stage": _dist(aligned, jstage)}
    print(f"groupwise factory: {d}")
    assert aligned.shape == (8, 8, 3)
    assert d["single keypoints"] <= SINGLE_ABS and d["single aligned"] <= 5e-3
    assert d["keymorph_tpu keypoints"] <= KEYPOINT_ABS and d["keymorph_tpu stage"] <= STAGE_ABS


def test_groupwise_register_mesh_matches_unsharded_and_jax(port_runs, setup):
    """KeyMorph.groupwise_register(mesh=...) over 2 ranks, 6 subjects,
    affine and tps_1, 3 iterations (the counterpart of
    test_groupwise_register_mesh_matches_unsharded): every rank returns the
    same whole result; against the port unsharded within SINGLE_ABS; against
    keymorph_tpu's groupwise_register(mesh=...) on 4 devices: keypoints
    within KEYPOINT_ABS, the aligned points and grids within STAGE_ABS of
    keymorph_tpu's iteration and grids from the port's keypoints."""
    from keymorph_tpu.models.keymorph import _groupwise_grids as j_grids
    from keymorph_tpu.models.keymorph import _groupwise_iterate as j_iterate
    from keymorph_tpu.parallel import make_mesh

    imgs = setup["inputs"]["group"]["imgs"]
    ranks = port_runs["groupwise_register3"]
    got = ranks[0]
    for other in ranks[1:]:
        for name in got:
            for k in got[name]:
                assert torch.equal(got[name][k], other[name][k]), (name, k)
    setup["tm"].seed_rng(0)
    ref = setup["tm"].groupwise_register(imgs, transform_type=["affine", "tps_1"], num_iters=3)
    setup["jm"].seed_rng(0)
    jref = setup["jm"].groupwise_register(imgs, transform_type=["affine", "tps_1"], num_iters=3,
                                          mesh=make_mesh(num_devices=4, space=1), kp_batch=4,
                                          grid_batch=4)
    for name in ("affine", "tps_1"):
        g, r = got[name], ref[name]
        assert set(g) | {"time"} == set(r) == set(jref[name])
        align_type = "tps" if name == "tps_1" else "affine"
        lm = jnp.ones((1,)) if name == "tps_1" else None
        jcurr, jmean = j_iterate(jnp.asarray(_np(g["grouppoints_m"])), lm, None,
                                 align_type=align_type, num_iters=3)
        jgrids = j_grids(jmean, jnp.asarray(_np(g["grouppoints_m"])),
                         None if lm is None else jnp.ones((6,)), None, align_type=align_type,
                         spatial=(12, 12, 12), num_chunks=4)
        d = {k: _dist(g[k], r[k]) for k in ("grouppoints_m", "grouppoints_a", "groupgrids")}
        d["keymorph_tpu keypoints"] = _dist(g["grouppoints_m"], jref[name]["grouppoints_m"])
        d["keymorph_tpu stage aligned"] = _dist(g["grouppoints_a"], jcurr)
        d["keymorph_tpu stage grids"] = _dist(g["groupgrids"], jgrids)
        yard = _groupwise_grid_yardstick(r["grouppoints_m"], align_type)
        print(f"groupwise_register {name}: {d}; grids' yardstick {yard:.3g}")
        assert max(d["grouppoints_m"], d["grouppoints_a"]) <= SINGLE_ABS
        assert d["groupgrids"] <= max(SINGLE_ABS, NOISE * yard)
        assert d["keymorph_tpu keypoints"] <= KEYPOINT_ABS
        assert d["keymorph_tpu stage aligned"] <= STAGE_ABS
        assert d["keymorph_tpu stage grids"] <= max(STAGE_ABS, NOISE * yard)


def _groupwise_grid_yardstick(points, align_type):
    """How far the port's unsharded groupwise grids (3 iterations, then the
    grids to the mean) move when the subjects' keypoints move by PERTURB:
    the grids of an untrained net's clustered keypoints amplify a
    keypoint's last bits a thousandfold (TPS)."""
    from keymorph_tpu_torch.models.keymorph import _groupwise_grids, _groupwise_iterate

    lm = torch.ones(1) if align_type == "tps" else None

    def grids(p):
        _, mean = _groupwise_iterate(p, lm, None, align_type, 3)
        return _groupwise_grids(mean, p, None if lm is None else lm.expand(len(p)), None,
                                align_type, (12, 12, 12), 4)

    base = grids(points)
    return max(_dist(grids(points * (1 + e)), base) for e in (PERTURB, -PERTURB))


def test_run_eval_fanout_matches_sequential_and_jax(port_runs, setup, tmp_path):
    """run_eval(mesh=...) over 2 ranks, 5 pairs (an odd count: the last
    batch is padded), mse, harddice and jdstd, affine and tps_1 (the
    counterpart of test_run_eval_fanout_matches_sequential): every rank
    returns the same metrics dict; against the port's sequential run the
    same keys, values within SINGLE_ABS, the same per-pair files and grids
    within SINGLE_ABS; against keymorph_tpu's fan-out on 4 devices, the
    metric values within SINGLE_ABS."""
    from keymorph_tpu.cli.eval_pairwise import run_eval as jrun_eval
    from keymorph_tpu.parallel import make_mesh

    ranks = port_runs["eval4"]
    fan = ranks[0][0]
    assert all(r[0] == fan for r in ranks[1:])
    items = W.pairs(setup["paths"]["eval"])
    setup["tm"].seed_rng(0)
    seq = run_eval(items, setup["tm"], METRICS, [("T1", "T1")], ["rot0"], ALIGNS,
                   _Args(tmp_path / "seq", True))
    jfan = jrun_eval(items, setup["jm"], METRICS, [("T1", "T1")], ["rot0"], ALIGNS,
                     _Args(tmp_path / "jax", True), mesh=make_mesh(num_devices=4, space=1))
    assert set(fan) == set(seq) == set(jfan)
    d_seq = max(_dist(np.asarray(fan[k], np.float64), np.asarray(seq[k], np.float64))
                for k in seq)
    d_jax = max(_dist(np.asarray(fan[k], np.float64), np.asarray(jfan[k], np.float64))
                for k in seq)
    fan_dir, seq_dir = setup["root"] / "fan" / "eval", tmp_path / "seq" / "eval"
    assert _files(fan_dir) == _files(seq_dir) == _files(tmp_path / "jax" / "eval")
    d_grid = max(_dist(np.load(fan_dir / f), np.load(seq_dir / f)) for f in _files(fan_dir)
                 if os.path.basename(f).startswith("grid_"))
    print(f"run_eval fan-out: metrics vs sequential {d_seq:.3g}, vs keymorph_tpu {d_jax:.3g}, "
          f"grids vs sequential {d_grid:.3g}")
    assert all(len(v) == 5 for v in fan.values())
    assert max(d_seq, d_grid, d_jax) <= SINGLE_ABS


def test_run_eval_fanout_skip_if_completed(port_runs, setup):
    """In fan-out, pairs whose metric JSONs exist are loaded while the rest
    register (the counterpart of test_run_eval_fanout_skip_if_completed):
    a second run loads everything, a third with one pair's JSON removed
    recomputes that pair alone (the loaded pairs first, so compared as
    sets), every rank returning the same dict."""
    ranks = port_runs["eval5"]
    first, second, third = ranks[0]
    assert all(r == ranks[0] for r in ranks[1:])
    key = "mse:T1:T1:rot0:affine"
    np.testing.assert_array_equal(first[key], second[key])
    np.testing.assert_allclose(np.sort(first[key]), np.sort(third[key]), atol=1e-6)
    assert (setup["root"] / "skip" / "eval" / "1_T1_T1" / "metrics-rot0-affine.json").exists()


@pytest.mark.parametrize("mode", ["pairwise", "groupwise"])
def test_register_cli_at_two_ranks_matches_one(port_runs, setup, tmp_path, mode):
    """``cli.register`` at 2 ranks (a gloo world, ``--device cpu``; the CLI
    builds its mesh from the world size) against the same CLI in one
    process: the metrics within SINGLE_ABS of the single run's, and the
    same files (pairwise: 3 pairs, the last batch padded, the same metrics
    on every rank; groupwise: 4 subjects split over the ranks, rank 0
    holding the metrics and the other ranks the same keys with empty
    lists)."""
    from keymorph_tpu_torch.cli import register

    ranks = port_runs["cli6" if mode == "pairwise" else "cli7"]
    got = ranks[0]
    for r in ranks[1:]:
        assert r == got if mode == "pairwise" else r == {k: [] for k in got}
    want = register.main(port_runs["cli"][mode] + ["--save_dir", str(tmp_path)])
    assert set(got) == set(want)
    d = max(_dist(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64))
            for k in want if want[k])
    two = setup["root"] / ("cli_pair2" if mode == "pairwise" else "cli_group2")
    assert _files(two) == _files(tmp_path)
    print(f"register CLI {mode} at 2 ranks: metrics vs one process {d:.3g}")
    assert all(len(v) == (3 if mode == "pairwise" else 1) for v in want.values())
    assert d <= SINGLE_ABS


@pytest.mark.parametrize("space", [2, 4])
def test_spatial_register_matches_single_and_jax(port_runs, setup, space):
    """make_spatial_register_fn with Z split over 'space' 2 (slabs 6 + 6)
    and 4 (4 + 4 + 2 + 2: boundaries on multiples of 2^(num_levels - 1)),
    tps_1 (the counterpart of test_spatial_register_matches_single): every
    rank returns the same whole (img_a, grid, points_f, points_m); against
    the port's unsplit module path, keymorph_tpu's bars; against keymorph_tpu's
    spatial register on 4 devices ('space' 4): keypoints within
    KEYPOINT_ABS, the grid within STAGE_ABS of keymorph_tpu's alignment of the
    port's keypoints, the warped image within STAGE_ABS of keymorph_tpu's
    warp of the port's grid."""
    from keymorph_tpu.models.keymorph import align_pair as jalign_pair
    from keymorph_tpu.ops.resample import align_img as jalign_img
    from keymorph_tpu.parallel import make_mesh
    from keymorph_tpu.parallel.sharded import make_spatial_register_fn as jspatial
    from keymorph_tpu.training.config import Config as JConfig

    one = setup["inputs"]["one"]
    img_a, grid, pf, pm = _same_on_every_rank(port_runs[f"spatial{space}"])
    f, m = torch.as_tensor(one["img_f"]), torch.as_tensor(one["img_m"])
    with torch.no_grad():
        pf0, pm0, _ = setup["tm"].net(f, m)
        ref = align_pair(pf0, pm0, "tps", f.shape[2:], lmbda=torch.ones(1))["grid"]
        ref_a = align_img(ref, m)
    jimg_a, jgrid, jpf, jpm = jspatial(setup["jm"].net, JConfig(num_keypoints=W.K,
                                                                transform_type="tps_1.0"),
                                       make_mesh(num_devices=4, data=1, space=4))(
        setup["jm"].params, jnp.asarray(one["img_f"]), jnp.asarray(one["img_m"]))
    stage = jalign_pair(jnp.asarray(_np(pf)), jnp.asarray(_np(pm)), "tps", f.shape[2:],
                        lmbda=jnp.ones((1,)), compute_grid=True)["grid"]
    stage_a = jalign_img(jnp.asarray(_np(grid)), jnp.asarray(one["img_m"]))
    d = {"single keypoints": max(_dist(pf, pf0), _dist(pm, pm0)),
         "single grid": _dist(grid, ref), "single image": _dist(img_a, ref_a),
         "keymorph_tpu keypoints": max(_dist(pf, jpf), _dist(pm, jpm)),
         "keymorph_tpu stage grid": _dist(grid, stage),
         "keymorph_tpu stage image": _dist(img_a, stage_a),
         "keymorph_tpu grid (not held)": _dist(grid, jgrid)}
    print(f"spatial at space {space}: {d}")
    assert img_a.shape == (1, 1, 12, 12, 12) and grid.shape == (1, 12, 12, 12, 3)
    assert d["single keypoints"] <= 2e-4 and d["single image"] <= 1e-2
    np.testing.assert_allclose(_np(grid), _np(ref), rtol=2e-3, atol=2e-3)
    assert d["keymorph_tpu keypoints"] <= KEYPOINT_ABS
    assert max(d["keymorph_tpu stage grid"], d["keymorph_tpu stage image"]) <= STAGE_ABS


def test_spatial_register_refuses_what_it_cannot_split():
    """keymorph_tpu's refusals are the port's, each a ValueError: a Z extent
    that does not divide by 'space' (keymorph_tpu's device_put of the
    volumes and its shard_map warp split Z evenly), and a distributional TPS
    lambda; nothing else is refused (every backbone, head, weighting and
    extent runs: test_spatial_register_every_backbone_head_and_extent)."""
    from keymorph_tpu.models import UNet3D as JUNet3D
    from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph
    from keymorph_tpu.parallel import make_mesh
    from keymorph_tpu.parallel.sharded import make_spatial_register_fn as jspatial
    from keymorph_tpu.training.config import Config as JConfig

    mesh = pmesh.Mesh(device_mesh=None, shape={"data": 1, "space": 2},
                      device=torch.device("cpu"), rank=0, data_index=0, space_index=0,
                      data_group=None, space_group=None, world_group=None)
    jm = JKeyMorph(backbone=JUNet3D(**W.UNET), num_keypoints=W.K)
    jm.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 1, 12, 12, 12)))
    jmesh = make_mesh(num_devices=2, data=1, space=2)
    vol = np.zeros((1, 1, 13, 12, 12), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        jspatial(jm.net, JConfig(transform_type="tps_1"), jmesh)(jm.params, vol, vol)
    fn = make_spatial_register_fn(KeyMorphNet(UNet3D(**W.UNET), W.K),
                                  Config(transform_type="tps_1"), mesh)
    with pytest.raises(ValueError, match="evenly"):
        fn(torch.as_tensor(vol), torch.as_tensor(vol))
    with pytest.raises(ValueError, match="numeric"):
        jspatial(jm.net, JConfig(transform_type="tps_loguniform"), jmesh)
    with pytest.raises(ValueError, match="numeric"):
        make_spatial_register_fn(KeyMorphNet(UNet3D(**W.UNET), W.K),
                                 Config(transform_type="tps_loguniform"), mesh)


# The spatial path on 'space' 2 for every 3D backbone family, both heads,
# both weightings and Z extents that are not a multiple of the block: name ->
# (keymorph_tpu backbone, the port's (build_net spec), (D, H, W), the
# KeyMorph options of both). Each case is one jitted program of keymorph_tpu,
# so the features share cases: the ConvNet with instance norm; with batch
# norm, the linear head and power weighting at D = 40 (slabs 16 + 24 at
# block 16); the residual U-Net with variance weighting; its SE form with
# the linear head; the DoubleConv U-Net at block 4 on D = 18 (slabs 8 + 10:
# the nearest upsampling 4 -> 9 reaches below the slab), with power
# weighting; at D = 4 (slabs 4 + 0: the second rank holds no plane); and a
# 2D U-Net's images, split along H as keymorph_tpu splits them, with the
# linear head and variance weighting.
SPATIAL_CASES = {
    "convnet_instance": ("ConvNet", dict(out_dim=W.K, norm_type="instance"), (32, 32, 32), {}),
    "convnet_batch_linear_power": ("ConvNet", dict(out_dim=W.K, norm_type="batch"), (40, 32, 32),
                                   dict(keypoint_layer="linear", weight_keypoints="power")),
    "residual_variance": ("ResidualUNet3D", dict(out_channels=W.K, f_maps=4, num_levels=3),
                          (16, 16, 16), dict(weight_keypoints="variance")),
    "residual_se_linear": ("ResidualUNetSE3D", dict(out_channels=W.K, f_maps=4, num_levels=3),
                           (16, 20, 16), dict(keypoint_layer="linear")),
    "unet_d18_power": ("UNet3D", dict(out_channels=W.K, f_maps=4, num_levels=3), (18, 16, 16),
                       dict(weight_keypoints="power")),
    "unet_d4_empty_rank": ("UNet3D", dict(out_channels=W.K, f_maps=4, num_levels=3), (4, 16, 16),
                           {}),
    "unet2d_linear_variance": ("UNet2D", dict(out_channels=W.K, f_maps=4, num_levels=3), (20, 16),
                               dict(dim=2, keypoint_layer="linear", weight_keypoints="variance")),
}


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Each SPATIAL_CASES net with keymorph_tpu's initial parameters (its
    variance scales and biases drawn, as a trained net's are not 1 and 0),
    carried to the port; a smooth pair per case; the port's spatial register
    of every case in one 2-rank run, and again with the nets in float64."""
    from keymorph_tpu.models import convnet as jconvnet
    from keymorph_tpu.models import unet as junet
    from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph

    root = tmp_path_factory.mktemp("spatial_cases")
    jms, data, cases = {}, {}, []
    for i, (name, (backbone, kw, spatial, opts)) in enumerate(SPATIAL_CASES.items()):
        jbb = getattr(jconvnet if backbone == "ConvNet" else junet, backbone)(**kw)
        jm = JKeyMorph(backbone=jbb, num_keypoints=W.K, **opts)
        # init_params, jitted: flax's eager init compiles op by op (a minute
        # over these nets); the parameters do not depend on the example's
        # size, so it is the smallest the backbone takes
        blk = 16 if backbone == "ConvNet" else 2 ** (kw["num_levels"] - 1)
        example = jnp.zeros((1, 1, *[blk] * len(spatial)))
        jm.params = jax.jit(jm.net.init)(jax.random.PRNGKey(i), example, example)
        if opts.get("weight_keypoints") == "variance":
            rng = np.random.default_rng(i)
            p = dict(jm.params["params"])
            p["scales"] = jnp.asarray(rng.uniform(0.5, 1.5, W.K).astype(np.float32))
            p["biases"] = jnp.asarray(rng.uniform(0.0, 0.1, W.K).astype(np.float32))
            jm.params = {"params": p}
        jm.eval()
        wpath = str(root / f"{name}.pt")
        torch.save(state_dict_from_flax(jm.params), wpath)
        f, m = (W.blobs(20 + i, 2, spatial) if len(spatial) == 3
                else W.blobs(20 + i, 2, (3, *spatial))[:, :, 1])
        data[name] = {"img_f": f[None], "img_m": m[None]}
        np.savez(root / f"{name}.npz", **data[name])
        cases.append(dict(name=name, net=dict(backbone=backbone, kw=kw, weights=wpath, **opts),
                          data=str(root / f"{name}.npz"), mesh=dict(data=1, space=2),
                          transform_type="tps_1"))
        jms[name] = jm
    ranks = W.run("spatial", 2, root / "run", deadline=150, cases=cases)
    cases64 = [dict(c, net=dict(c["net"], float64=True)) for c in cases]
    ranks64 = W.run("spatial", 2, root / "run64", deadline=150, cases=cases64)
    return dict(jms=jms, data=data, cases={c["name"]: c for c in cases}, ranks=ranks,
                ranks64=ranks64)


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_register_every_backbone_head_and_extent(spatial_runs, name):
    """make_spatial_register_fn on 'space' 2 for each SPATIAL_CASES net, tps_1
    (the counterpart of test_spatial_register_matches_single on every
    backbone keymorph_tpu splits): every rank returns the same whole (img_a,
    grid, points_f, points_m); against the port's unsplit module path
    (``KeyMorphNet.forward``, the weighted fit, the warp), keymorph_tpu's
    sharded-vs-single bars (keypoints 2e-4, grid 2e-3 + 2e-3 relative,
    warped image 1e-2); against keymorph_tpu's spatial register on a CPU
    mesh of 2: keypoints within KEYPOINT_ABS, the grid within STAGE_ABS (or
    NOISE x how far that alignment moves when the keypoints move by
    PERTURB, whichever is larger: variance weights make the weighted fit
    ill-conditioned, and the two packages' fp32 solves of the same system
    then differ by 4e-4) of keymorph_tpu's weighted alignment of the port's
    keypoints and weights, the warped image within STAGE_ABS of
    keymorph_tpu's warp of the port's grid."""
    from keymorph_tpu.models.keymorph import align_pair as jalign_pair
    from keymorph_tpu.ops.resample import align_img as jalign_img
    from keymorph_tpu.parallel import make_mesh
    from keymorph_tpu.parallel.sharded import make_spatial_register_fn as jspatial
    from keymorph_tpu.training.config import Config as JConfig

    ranks = [r[name] for r in spatial_runs["ranks"]]
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            assert (a is None and b is None) or torch.equal(a, b)
    img_a, grid, pf, pm, weights = ranks[0]
    data, jm = spatial_runs["data"][name], spatial_runs["jms"][name]
    f, m = torch.as_tensor(data["img_f"]), torch.as_tensor(data["img_m"])
    spatial = tuple(f.shape[2:])
    net = W.build_net(spatial_runs["cases"][name]["net"])
    with torch.no_grad():
        pf0, pm0, w0 = net(f, m)
        ref = align_pair(pf0, pm0, "tps", spatial, lmbda=torch.ones(1), weights=w0)["grid"]
        ref_a = align_img(ref, m)
    jimg_a, jgrid, jpf, jpm = jspatial(jm.net, JConfig(num_keypoints=W.K, transform_type="tps_1"),
                                       make_mesh(num_devices=2, data=1, space=2))(
        jm.params, jnp.asarray(data["img_f"]), jnp.asarray(data["img_m"]))
    def stage_of(scale):
        return jalign_pair(jnp.asarray(_np(pf) * scale), jnp.asarray(_np(pm) * scale), "tps",
                           spatial, lmbda=jnp.ones((1,)), compute_grid=True,
                           weights=None if weights is None else jnp.asarray(_np(weights))
                           )["grid"]

    stage = stage_of(1.0)
    yard = max(_dist(stage_of(1.0 + e), stage) for e in (PERTURB, -PERTURB))
    stage_a = jalign_img(jnp.asarray(_np(grid)), jnp.asarray(data["img_m"]))
    d = {"single keypoints": max(_dist(pf, pf0), _dist(pm, pm0)),
         "single grid": _dist(grid, ref), "single image": _dist(img_a, ref_a),
         "keymorph_tpu keypoints": max(_dist(pf, jpf), _dist(pm, jpm)),
         "keymorph_tpu stage grid": _dist(grid, stage),
         "keymorph_tpu stage image": _dist(img_a, stage_a),
         "keymorph_tpu grid (not held)": _dist(grid, jgrid)}
    if weights is not None:
        d["single weights (not held)"] = _dist(weights, w0)
    print(f"spatial {name} at space 2: {d}; stage grid's yardstick {yard:.3g}")
    assert img_a.shape == (1, 1, *spatial) and grid.shape == (1, *spatial, len(spatial))
    assert torch.isfinite(grid).all() and torch.isfinite(img_a).all()
    assert d["single keypoints"] <= 2e-4 and d["single image"] <= 1e-2
    np.testing.assert_allclose(_np(grid), _np(ref), rtol=2e-3, atol=2e-3)
    assert d["keymorph_tpu keypoints"] <= KEYPOINT_ABS
    assert d["keymorph_tpu stage grid"] <= max(STAGE_ABS, NOISE * yard)
    assert d["keymorph_tpu stage image"] <= STAGE_ABS


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_extraction_in_float64_equals_the_unsplit_modules(spatial_runs, name):
    """The split extraction is the modules' own arithmetic: with the nets in
    float64, the keypoints and keypoint weights of every SPATIAL_CASES net
    split over 'space' 2 (an empty rank, a remainder slab and a 2D net
    among them) equal the unsplit float64 net's but for the order of the
    fp32 sums that the centre of mass and the power weighting take in both
    (1e-6; the fp32 nets' chaos, 1e-5-1e-4 in keypoints, is gone)."""
    ranks = [r[name] for r in spatial_runs["ranks64"]]
    _, _, pf, pm, weights = ranks[0]
    data = spatial_runs["data"][name]
    net = W.build_net(dict(spatial_runs["cases"][name]["net"], float64=True))
    with torch.no_grad():
        pf0, pm0, w0 = net(torch.as_tensor(data["img_f"]), torch.as_tensor(data["img_m"]))
    d = {"keypoints": max(_dist(pf, pf0), _dist(pm, pm0)),
         "weights": 0.0 if w0 is None else _dist(weights, w0)}
    print(f"spatial {name} in float64: {d}")
    assert all(torch.equal(a, b) for a, b in zip(ranks[0][2:4], ranks[1][2:4]))
    assert (weights is None) == (w0 is None)
    assert d["keypoints"] <= 1e-6 and d["weights"] <= 1e-6
