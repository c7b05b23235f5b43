"""The port's registration API against keymorph_tpu's: ``align_pair`` from
identical keypoints in every form, the mass-ranked extraction, the
``KeyMorph`` orchestrator's pairwise contract on shared weights, approximate
TPS serving, groupwise registration and the self-registration identity.

Weights come across through ``tools/import_flax_params.state_dict_from_flax``
(``KeyMorph.load_flax_params``); the net is the pipeline tests'
TruncatedUNet3D(f_maps=4, num_levels=3) in bf16, and keymorph_tpu's
``KeyMorph(use_amp=True)`` runs the same bf16 backbone. Random draws never
agree between JAX keys and torch Generators, so lambdas are numeric
(``tps_0.1``, ``tps_1``). Every tolerance is stated where it is used and
was measured at these seeds (the tests print what they measure).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph
from keymorph_tpu.models.keymorph import _groupwise_grids as j_groupwise_grids
from keymorph_tpu.models.keymorph import _groupwise_iterate as j_groupwise_iterate
from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu_torch.models import keymorph as km
from keymorph_tpu_torch.models.unet import TruncatedUNet3D

K = 8
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
SPATIAL = (16, 16, 128)  # the pipeline tests' volumes
SMALL = (6, 10, 16)      # align_pair's grids
KEYPOINT_ABS = 2e-2      # keymorph_tpu's own fast-vs-flax bar (tests/test_fast_unet.py)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _dist(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _affines(B):
    """tests/test_keymorph_rw.py's anisotropic voxel -> world affines."""
    aff_f = np.eye(4, dtype=np.float32)
    aff_f[:3, :3] = np.diag([1.0, 1.25, 2.0])
    aff_f[:3, 3] = [-40, -50, 30]
    aff_m = np.eye(4, dtype=np.float32)
    aff_m[:3, :3] = np.diag([1.1, 1.2, 1.9])
    aff_m[:3, 3] = [-42, -48, 28]
    return np.repeat(aff_f[None], B, 0), np.repeat(aff_m[None], B, 0)


# -- align_pair from identical keypoints --------------------------------------


def _rw_affine_float64(pf, pm, w, aff_f, aff_m, spatial):
    """Real-world weighted affine fit, its grid and aligned points in float64
    (numpy): the truth the fp32 fits are measured against."""
    S = np.asarray(spatial, np.float64)

    def n2r(p, a):
        return ((p + 1.0) * S / 2.0 - 0.5) @ a[:3, :3].T + a[:3, 3]

    def r2n(p, a):
        return 2.0 * ((p - a[:3, 3]) @ np.linalg.inv(a[:3, :3]).T + 0.5) / S - 1.0

    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in spatial], indexing="ij"), -1)
    out = {"matrix": [], "grid": [], "points_a": []}
    for b in range(len(pf)):
        af, am = aff_f[b].astype(np.float64), aff_m[b].astype(np.float64)
        rf, rm = n2r(pf[b].astype(np.float64), af), n2r(pm[b].astype(np.float64), am)
        sw = np.sqrt(w[b].astype(np.float64))[:, None]
        xh = np.concatenate([rf, np.ones((len(rf), 1))], 1)
        inv = np.eye(4)
        inv[:3] = np.linalg.lstsq(xh * sw, rm * sw, rcond=None)[0].T
        fwd = np.linalg.inv(inv)
        out["matrix"].append(fwd)
        moved = r2n(n2r(grid.reshape(-1, 3), af) @ inv[:3, :3].T + inv[:3, 3], am)
        out["grid"].append(moved.reshape(*spatial, 3)[..., ::-1])
        out["points_a"].append(r2n(rm @ fwd[:3, :3].T + fwd[:3, 3], af))
    return {k: np.stack(v) for k, v in out.items()}


KINDS = ["affine", "rigid", "tps", "tps_centers", "rw_affine", "rw_tps"]


@pytest.mark.parametrize("compute_grid", [True, "planes", False])
@pytest.mark.parametrize("kind", KINDS)
def test_align_pair_from_identical_keypoints_matches_jax(rng, kind, compute_grid):
    """(B=2, T=12, weighted) keypoints through both packages' align_pair with
    the aligned points: the same keys and shapes; grid, planes, matrix and
    points_a within 1e-5 in normalized coordinates (measured <= 1.1e-6) and
    1e-4 in real-world TPS (measured <= 6.1e-5, normalized units: the
    spline in millimetres). The real-world affine fit is ill-conditioned in
    fp32 (a Gram system of coordinates tens of millimetres from the
    origin): there each output of the port is held to at most twice
    keymorph_tpu's distance from the float64 fit, plus 1e-4 (printed)."""
    B, T = 2, 12
    pf = rng.uniform(-0.7, 0.7, (B, T, 3)).astype(np.float32)
    pm = (pf + rng.normal(0, 0.05, pf.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (B, T)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    align_type = kind.replace("rw_", "").replace("_centers", "")
    kw = dict(compute_grid=compute_grid, compute_aligned_points=True)
    if align_type == "tps":
        kw["lmbda"] = np.array([0.1, 0.1], np.float32)
    if kind == "tps_centers":
        kw["tps_centers"] = 7
    shape = SMALL if compute_grid is not False or kind.startswith("rw") else ()
    jkw, tkw = dict(kw), dict(kw)
    if "lmbda" in kw:
        jkw["lmbda"], tkw["lmbda"] = jnp.asarray(kw["lmbda"]), _t(kw["lmbda"])
    if kind.startswith("rw"):
        af, am = _affines(B)
        jkw.update(aff_f=jnp.asarray(af), aff_m=jnp.asarray(am), moving_shape=SMALL)
        tkw.update(aff_f=_t(af), aff_m=_t(am), moving_shape=SMALL)
    want = jalign_pair(jnp.asarray(pf), jnp.asarray(pm), align_type, shape,
                       weights=jnp.asarray(w), **jkw)
    got = km.align_pair(_t(pf), _t(pm), align_type, shape, weights=_t(w), **tkw)
    assert set(got) == set(want)
    truth = (_rw_affine_float64(pf, pm, w, *_affines(B), SMALL) if kind == "rw_affine"
             else None)
    for k in want:
        g, r = _np(got[k]), _np(want[k])
        assert g.shape == r.shape and g.dtype == np.float32, k
        if truth is not None:
            t = truth["grid" if k == "planes" else k]
            if k == "planes":
                t = np.flip(np.moveaxis(t, -1, 1), 1)
            d_port, d_ref = float(np.abs(g - t).max()), float(np.abs(r - t).max())
            print(f"{kind} {compute_grid} {k}: from float64 port {d_port:.3g}, keymorph_tpu "
                  f"{d_ref:.3g}; port vs keymorph_tpu {np.abs(g - r).max():.3g}")
            assert d_port <= 2.0 * d_ref + 1e-4, k
            continue
        tol = 1e-4 if kind == "rw_tps" else 1e-5
        print(f"{kind} {compute_grid} {k}: port vs keymorph_tpu {np.abs(g - r).max():.3g} "
              f"(tol {tol:.3g})")
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=k)


def test_pair_ranked_by_mass_orders_like_a_stable_argsort(rng, monkeypatch):
    """Channels ranked by descending joint mass, ties kept in channel order
    (``jnp.argsort`` is stable): on features with tied masses the order is
    numpy's stable argsort of -mass, and the weights follow the points."""
    net = km.KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K,
                         weight_keypoints="power")
    levels = np.array([3, 1, 3, 2, 1, 3, 2, 1], np.float32)  # masses with ties
    pts = {}

    def fake(img, return_feat=False, plain=False):
        feat = torch.tensor(np.broadcast_to(levels * float(img.sum()), (1, 2, 2, 2, K)).copy())
        p = torch.tensor(rng.uniform(-1, 1, (1, K, 3)).astype(np.float32))
        pts[float(img.sum())] = p
        return p, feat

    monkeypatch.setattr(net, "get_keypoints", fake)
    f, m = torch.ones((1, 1, 2, 2, 2)), 2 * torch.ones((1, 1, 2, 2, 2))
    pf, pm, w = net.pair_ranked_by_mass(f, m)
    order = np.argsort(-(levels * 8) * (levels * 16), kind="stable")
    assert list(order) == [0, 2, 5, 3, 6, 1, 4, 7]
    np.testing.assert_array_equal(_np(pf), _np(pts[8.0])[:, order])
    np.testing.assert_array_equal(_np(pm), _np(pts[16.0])[:, order])
    w_plain = levels ** 2 / (levels ** 2).sum()
    np.testing.assert_allclose(_np(w), w_plain[order][None], rtol=1e-6)


# -- the orchestrator on shared weights ---------------------------------------


def _models(rng, **kw):
    """keymorph_tpu's KeyMorph(use_amp=True) on a bf16 TruncatedUNet3D with
    GroupNorm affines away from (1, 0), and the port's KeyMorph on the same
    weights (CPU)."""
    jm = JKeyMorph(JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG), K, use_amp=True, **kw)
    jm.init_params(jax.random.PRNGKey(1), jnp.zeros((1, 1, 4, 4, 4), jnp.float32))
    flat = flax.traverse_util.flatten_dict(jm.params)
    for path, v in flat.items():
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    jm.params = flax.traverse_util.unflatten_dict(flat)
    tm = km.KeyMorph(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K, use_amp=True,
                     device="cpu", **kw)
    tm.load_flax_params(jm.params)
    return jm, tm


def _volumes(rng, n, spatial=SPATIAL):
    """n smooth blob volumes (n, 1, *spatial) with a little noise."""
    axes = [np.linspace(-1, 1, s) for s in spatial]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for _ in range(n):
        c = rng.uniform(-0.3, 0.3, 3)
        v = np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 0.3)
        out.append(v + 0.05 * rng.random(v.shape))
    return np.stack(out)[:, None].astype(np.float32)


def test_keymorph_forward_matches_jax(rng):
    """``model(img_f, img_m, transform_type=["rigid", "affine", "tps_0.1"],
    return_aligned_points=True)``: the same keys, shapes and dtypes as
    keymorph_tpu's; keypoints within KEYPOINT_ABS (bf16 backbones; measured
    4.2e-3); from the port's own keypoints every grid, matrix and aligned
    point set is keymorph_tpu's align_pair's within 5e-5 (measured <=
    6.7e-6, the affine fit of clustered keypoints). So end to end the grids
    and aligned points are held to what keymorph_tpu's own align_pair makes
    of the keypoints' difference (its output from the port's keypoints
    against its output from its own), plus that 5e-5: up to 2.5e-2 for the
    affine grid, as an untrained net's clustered keypoints amplify it."""
    jm, tm = _models(rng)
    f, m = _volumes(rng, 2)[:1], _volumes(rng, 1)
    types = ["rigid", "affine", "tps_0.1"]
    want = jm(jnp.asarray(f), jnp.asarray(m), transform_type=types, return_aligned_points=True)
    got = tm(f, m, transform_type=types, return_aligned_points=True)
    assert list(got) == types
    for name in types:
        g, r = got[name], want[name]
        assert set(g) == set(r), name
        for k, v in r.items():
            if k.startswith("time"):
                assert isinstance(g[k], float) and g[k] >= 0.0
            elif v is None:
                assert g[k] is None, k
            else:
                assert tuple(g[k].shape) == tuple(v.shape), k
                assert _np(g[k]).dtype == np.asarray(v).dtype, k
        d_kp = max(_dist(g["points_f"], r["points_f"]), _dist(g["points_m"], r["points_m"]))
        align_type, lm = km.parse_transform_type(name)
        stage = jalign_pair(jnp.asarray(_np(g["points_f"])), jnp.asarray(_np(g["points_m"])),
                            align_type, SPATIAL, lmbda=None if lm is None else jnp.full((1,), lm),
                            compute_grid=True, compute_aligned_points=True)
        d_stage = max(_dist(g[k], stage[k]) for k in stage)
        d_grid, d_pa = _dist(g["grid"], r["grid"]), _dist(g["points_a"], r["points_a"])
        sens = {k: _dist(stage[k], r[k]) for k in ("grid", "points_a")}
        print(f"{name}: keypoints {d_kp:.3g}, stage from the port's keypoints {d_stage:.3g}, "
              f"grid {d_grid:.3g}, points_a {d_pa:.3g} (keymorph_tpu's own response to the "
              f"keypoints' difference {sens})")
        assert d_kp <= KEYPOINT_ABS and d_stage <= 5e-5
        assert d_grid <= sens["grid"] + 5e-5 and d_pa <= sens["points_a"] + 5e-5
        if name.startswith("tps"):
            np.testing.assert_allclose(_np(g["tps_lmbda"]), 0.1)
    assert got["tps_0.1"]["grid"].device.type == "cpu"


def test_num_tps_centers_serving_and_training_subsample(rng):
    """``num_tps_centers=S``: keypoints come mass-ranked and the grid is the
    approximate fit on the first S (keymorph_tpu's KeyMorph on the same
    weights: keypoints within KEYPOINT_ABS, measured 4.2e-3; from the port's
    keypoints the grid is keymorph_tpu's ``align_pair(tps_centers=S)``
    within 1e-5, measured 8.9e-7). In training mode the exact solver takes
    ``max_train_keypoints`` keypoints."""
    jm, tm = _models(rng, num_tps_centers=5, max_train_keypoints=6)
    f, m = _volumes(rng, 2)[:1], _volumes(rng, 1)
    want = jm(jnp.asarray(f), jnp.asarray(m), transform_type="tps_0.1")["tps_0.1"]
    got = tm(f, m, transform_type="tps_0.1")["tps_0.1"]
    d_kp = _dist(got["points_f"], want["points_f"])
    stage = jalign_pair(jnp.asarray(_np(got["points_f"])), jnp.asarray(_np(got["points_m"])),
                        "tps", SPATIAL, lmbda=jnp.full((1,), 0.1), tps_centers=5)["grid"]
    print(f"ranked keypoints {d_kp:.3g}, grid from the port's keypoints {_dist(got['grid'], stage):.3g}")
    assert d_kp <= KEYPOINT_ABS and _dist(got["grid"], stage) <= 1e-5
    ranked = tm.net.pair_ranked_by_mass(_t(f), _t(m))
    np.testing.assert_array_equal(_np(got["points_f"]), _np(ranked[0]))
    tm.train()
    res = tm(f, m, transform_type="tps_0.5")["tps_0.5"]
    assert res["points_f"].shape == (1, 6, 3) and res["grid"].shape == (1, *SPATIAL, 3)
    assert res["grid"].requires_grad  # train mode keeps the graph
    tm.eval()
    with pytest.raises(ValueError):
        tm.train()(f, m, transform_type=["affine", "rigid"])


@pytest.mark.parametrize("weighting", [None, "power", "variance"])
def test_groupwise_register_matches_jax(rng, tmp_path, weighting):
    """4 subjects, ``["affine", "tps_1"]``, ``num_iters=3``, against
    keymorph_tpu's KeyMorph on the same weights: the result dict's keys and
    shapes; the group keypoints and (weighted) per-subject weights within
    KEYPOINT_ABS (measured 3.0e-3 and 3.6e-4). The registrations that follow
    are printed, not held: an untrained net's keypoints cluster, and
    keymorph_tpu's own iteration moves by 3.8e-4 when its input keypoints
    move by two fp32 ulps. The iteration and the grids are held on
    well-spread keypoints in test_groupwise_core_matches_jax. Unweighted, the
    subjects come from a directory of ``.npz`` files in chunks of 3 (the
    last one short, unpadded: the results equal one chunk of 4 bit for bit),
    and the grids are also saved to disk."""
    jm, tm = _models(rng, weight_keypoints=weighting)
    imgs = _volumes(rng, 4, (16, 16, 32))
    types = ["affine", "tps_1"]
    want = jm.groupwise_register(jnp.asarray(imgs), transform_type=types, num_iters=3)
    got = tm.groupwise_register(imgs, transform_type=types, num_iters=3)
    for name in types:
        g, r = got[name], want[name]
        assert set(g) == set(r) and isinstance(g["time"], float), name
        for k in r:
            if k != "time":
                assert tuple(g[k].shape) == tuple(r[k].shape), k
                assert bool(torch.isfinite(g[k]).all()), k
        d_kp = _dist(g["grouppoints_m"], r["grouppoints_m"])
        d_w = _dist(g["grouppoints_weights"], r["grouppoints_weights"]) if weighting else 0.0
        print(f"{weighting} {name}: keypoints {d_kp:.3g}, weights {d_w:.3g}; aligned "
              f"{_dist(g['grouppoints_a'], r['grouppoints_a']):.3g}, grids "
              f"{_dist(g['groupgrids'], r['groupgrids']):.3g} (not held)")
        assert d_kp <= KEYPOINT_ABS and d_w <= KEYPOINT_ABS
    if weighting is None:
        for i, v in enumerate(imgs):
            np.savez(os.path.join(tmp_path, f"img_{i:03}.npz"), img=v)
        chunked = tm.groupwise_register(str(tmp_path), transform_type=types, num_iters=3,
                                        kp_batch=3, grid_batch=3)
        for name in types:
            for k in ("grouppoints_m", "grouppoints_a", "groupgrids"):
                np.testing.assert_array_equal(_np(chunked[name][k]), _np(got[name][k]))
        tm.groupwise_register(str(tmp_path), transform_type="affine", num_iters=3,
                              save_results_to_disk=True, save_dir=str(tmp_path))
        saved = np.concatenate([np.load(os.path.join(tmp_path, f"affine_grid_{i:03}.npy"))
                                for i in range(4)])
        np.testing.assert_array_equal(saved, _np(got["affine"]["groupgrids"]))
        with pytest.raises(ValueError, match="numeric"):
            tm.groupwise_register(imgs, transform_type="tps_loguniform")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("align_type", ["affine", "rigid", "tps"])
def test_groupwise_core_matches_jax(rng, align_type, weighted):
    """The groupwise iteration (3 rounds to the mean) and the grids to the
    final mean, on well-spread keypoints of 5 subjects (each an affine
    copy of one set, plus noise), against keymorph_tpu's: the aligned
    points and the mean within 1e-5, the grids within 1e-5 (measured
    <= 8.4e-7)."""
    N, T, spatial = 5, 10, (6, 8, 10)
    base = rng.uniform(-0.7, 0.7, (T, 3))
    pts = np.stack([base @ (np.eye(3) + 0.05 * rng.normal(size=(3, 3))).T
                    + 0.05 * rng.normal(size=3) + 0.01 * rng.normal(size=(T, 3))
                    for _ in range(N)]).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (N, T)).astype(np.float32) if weighted else None
    if weighted:
        w /= w.sum(1, keepdims=True)
    lm = np.full((1,), 1.0, np.float32) if align_type == "tps" else None
    curr, mean = km._groupwise_iterate(_t(pts), None if lm is None else _t(lm),
                                       None if w is None else _t(w), align_type, 3)
    jcurr, jmean = j_groupwise_iterate(jnp.asarray(pts), None if lm is None else jnp.asarray(lm),
                                       None if w is None else jnp.asarray(w),
                                       align_type=align_type, num_iters=3)
    grids = km._groupwise_grids(mean, _t(pts), None if lm is None else _t(lm).expand(N),
                                None if w is None else _t(w), align_type, spatial, 4)
    jgrids = j_groupwise_grids(jmean, jnp.asarray(pts),
                               None if lm is None else jnp.full((N,), 1.0),
                               None if w is None else jnp.asarray(w), align_type=align_type,
                               spatial=spatial, num_chunks=4)
    d = (_dist(curr, jcurr), _dist(mean, jmean), _dist(grids, jgrids))
    print(f"{align_type} weighted={weighted}: aligned {d[0]:.3g}, mean {d[1]:.3g}, "
          f"grids {d[2]:.3g}")
    assert grids.shape == (N, *spatial, 3) and max(d) <= 1e-5


def test_keymorph_self_registration_identity(rng):
    """An image registered to itself gives the identity (tests/test_models.py:
    matrix within 1e-3 of eye(4)), for affine and rigid."""
    _, tm = _models(rng)
    img = _volumes(rng, 1)
    res = tm(img, img, transform_type=["affine", "rigid"])
    for name in ("affine", "rigid"):
        np.testing.assert_allclose(_np(res[name]["matrix"])[0], np.eye(4), atol=1e-3)


# -- on trained weights (runs/torch_weight_parity) ----------------------------

TRAINED = Path(__file__).resolve().parents[1] / "runs" / "torch_weight_parity"
TRAINED_NET = dict(num_keypoints=32, f_maps=8, num_levels=3)
# Flat bars on the committed truncated net and a 32^3 phantom pair, the
# port in fp32 against keymorph_tpu registering from its float64 keypoints
# (tests/test_torch_weight_parity.py), at most about twice what was read.
TRAINED_KEYPOINT_ABS = 1e-6    # read 4.77e-7
TRAINED_ABS = 1e-5             # grids, matrices, aligned images and points: read <= 7.1e-6
TRAINED_TPS_GRID_ABS = 5e-5    # the tps_0.1 fit carries the keypoints' gap: read 2.11e-5


def trained_models():
    """keymorph_tpu's KeyMorph with its backbone in float64
    (``test_torch_weight_parity.Float64KeyMorph``) and the port's in fp32,
    on the committed trained TruncatedUNet3D, the file loaded by each
    package's own reader."""
    from keymorph_tpu_torch.tools import weight_parity as wp
    from test_torch_weight_parity import jax_float64_model

    path = TRAINED / wp.CHECKPOINTS["truncatedunet"]
    jm = jax_float64_model(path, "truncatedunet", **TRAINED_NET)
    tm = wp.load_port(path, backbone="truncatedunet", device="cpu", **TRAINED_NET)
    return jm, tm


def test_keymorph_forward_matches_jax_on_trained_weights():
    """``model(img_f, img_m, transform_type=["rigid", "affine", "tps_0.1"],
    return_aligned_points=True)`` on the committed trained net and a
    held-out phantom pair at 32^3: keypoints within TRAINED_KEYPOINT_ABS of
    keymorph_tpu's float64 ones, every grid (TPS: TRAINED_TPS_GRID_ABS),
    matrix and aligned point set within TRAINED_ABS of keymorph_tpu's
    registration from them, flat (printed)."""
    from keymorph_tpu_torch.tools.make_synthetic_dataset import make_subjects

    jm, tm = trained_models()
    imgs, _ = make_subjects(n_subjects=2, size=32, seed=7)
    f, m = imgs[0:1], imgs[1:2]
    types = ["rigid", "affine", "tps_0.1"]
    want = jm(jnp.asarray(f), jnp.asarray(m), transform_type=types, return_aligned_points=True)
    got = tm(f, m, transform_type=types, return_aligned_points=True)
    for name in types:
        g, r = got[name], want[name]
        d_kp = max(_dist(g["points_f"], r["points_f"]), _dist(g["points_m"], r["points_m"]))
        d = {k: _dist(g[k], r[k]) for k in ("grid", "points_a", "matrix") if k in r}
        print(f"{name} (trained): keypoints {d_kp:.3g}, {d}")
        grid_bar = TRAINED_TPS_GRID_ABS if name.startswith("tps") else TRAINED_ABS
        assert d_kp <= TRAINED_KEYPOINT_ABS and d.pop("grid") <= grid_bar, name
        assert max(d.values()) <= TRAINED_ABS, name
