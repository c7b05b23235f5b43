"""The slice as a whole on the CPU: the port's evaluation harness
(keymorph_tpu_torch.cli.eval_pairwise / eval_groupwise) and its register
CLI against keymorph_tpu's, at 16^3-24^3.

(a) ``make_batch_score_fn`` of both packages on identical grids, volumes,
    one-hot segmentations and a padded ``ch_mask`` (two pairs with
    different label counts): every metric within 1e-5 (the warp's measured
    distance from keymorph_tpu's), the per-region hard Dice and the
    Hausdorff distance exactly, and the hard Dice (their masked mean) within
    2^-21: the two packages sum the regions (up to 8 here) in another order,
    and each term carries up to 2^-24 of fp32 rounding.
(b) ``run_eval`` of both packages on the same NIfTI pairs, each with a stub
    registration model returning the same numpy grids and points: the same
    metric keys within (a)'s bars, the same artifact file names, each array
    within the same bars (labels exactly).
(c) the register CLI end to end on tiny NIfTIs with one reference-format
    ``.pt``, pairwise (rigid, affine, tps_1) and ``--groupwise`` (4
    subjects), through both packages: equal metric keys and artifact file
    sets, the saved keypoints within 2e-2 (the bar of
    tests/test_torch_keymorph.py). Random-weight nets give ill-conditioned
    fits, so the metric values themselves are not held in (c).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.cli import eval_pairwise as jeval
from keymorph_tpu.data import datasets as jdatasets
from keymorph_tpu.data import preprocess as jpreprocess
from keymorph_tpu.ops.resample import align_img as jalign_img
from keymorph_tpu_torch.cli import eval_pairwise as teval
from keymorph_tpu_torch.data import datasets as tdatasets
from keymorph_tpu_torch.data import preprocess as tpreprocess
from keymorph_tpu_torch.data.nifti import save_nifti
from keymorph_tpu_torch.ops.resample import align_img

METRIC_ABS = 1e-5   # the warp's measured distance from keymorph_tpu's (1e-6-1e-5)
HARDDICE_ABS = 8 * 2.0 ** -24  # up to 8 regions summed in another order, 2^-24 each
KEYPOINT_ABS = 2e-2
KEYPOINT_ABS_FP32 = 1e-4
ALIGNS = ["rigid", "affine", "tps_1"]
METRICS = ["mse", "softdice", "harddice", "harddiceroi", "hausd", "jdstd", "jdlessthan0"]
EXACT = ("harddiceroi", "hausd")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, B, spatial, amp, freq=1.0):
    """(B, *spatial, 3) xy sampling grids: the identity at voxel centres
    plus a random sinusoidal displacement of ``amp`` (normalized units) and
    frequencies ~``freq``. The Jacobian statistics take the grid itself
    (the identity added to its voxel differences), so a grid folds once
    ``amp * freq * 2 / n`` passes ~1."""
    axes = [(2 * np.arange(n) + 1) / n - 1 for n in spatial]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    ident = np.stack([x, y, z], axis=-1)
    out = []
    for _ in range(B):
        c = freq * rng.normal(size=(3, 3))
        disp = np.stack([amp * np.sin(c[k, 0] * z + c[k, 1] * y + c[k, 2] * x + k)
                         for k in range(3)], axis=-1)
        out.append(ident + disp)
    return np.stack(out).astype(np.float32)


def _blobs(rng, spatial, n_labels):
    """A smooth image and a label map of ``n_labels`` labels (0 =
    background) from a few Gaussian blobs."""
    axes = [np.linspace(-1, 1, n) for n in spatial]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    img = np.zeros(spatial)
    seg = np.zeros(spatial, np.int16)
    for label in range(1, n_labels):
        c = rng.uniform(-0.5, 0.5, 3)
        r2 = (z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2
        img += rng.uniform(0.3, 1.0) * np.exp(-r2 / 0.1)
        seg[r2 < rng.uniform(0.05, 0.15)] = label
    img += 0.05 * rng.random(spatial)
    return img.astype(np.float32), seg


def _onehot(labels, c):
    return np.eye(c, dtype=np.float32)[labels].transpose(0, 4, 1, 2, 3)


def _close(name, ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    if name.split(":")[0] in EXACT:
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    elif name.split(":")[0] == "harddice":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=HARDDICE_ABS, err_msg=name)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=METRIC_ABS, err_msg=name)


# ---------------------------------------------------------------------------
# (a) the batched scorer
# ---------------------------------------------------------------------------


def test_batch_score_fn_matches_jax(rng):
    spatial = (16, 18, 20)
    n_cls = (3, 5)
    n_max = max(n_cls)
    img_f = np.stack([_blobs(rng, spatial, 4)[0] for _ in n_cls])[:, None]
    img_m = np.stack([_blobs(rng, spatial, 4)[0] for _ in n_cls])[:, None]
    seg_f = _onehot(np.stack([_blobs(rng, spatial, n)[1] for n in n_cls]), n_max)
    seg_m = _onehot(np.stack([_blobs(rng, spatial, n)[1] for n in n_cls]), n_max)
    ch_mask = np.zeros((2, n_max), np.float32)
    for b, n in enumerate(n_cls):
        ch_mask[b, :n] = 1.0
    grids = tuple(_grid(rng, 2, spatial, amp, freq)
                  for amp, freq in ((0.02, 1.0), (0.08, 1.0), (1.5, 8.0)))
    aligns = ("rigid", "affine", "tps_1")

    jfn = jeval.make_batch_score_fn(aligns, METRICS, True, 3, jalign_img, True)
    jout, jch0, jvols = jfn(tuple(jnp.asarray(g) for g in grids), jnp.asarray(img_f),
                            jnp.asarray(img_m), jnp.asarray(seg_f), jnp.asarray(seg_m),
                            jnp.asarray(ch_mask))
    tfn = teval.make_batch_score_fn(aligns, METRICS, True, 3, align_img, True)
    with torch.no_grad():
        tout, tch0, tvols = tfn(tuple(torch.tensor(g) for g in grids), torch.tensor(img_f),
                                torch.tensor(img_m), torch.tensor(seg_f), torch.tensor(seg_m),
                                torch.tensor(ch_mask))
    np.testing.assert_array_equal(tch0.numpy(), np.asarray(jch0))
    worst = {}
    for align in aligns:
        assert set(tout[align]) == set(jout[align])
        for k, v in tout[align].items():
            _close(k, v.numpy(), np.asarray(jout[align][k]))
            worst[k] = max(worst.get(k, 0.0), float(np.abs(v.numpy() - np.asarray(
                jout[align][k], np.float64)).max()))
        img_a, labels = tvols[align]
        jimg_a, jseg_a = jvols[align]
        np.testing.assert_allclose(img_a.numpy(), np.asarray(jimg_a), atol=METRIC_ABS)
        np.testing.assert_array_equal(labels.numpy(), np.argmax(np.asarray(jseg_a), axis=1))
    print("make_batch_score_fn, max |port - keymorph_tpu| per metric:", worst)
    # the third grid folds (non-positive determinants)
    assert float(tout["tps_1"]["jdlessthan0"].max()) > 0
    # the padded channels stay out of pair 0's per-channel mean
    assert tout["rigid"]["harddiceroi"].shape == (2, n_max - 1)


def test_batch_score_fn_matches_metrics_for_pair(rng):
    """The batched scorer equals the sequential suite, pair by pair (the
    per-pair channel mask recovers each pair's own label set)."""
    from types import SimpleNamespace

    spatial = (12, 14, 16)
    n_cls = (3, 4)
    img_f = np.stack([_blobs(rng, spatial, 3)[0] for _ in n_cls])[:, None]
    img_m = np.stack([_blobs(rng, spatial, 3)[0] for _ in n_cls])[:, None]
    labels_f = [_blobs(rng, spatial, n)[1] for n in n_cls]
    labels_m = [_blobs(rng, spatial, n)[1] for n in n_cls]
    ch_mask = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    grid = torch.tensor(_grid(rng, 2, spatial, 0.05))
    fn = teval.make_batch_score_fn(("tps_1",), METRICS, True, 3, align_img, False)
    seg_f = torch.tensor(_onehot(np.stack(labels_f), 4))
    seg_m = torch.tensor(_onehot(np.stack(labels_m), 4))
    with torch.no_grad():
        out, ch0_f, _ = fn((grid,), torch.tensor(img_f), torch.tensor(img_m), seg_f, seg_m,
                           ch_mask)
    e = out["tps_1"]
    for j, n in enumerate(n_cls):
        sl = slice(j, j + 1)
        img_a = align_img(grid[sl], torch.tensor(img_m[sl]))
        seg_a = align_img(grid[sl], seg_m[sl, :n].contiguous())
        ref = teval._metrics_for_pair(METRICS, SimpleNamespace(dim=3), True,
                                      torch.tensor(img_f[sl]), img_a, seg_f[sl, :n], seg_a,
                                      grid[sl])
        got = {"mse": float(e["mse"][j]), "softdiceloss": float(e["softdiceloss"][j]),
               "harddice": float(e["harddice"][j]),
               "harddiceroi": e["harddiceroi"][j][: n - 1].tolist(),
               "hausd": teval.M.hausdorff_from_ch0_masks(e["ch0_a"][j: j + 1].numpy(),
                                                         ch0_f[j: j + 1].numpy()),
               "jdstd": float(e["jdstd"][j]), "jdlessthan0": float(e["jdlessthan0"][j])}
        for k, v in got.items():
            np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_per_pair_dice_in_float64_matches_fp32(rng):
    """The scorer's hard Dice never forms the argmax one-hot: its counts
    are exact, so fp32 and float64 sums give the same Dice up to the
    division's rounding."""
    p = rng.random((2, 4, 6, 7, 8)).astype(np.float32)
    t = _onehot(rng.integers(0, 4, (2, 6, 7, 8)), 4)
    mask = torch.ones((2, 4))
    for hard in (True, False):
        a = teval._per_pair_dice(torch.tensor(p), torch.tensor(t), hard, mask, True)
        b = teval._per_pair_dice(torch.tensor(p), torch.tensor(t), hard, mask, True,
                                 dtype=torch.float64)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# (b) the harness with a stub registration model
# ---------------------------------------------------------------------------


class _Stub:
    """Returns the same seeded numpy grids and points whatever the images."""

    def __init__(self, spatial, device=None):
        rng = np.random.default_rng(11)
        self.out = {}
        for a, amp in zip(ALIGNS, (0.03, 0.06, 0.2)):
            pf = rng.uniform(-0.7, 0.7, (2, 6, 3)).astype(np.float32)
            self.out[a] = {"grid": _grid(rng, 2, spatial, amp), "points_f": pf,
                           "points_m": pf + 0.01, "points_a": pf - 0.01,
                           "points_weights": None, "time": 0.0}
        if device is not None:
            self.device = torch.device(device)

    def __call__(self, img_f, img_m, transform_type, return_aligned_points, aff_f, aff_m):
        B = img_f.shape[0]
        return {a: {k: (v[:B] if isinstance(v, np.ndarray) else v)
                    for k, v in self.out[a].items()} for a in transform_type}


class _Args:
    dim = 3
    seg_available = True
    skip_if_completed = False
    early_stop_eval_subjects = None
    visualize = False


def _pairs_on_disk(tmp_path, spatial):
    """Two NIfTI pairs at ``spatial`` with 4 and 6 labels."""
    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((4, 6)):
        row = []
        for side in ("f", "m"):
            img, seg = _blobs(rng, spatial, n)
            ip, sp = str(tmp_path / f"img{i}{side}.nii.gz"), str(tmp_path / f"seg{i}{side}.nii.gz")
            save_nifti(ip, img)
            save_nifti(sp, seg)
            row.append((ip, sp))
        paths.append(row)
    return paths


def _loader(mod, paths, size, prep):
    pairs = [(mod.Subject(img_path=f[0], seg_path=f[1], modality="fixed"),
              mod.Subject(img_path=m[0], seg_path=m[1], modality="moving")) for f, m in paths]
    return mod.DataLoader(mod.PairedDataset(pairs, prep(size=(size,) * 3)), batch_size=1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("batch_pairs", [1, 2])
def test_run_eval_matches_jax(tmp_path, batch_pairs):
    """Both harnesses over the same two pairs (4 and 6 labels; batched two
    at a time, the one-hot ceiling and per-pair channel masks are in play),
    augmented by rot0 and rot90 (a cubic volume's rotation by quarter turns
    maps voxel centres onto voxel centres, so the nearest warp of the
    segmentation has no ties to break)."""
    size = 16
    paths = _pairs_on_disk(tmp_path, (12, 14, 16))
    augs = ["rot0", "rot90"]
    out = {}
    for name, mod, prep, run in (
            ("jax", jdatasets, jpreprocess.Preprocessor, jeval.run_eval),
            ("port", tdatasets, tpreprocess.Preprocessor, teval.run_eval)):
        args = _Args()
        args.model_eval_dir = tmp_path / name
        kw = {"device": "cpu"} if name == "port" else {}
        out[name] = run(_loader(mod, paths, size, prep), _Stub((size,) * 3), METRICS,
                        [("fixed", "moving")], augs, ALIGNS, args, batch_pairs=batch_pairs, **kw)
    assert set(out["port"]) == set(out["jax"])
    for k in out["jax"]:
        assert len(out["port"][k]) == len(out["jax"][k]) == 2
        for a, b in zip(out["port"][k], out["jax"][k]):
            _close(k, a, b)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert any(f.endswith("seg_a_1-fixed-moving-rot90-tps_1.npy") for f in files)
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".json"):
            continue  # the same values as the metric dicts above
        x, y = np.load(a), np.load(b)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        if "seg_" in f:
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            np.testing.assert_allclose(x, y, atol=METRIC_ABS, err_msg=f)


def test_run_eval_refuses_what_is_not_ported(tmp_path):
    """A non-mesh object is a TypeError. visualize is ported: both harnesses
    over one pair write the same files, among them keymorph_tpu's
    ``panel-{aug}-{align}.png``; without the artifacts the port still
    draws the panel (and saves no volume)."""
    args = _Args()
    args.model_eval_dir = tmp_path
    with pytest.raises(TypeError, match="Mesh"):
        teval.run_eval([], _Stub((8,) * 3, "cpu"), ["mse"], [("a", "b")], ["rot0"], ["affine"],
                       args, mesh=object())
    size = 16
    paths = _pairs_on_disk(tmp_path, (12, 14, 16))
    for name, mod, prep, run in (
            ("jax", jdatasets, jpreprocess.Preprocessor, jeval.run_eval),
            ("port", tdatasets, tpreprocess.Preprocessor, teval.run_eval),
            ("port_panels_only", tdatasets, tpreprocess.Preprocessor, teval.run_eval)):
        args = _Args()
        args.model_eval_dir = tmp_path / name
        args.visualize = True
        args.early_stop_eval_subjects = 1
        args.save_eval_artifacts = name != "port_panels_only"
        kw = {"device": "cpu"} if name.startswith("port") else {}
        run(_loader(mod, paths, size, prep), _Stub((size,) * 3), ["mse"], [("fixed", "moving")],
            ["rot0"], ["affine"], args, **kw)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert "eval/0_fixed_moving/panel-rot0-affine.png" in files
    assert _files(tmp_path / "port_panels_only") == [
        "eval/0_fixed_moving/metrics-rot0-affine.json", "eval/0_fixed_moving/panel-rot0-affine.png"]


# ---------------------------------------------------------------------------
# (c) the register CLI end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Tiny NIfTIs (two pair members, a group of 4 with segmentations) and
    one reference-format checkpoint (``{"state_dict": {"backbone.<key>":
    tensor}}``) of a bf16 U-Net with 2 levels and 8 keypoints."""
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import Config, build_backbone

    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for i in range(2):
        img, seg = _blobs(rng, (12, 12, 12), 3 + i)
        save_nifti(str(root / f"img{i}.nii.gz"), img)
        save_nifti(str(root / f"seg{i}.nii.gz"), seg)
    (root / "group").mkdir()
    (root / "groupseg").mkdir()
    for i in range(4):
        img, seg = _blobs(rng, (12, 12, 12), 3)
        save_nifti(str(root / "group" / f"sub{i}.nii.gz"), img)
        save_nifti(str(root / "groupseg" / f"sub{i}_seg.nii.gz"), seg)
    backbone = build_backbone(Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2,
                                     use_amp=True))
    init_weights(backbone, torch.Generator().manual_seed(5))
    torch.save({"state_dict": {"backbone." + k: v for k, v in backbone.state_dict().items()}},
               root / "weights.pt")
    return root


def _cli_args(root, groupwise):
    net = ["--num_keypoints", "8", "--backbone", "unet", "--num_levels_for_unet", "2",
           "--use_amp", "--load_path", str(root / "weights.pt"), "--size", "24"]
    if groupwise:
        return net + ["--moving", str(root / "group"), "--moving_seg", str(root / "groupseg"),
                      "--groupwise", "--group_size", "4", "--list_of_aligns", "affine", "tps_1",
                      "--list_of_metrics", *METRICS]
    return net + ["--moving", str(root / "img0.nii.gz"), "--fixed", str(root / "img1.nii.gz"),
                  "--moving_seg", str(root / "seg0.nii.gz"),
                  "--fixed_seg", str(root / "seg1.nii.gz"), "--list_of_aligns", *ALIGNS,
                  "--list_of_metrics", *METRICS, "--list_of_augs", "rot0", "rot45"]


def _run_port_cli(args, save_dir):
    from keymorph_tpu_torch.cli.register import main

    return main(args + ["--save_dir", str(save_dir), "--device", "cpu"])


def _run_jax_cli(args, save_dir):
    from keymorph_tpu.cli.register import main

    return main(args + ["--save_dir", str(save_dir)])


@pytest.mark.parametrize("groupwise", [False, True], ids=["pairwise", "groupwise"])
def test_register_cli_matches_jax(cli_inputs, tmp_path, groupwise):
    args = _cli_args(cli_inputs, groupwise)
    ours = _run_port_cli(args, tmp_path / "port")
    ref = _run_jax_cli(args, tmp_path / "jax")
    assert set(ours) == set(ref)
    assert all(len(ours[k]) == len(ref[k]) == 1 for k in ref)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    points = [f for f in files if os.path.basename(f).startswith(("points_f", "points_m"))]
    assert points
    worst = 0.0
    for f in points:
        x, y = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert x.shape == y.shape
        worst = max(worst, float(np.abs(x - y).max()))
    print(f"register CLI ({'groupwise' if groupwise else 'pairwise'}): saved keypoints "
          f"max |port - keymorph_tpu| {worst:.3g}")
    assert worst <= KEYPOINT_ABS


def test_register_cli_port_alone(cli_inputs, tmp_path):
    """The port's CLI alone (pairwise): every metric is finite, the JSONs
    hold the returned values, the grid and the artifacts have their shapes."""
    from keymorph_tpu_torch.cli.script_utils import load_dict_from_json

    metrics = _run_port_cli(_cli_args(cli_inputs, False), tmp_path)
    assert len(metrics) == len(METRICS) * 2 * len(ALIGNS)
    d = tmp_path / "register" / "0_fixed_moving"
    for align in ALIGNS:
        saved = load_dict_from_json(d / f"metrics-rot45-{align}.json")
        for m in METRICS:
            assert np.all(np.isfinite(saved[m]))
            assert saved[m] == metrics[f"{m}:fixed:moving:rot45:{align}"][0]
        assert np.load(d / f"grid_0-fixed-moving-rot45-{align}.npy").shape == (24, 24, 24, 3)
        assert np.load(d / f"seg_a_0-fixed-moving-rot45-{align}.npy").dtype == np.int64
    assert len(saved["harddiceroi"]) == 3  # labels 0-3, the background left out


def test_long_eval_keys_and_layout(cli_inputs, tmp_path):
    """``run_long_eval``: one subject's time series (3 scans) registered
    groupwise; keys ``metric:name:aug:align`` and the group directory's
    layout, every metric finite."""
    from types import SimpleNamespace

    from keymorph_tpu_torch.cli.eval_groupwise import run_long_eval
    from keymorph_tpu_torch.training.config import Config, build_model

    model = build_model(Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2,
                               use_amp=True), device="cpu")
    model.eval()
    series = tdatasets.SingleDataset(
        [tdatasets.Subject(img_path=str(cli_inputs / "group" / f"sub{i}.nii.gz"),
                           seg_path=str(cli_inputs / "groupseg" / f"sub{i}_seg.nii.gz"))
         for i in range(3)], tpreprocess.Preprocessor(size=(16, 16, 16)))
    args = SimpleNamespace(model_eval_dir=tmp_path, seg_available=True, dim=3,
                           early_stop_eval_subjects=None)
    metrics = ["mse", "harddice", "jdstd"]
    out = run_long_eval({"long": [series]}, model, metrics, ["long"], ["rot0"], ["affine", "tps_1"],
                        args)
    assert set(out) == {f"{m}:long:rot0:{a}" for m in metrics for a in ("affine", "tps_1")}
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in out.values())
    group = tmp_path / "long_eval" / "long_rot0_0"
    assert sorted(os.listdir(group / "img_m")) == [f"img_m_{i:03}.npz" for i in range(3)]
    assert len(os.listdir(group / "img_a_tps_1")) == 3
    assert (group / "metrics-affine.json").exists() and (group / "points_m-rot0.npy").exists()


def test_register_cli_refuses_unported_backbones(cli_inputs, tmp_path):
    """Named for the time the port refused the 2D backbones. ``--dim 2`` is
    ported as far as keymorph_tpu's CLI runs it: on the 3D scans it reads, a
    2D backbone runs slice by slice (flax's leading batch axes) and the
    keypoints and the registration stay 3D; both packages register the pair
    and agree on every saved keypoint (``KEYPOINT_ABS_FP32``: an fp32 U-Net,
    the fits on fp32 keypoints). What keymorph_tpu
    refuses at ``--dim 2`` the port refuses too, before it reads a scan or
    writes a file: the 3D-only backbones (keymorph_tpu asserts) and the
    Jacobian metrics (keymorph_tpu's scorer fails to make a number of the
    determinant reduced over two axes)."""
    args = ["--moving", str(cli_inputs / "img0.nii.gz"), "--fixed", str(cli_inputs / "img1.nii.gz"),
            "--moving_seg", str(cli_inputs / "seg0.nii.gz"),
            "--fixed_seg", str(cli_inputs / "seg1.nii.gz"), "--num_keypoints", "8", "--dim", "2",
            "--size", "16", "--list_of_aligns", "affine", "tps_1"]
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import Config, build_backbone

    backbone = build_backbone(Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2,
                                     dim=2))
    init_weights(backbone, torch.Generator().manual_seed(6))
    torch.save({"state_dict": {"backbone." + k: v for k, v in backbone.state_dict().items()}},
               tmp_path / "weights2d.pt")
    run = args + ["--backbone", "unet", "--num_levels_for_unet", "2", "--load_path",
                  str(tmp_path / "weights2d.pt"), "--list_of_metrics", "mse", "harddice", "hausd"]
    ours = _run_port_cli(run, tmp_path / "port")
    ref = _run_jax_cli(run, tmp_path / "jax")
    assert set(ours) == set(ref) and _files(tmp_path / "port") == _files(tmp_path / "jax")
    d = tmp_path / "port" / "register" / "0_fixed_moving"
    for f in ("points_f_0-fixed", "points_m_0-moving-rot0", "points_a_0-fixed-moving-rot0-tps_1"):
        x = np.load(d / f"{f}.npy")
        y = np.load(tmp_path / "jax" / "register" / "0_fixed_moving" / f"{f}.npy")
        assert x.shape == y.shape == (8, 3)
        print(f"register CLI --dim 2: {f} max |port - keymorph_tpu| {np.abs(x - y).max():.3g}")
        np.testing.assert_allclose(x, y, atol=KEYPOINT_ABS_FP32, rtol=0)
    for extra, err in ((["--backbone", "truncatedunet", "--use_amp"], AssertionError),
                       (["--backbone", "unet", "--list_of_metrics", "jdstd"], TypeError)):
        with pytest.raises(err):
            _run_jax_cli(args + extra, tmp_path / "jax_refused")
        with pytest.raises(ValueError, match="3D only|need --dim 3"):
            _run_port_cli(args + extra, tmp_path / "refused")
    assert not (tmp_path / "refused").exists() or not any((tmp_path / "refused").rglob("*.npy"))


def test_register_cli_default_and_fp32_backbones_match_jax(cli_inputs, tmp_path):
    """No 3D backbone is left unported: the register CLI's default
    ``--backbone conv`` (the fp32 ConvNet, at 32^3 so that its 16x
    downsampling leaves 2^3 heatmaps) and an fp32 ``unet`` (no
    ``--use_amp``) register a pair through both packages from the same
    reference-format weights, with equal metric keys and files and saved
    keypoints within ``KEYPOINT_ABS``."""
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import Config, build_backbone

    pair = ["--moving", str(cli_inputs / "img0.nii.gz"), "--fixed", str(cli_inputs / "img1.nii.gz"),
            "--moving_seg", str(cli_inputs / "seg0.nii.gz"),
            "--fixed_seg", str(cli_inputs / "seg1.nii.gz"), "--num_keypoints", "8",
            "--list_of_aligns", "affine", "tps_1", "--list_of_metrics", "mse", "harddice"]
    for name, net, size in (("conv", [], 32),
                            ("unet", ["--backbone", "unet", "--num_levels_for_unet", "2"], 16)):
        backbone = build_backbone(Config(num_keypoints=8, backbone=name, num_levels_for_unet=2))
        assert backbone.dtype == torch.float32
        init_weights(backbone, torch.Generator().manual_seed(7))
        weights = tmp_path / f"{name}.pt"
        torch.save({"state_dict": {"backbone." + k: v for k, v in backbone.state_dict().items()}},
                   weights)
        args = pair + net + ["--size", str(size), "--load_path", str(weights)]
        ours = _run_port_cli(args, tmp_path / name / "port")
        ref = _run_jax_cli(args, tmp_path / name / "jax")
        assert set(ours) == set(ref) and all(len(v) == 1 and np.isfinite(v[0])
                                             for v in ours.values())
        files = _files(tmp_path / name / "port")
        assert files == _files(tmp_path / name / "jax")
        points = [f for f in files if os.path.basename(f).startswith(("points_f", "points_m"))]
        assert points
        worst = max(float(np.abs(np.load(tmp_path / name / "port" / f)
                                 - np.load(tmp_path / name / "jax" / f)).max()) for f in points)
        print(f"register CLI, fp32 {name}: saved keypoints max |port - keymorph_tpu| {worst:.3g}")
        assert worst <= KEYPOINT_ABS


def test_load_weights_is_strict(cli_inputs, tmp_path):
    """Reference checkpoints load with their prefixes stripped (bare or
    under ``state_dict``); a missing or an unexpected key raises; the port's
    own checkpoint directory loads; a directory without ``checkpoint.pt``
    (keymorph_tpu's Orbax layout) raises naming the carry-over tool."""
    from keymorph_tpu_torch.cli.register import load_weights
    from keymorph_tpu_torch.training import checkpoint as ckpt
    from keymorph_tpu_torch.training.config import Config, build_model
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer

    config = Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2, use_amp=True)
    model = build_model(config, device="cpu")
    ref = torch.load(cli_inputs / "weights.pt", weights_only=True)["state_dict"]
    sd = {"module." + k: v for k, v in ref.items()}
    torch.save(sd, tmp_path / "bare.pth")
    load_weights(model, str(tmp_path / "bare.pth"))
    for k, v in model.net.backbone.state_dict().items():
        assert torch.equal(v, ref["backbone." + k])
    missing = dict(list(sd.items())[1:])
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_weights(model, str(tmp_path / "missing.pt"))
    torch.save({**sd, "module.extra.weight": torch.zeros(1)}, tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_weights(model, str(tmp_path / "extra.pt"))

    other = build_model(Config(**{**config.__dict__, "seed": 9}), device="cpu")
    state = TrainState.create(other.net, make_optimizer(config, other.net))
    path = ckpt.save_checkpoint(str(tmp_path / "ckpts"), 3, state)
    load_weights(model, path)
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, other.net.state_dict()[k])
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="import_flax_params"):
        load_weights(model, str(tmp_path / "orbax"))


def test_script_utils_and_hyperparameters(monkeypatch, capsys):
    from keymorph_tpu.cli import hyperparameters as jhp
    from keymorph_tpu.cli import script_utils as jsu
    from keymorph_tpu_torch.cli import hyperparameters as hp
    from keymorph_tpu_torch.cli import script_utils as su
    from keymorph_tpu_torch.training.config import Config, build_model

    for aug in ("rot0", "rot45", "rot90", "rot135", "rot180"):
        assert su.parse_test_aug(aug) == jsu.parse_test_aug(aug)
    with pytest.raises(NotImplementedError):
        su.parse_test_aug("flip")
    for name in ("EVAL_METRICS", "EVAL_UNI_NAMES", "EVAL_MULTI_NAMES", "EVAL_AUGS",
                 "EVAL_KP_ALIGNS"):
        assert getattr(hp, name) == getattr(jhp, name)
    model = build_model(Config(num_keypoints=8, backbone="unet", num_levels_for_unet=2,
                               use_amp=True), device="cpu")
    assert su.summary(model) == sum(p.numel() for p in model.net.parameters())
    # without wandb: keymorph_tpu's stdout fallback (tests/test_torch_viz.py
    # holds the calls made with it)
    monkeypatch.setitem(sys.modules, "wandb", None)  # the import raises ImportError
    assert su.initialize_wandb(Config()) is None
    assert capsys.readouterr().out.endswith("wandb not available; logging to stdout only\n")
