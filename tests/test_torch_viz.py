"""The port's panels (keymorph_tpu_torch/viz.py) and CLI hooks against
keymorph_tpu's on the CPU: every drawing function renders the same pixels
in both packages; the panels' device part (``_panel_arrays``: registration
and warp) hands the same arrays to the drawing as keymorph_tpu's
``render_registration_panels``; ``--visualize`` refuses before any work
where matplotlib is missing; ``--use_wandb`` falls back to stdout without
wandb and makes keymorph_tpu's ``wandb.init``/``wandb.log`` calls with it.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg

from keymorph_tpu import viz as jviz
from keymorph_tpu.cli import script_utils as jsu
from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph
from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.ops.resample import align_img as jalign_img
from keymorph_tpu.training.config import Config as JConfig
from keymorph_tpu_torch import viz
from keymorph_tpu_torch.cli import run
from keymorph_tpu_torch.cli import script_utils as su
from keymorph_tpu_torch.data import save_nifti
from keymorph_tpu_torch.models import keymorph as km
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.training.config import Config
from test_torch_keymorph import TRAINED_ABS, TRAINED_KEYPOINT_ABS, trained_models

K = 8
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
ARRAY_ABS = 1e-5   # fp32 backbones: images and keypoints of the two packages
RW_TPS_ABS = 1e-4  # real-world TPS from identical keypoints (tests/test_torch_keymorph.py)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _pixels(fn, tmp_path, name, *args, **kwargs):
    """Render through ``fn`` to a PNG and decode its pixels."""
    path = str(tmp_path / f"{name}.png")
    fn(*args, save_path=path, **kwargs)
    return mpimg.imread(path)


def _case(rng, kind):
    """(function name, args, kwargs) of one drawing case on seeded inputs."""
    vol = rng.normal(size=(12, 13, 14)).astype(np.float32)
    pts = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    w = rng.uniform(0.1, 1, size=6).astype(np.float32)
    if kind == "2d":
        img = rng.normal(size=(16, 18))
        p2 = rng.uniform(-1, 1, size=(5, 2))
        return "imshow_registration_2d", (img, img * 0.5, img.T[:16, :16], p2, p2, p2), \
            {"weights": rng.uniform(0.1, 1, 5)}
    if kind == "3d":
        return "imshow_registration_3d", (vol, vol * 0.5, vol + 1, pts, pts, pts), \
            {"weights": w, "suptitle": "pair"}
    if kind == "3d_slab_rotate":
        return "imshow_registration_3d", (vol, vol, vol, pts, pts, None), \
            {"projection": False, "slab_thickness": 6, "rotate_90_deg": 1}
    if kind == "points_3d_groups":
        return "imshow_img_and_points_3d", (vol, np.stack([pts, -pts])), \
            {"markers": (".", "x"), "projection": False, "rotate_90_deg": 3}
    if kind == "points_3d":
        return "imshow_img_and_points_3d", (vol, pts, w), {}
    return "plot_groupwise_register", ([vol[6], vol[:, 6], vol[..., 6]],
                                       [vol[5], vol[:, 5], vol[..., 5]]), {}


@pytest.mark.parametrize("kind", ["2d", "3d", "3d_slab_rotate", "points_3d_groups",
                                  "points_3d", "montage"])
def test_drawing_matches_jax_pixel_for_pixel(rng, tmp_path, kind):
    """Each drawing function on the same numpy inputs through both packages:
    PNGs whose decoded pixels are equal (the port's inputs as torch
    tensors, which its functions take as keymorph_tpu's take numpy)."""
    name, args, kwargs = _case(rng, kind)
    want = _pixels(getattr(jviz, name), tmp_path, "jax", *args, **kwargs)
    targs = [[torch.tensor(a) for a in x] if isinstance(x, list)
             else (torch.tensor(np.asarray(x)) if x is not None else None) for x in args]
    got = _pixels(getattr(viz, name), tmp_path, "port", *targs, **kwargs)
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def test_points_into_given_axes_match_jax(rng, tmp_path):
    """``imshow_img_and_points_3d(axes=...)`` draws into a caller's figure,
    as keymorph_tpu's does."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, args, kwargs = _case(rng, "points_3d")
    out = []
    for mod in (jviz, viz):
        fig, axes = plt.subplots(1, 3, figsize=(9, 3))
        assert mod.imshow_img_and_points_3d(*args, axes=axes, **kwargs) is fig
        path = str(tmp_path / f"{mod.__name__}.png")
        fig.savefig(path, dpi=60)
        plt.close(fig)
        out.append(mpimg.imread(path))
    np.testing.assert_array_equal(out[0], out[1])


def _models(rw):
    """keymorph_tpu's KeyMorph on an fp32 TruncatedUNet3D and the port's on
    the same weights (CPU)."""
    jm = JKeyMorph(JTruncatedUNet3D(dtype=jnp.float32, **CFG), K,
                   align_keypoints_in_real_world_coords=rw)
    jm.init_params(jax.random.PRNGKey(3), jnp.zeros((1, 1, 4, 4, 4), jnp.float32))
    tm = km.KeyMorph(TruncatedUNet3D(dtype=torch.float32, **CFG), K, device="cpu",
                     align_keypoints_in_real_world_coords=rw)
    tm.load_flax_params(jm.params)
    return jm, tm


def _pair(rng, spatial):
    axes = [np.linspace(-1, 1, s) for s in spatial]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    vols, segs = [], []
    for c in ((0.1, -0.2, 0.15), (-0.05, -0.1, 0.25)):
        v = np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 0.2)
        vols.append((v + 0.05 * rng.random(v.shape))[None, None].astype(np.float32))
        segs.append(np.digitize(v, [0.2, 0.5, 0.8])[None, None].astype(np.int32))
    return vols, segs


def _nearest_ties(grid, spatial, margin=1e-3):
    """Voxels whose nearest-warp sample lies within ``margin`` of a
    rounding tie (a coordinate's fraction at 0.5) on any axis: there two
    grids a few fp32 ulps apart may round to neighbouring voxels."""
    ties = np.zeros(grid.shape[1:-1], bool)
    for a in range(3):  # ij axis a is the grid's xy component 2 - a
        v = ((np.asarray(grid)[0, ..., 2 - a] + 1.0) * spatial[a] - 1.0) / 2.0
        ties |= np.abs(v - np.floor(v) - 0.5) <= margin
    return ties


@pytest.mark.parametrize("transform_type,one_hot,rw", [
    ("tps_1", False, False), ("affine", True, False), ("tps_1", True, True)])
def test_panel_arrays_match_jax(rng, tmp_path, monkeypatch, transform_type, one_hot, rw):
    """``_panel_arrays`` against the arrays keymorph_tpu's
    ``render_registration_panels`` hands its ``show`` on shared weights
    (fp32 backbone, 16 x 20 x 24; label maps or one-hot segmentations; with
    identity affines in real-world mode): the moving and fixed images
    equal, keypoints within ARRAY_ABS (measured <= 9.6e-7); the aligned
    image and points within ARRAY_ABS (RW_TPS_ABS in real-world TPS,
    measured 1.6e-5) of keymorph_tpu's registration of the port's own
    keypoints (the stage alone), and end to end within twice
    what keymorph_tpu's registration makes of the keypoints' difference
    plus ARRAY_ABS (the fit of an untrained net's clustered keypoints
    amplifies 1e-6 in keypoints to 1.2e-5-2.6e-5 in the aligned image,
    printed); segmentation labels equal but at voxels named as
    nearest-rounding ties; the model's train mode restored."""
    spatial = (16, 20, 24)
    (img_f, img_m), (seg_f, seg_m) = _pair(rng, spatial)
    if one_hot:
        seg_f, seg_m = (np.moveaxis(np.eye(4, dtype=np.float32)[s[:, 0]], -1, 1)
                        for s in (seg_f, seg_m))
    jm, tm = _models(rw)
    shown = []
    monkeypatch.setattr(jviz, "imshow_registration_3d",
                        lambda *a, **k: shown.append((a, k.get("weights"))))
    jviz.render_registration_panels(jm, jnp.asarray(img_f), jnp.asarray(img_m), transform_type,
                                    str(tmp_path / "jax"), "t", seg_f=seg_f, seg_m=seg_m)
    tm.train()
    got = viz._panel_arrays(tm, img_f, img_m, transform_type, seg_f=seg_f, seg_m=seg_m)
    assert tm.training  # restored
    (want_img, _), (want_seg, _) = shown
    names = ("moving", "fixed", "aligned", "points_m", "points_f", "points_a")
    d = {n: _dist(g, w) for n, g, w in zip(names, got["img"] + got["points"], want_img)}
    assert all(g.shape == np.shape(w) for g, w in zip(got["img"] + got["points"], want_img))
    # keymorph_tpu's registration of the port's own keypoints: the stage
    # alone, and what keymorph_tpu makes of the keypoints' difference
    p_m, p_f = got["points"][:2]
    eye = {"aff_f": jnp.eye(4)[None], "aff_m": jnp.eye(4)[None]} if rw else {}
    lm = {"lmbda": jnp.ones((1,))} if transform_type == "tps_1" else {}
    align = "tps" if transform_type.startswith("tps") else transform_type
    own = jalign_pair(jnp.asarray(p_f[None]), jnp.asarray(p_m[None]), align, spatial,
                      compute_aligned_points=True, **lm, **eye)
    own_img = np.asarray(jalign_img(own["grid"], jnp.asarray(img_m)))[0, 0]
    own_pa = np.asarray(own["points_a"])[0]
    stage = {"aligned": _dist(got["img"][2], own_img), "points_a": _dist(got["points"][2], own_pa)}
    amp = {"aligned": _dist(own_img, want_img[2]), "points_a": _dist(own_pa, want_img[5])}
    print(f"{transform_type} one_hot={one_hot} rw={rw}: port vs keymorph_tpu {d}; from the "
          f"port's keypoints {stage}; keymorph_tpu's own move from them {amp}")
    assert d["moving"] == d["fixed"] == 0.0
    assert max(d["points_m"], d["points_f"]) <= ARRAY_ABS
    stage_abs = RW_TPS_ABS if rw else ARRAY_ABS
    for k in ("aligned", "points_a"):
        assert stage[k] <= stage_abs and d[k] <= 2.0 * amp[k] + ARRAY_ABS, k
    np.testing.assert_array_equal(got["seg"][0], np.asarray(want_seg[0]))
    np.testing.assert_array_equal(got["seg"][1], np.asarray(want_seg[1]))
    res = tm.eval()(img_f, img_m, transform_type=transform_type, return_aligned_points=True,
                    **({"aff_f": np.eye(4)[None], "aff_m": np.eye(4)[None]} if rw else {}))
    ties = _nearest_ties(res[transform_type]["grid"].numpy(), spatial)
    differ = got["seg"][2] != np.asarray(want_seg[2])
    print(f"{transform_type} one_hot={one_hot} rw={rw}: labels differ at {differ.sum()} of "
          f"{differ.size} voxels, {ties.sum()} voxels near a tie")
    assert not np.any(differ & ~ties)


def test_render_registration_panels_writes_keymorph_tpu_files(rng, tmp_path):
    """``img_{tag}.png`` and ``seg_{tag}.png`` under ``out_dir``, as
    keymorph_tpu writes them."""
    (img_f, img_m), (seg_f, seg_m) = _pair(rng, (12, 12, 12))
    _, tm = _models(False)
    paths = viz.render_registration_panels(tm, img_f, img_m, "affine", str(tmp_path / "img"),
                                           "epoch1", seg_f=seg_f, seg_m=seg_m)
    assert [p.rsplit("/", 1)[1] for p in paths] == ["img_epoch1.png", "seg_epoch1.png"]
    assert all(mpimg.imread(p).shape[0] > 100 for p in paths)


def _hide_matplotlib(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))


def test_visualize_refuses_before_any_work_without_matplotlib(monkeypatch, tmp_path):
    """``require_matplotlib`` raises, naming matplotlib, where find_spec
    finds none; ``cli.run --visualize`` and the register CLI then refuse
    before loading data or building a model."""
    from keymorph_tpu_torch.cli import register
    from keymorph_tpu_torch.training import config as tconfig

    viz.require_matplotlib()  # installed here
    _hide_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.require_matplotlib()

    def untouched(*a, **k):
        raise AssertionError("work began before the refusal")

    monkeypatch.setattr(run, "get_data", untouched)
    monkeypatch.setattr(tconfig, "build_model", untouched)
    with pytest.raises(ImportError, match="matplotlib"):
        run.main(["--visualize", "--device", "cpu", "--save_dir", str(tmp_path)])
    with pytest.raises(ImportError, match="matplotlib"):
        register.main(["--moving", "m.nii.gz", "--fixed", "f.nii.gz", "--visualize",
                       "--device", "cpu", "--save_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


class _FakeWandb:
    """A stand-in ``wandb`` module recording its calls."""

    def __init__(self):
        self.calls = []

    def module(self):
        mod = types.ModuleType("wandb")
        mod.init = lambda **kw: self.calls.append(("init", kw))
        mod.log = lambda stats: self.calls.append(("log", dict(stats)))
        return mod


def test_initialize_wandb_matches_jax(monkeypatch, tmp_path, capsys):
    """Without wandb both packages print the same line and return None;
    with it both read the key file into WANDB_API_KEY and call
    ``wandb.init`` with the same name, config keys and extra kwargs."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
    assert su.initialize_wandb(Config()) is None
    assert jsu.initialize_wandb(JConfig()) is None
    out = capsys.readouterr().out.splitlines()
    assert out == ["wandb not available; logging to stdout only"] * 2

    key = tmp_path / "key"
    key.write_text("secret\n")
    inits = []
    for mod, cfg in ((su, Config), (jsu, JConfig)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake.module())
        monkeypatch.delenv("WANDB_API_KEY", raising=False)
        config = cfg(job_name="km", wandb_api_key_path=str(key),
                     wandb_kwargs={"project": "p", "mode": "offline"})
        assert mod.initialize_wandb(config) is sys.modules["wandb"]
        import os

        assert os.environ["WANDB_API_KEY"] == "secret"
        (name, kw), = fake.calls
        inits.append((kw["name"], sorted(kw["config"]), kw["project"], kw["mode"]))
    assert inits[0] == inits[1]


def _tiny_csv(root):
    """tests/test_torch_run_cli.py's dataset at 12^3."""
    rng = np.random.default_rng(0)
    rows = []
    for i, (mod, train) in enumerate(
            [("T1", True), ("T1", True), ("T2", True), ("T1", False), ("T2", False)]):
        save_nifti(str(root / f"img{i}.nii.gz"),
                   rng.uniform(0, 1, size=(12, 12, 12)).astype(np.float32))
        save_nifti(str(root / f"seg{i}.nii.gz"),
                   rng.integers(0, 3, size=(12, 12, 12)).astype(np.int16))
        rows.append(f"{root / f'img{i}.nii.gz'},{root / f'seg{i}.nii.gz'},None,{mod},{train}")
    (root / "data.csv").write_text("img_path,seg_path,mask_path,modality,train\n"
                                   + "\n".join(rows) + "\n")
    return str(root / "data.csv")


@pytest.mark.parametrize("mode", ["train", "pretrain"])
def test_run_cli_logs_each_epoch_to_wandb(monkeypatch, tmp_path, mode):
    """``cli.run --use_wandb`` in debug mode (2 epochs): one ``wandb.init``
    and one ``wandb.log`` an epoch, of keymorph_tpu's keys: the epoch's
    stats, which both packages also write to ``train_log.jsonl`` beside
    the epoch number (keymorph_tpu's ``cli/run.py`` logs exactly what it
    writes there; its own CLI compiles its steps for minutes, so its keys
    are its ``train_log`` keys, as tests/test_torch_run_cli.py holds them)."""
    import json

    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake.module())
    csv_path = _tiny_csv(tmp_path)
    run.main(["--num_keypoints", "8", "--data_path", csv_path, "--train_dataset", "csv",
              "--save_dir", str(tmp_path / "out"), "--device", "cpu", "--run_mode", mode,
              "--debug_mode", "--use_wandb", "--backbone", "truncatedunet", "--use_amp",
              "--num_levels_for_unet", "3", "--img_size", "16", "16", "16", "--job_name", "wb"])
    kinds = [c[0] for c in fake.calls]
    assert kinds == ["init", "log", "log"]
    assert fake.calls[0][1]["name"] == "wb"
    with open(tmp_path / "out" / "wb" / "train_log.jsonl") as fh:
        lines = [json.loads(line) for line in fh]
    want = ({"mse", "loss", "grad_norm", "epoch_time", "steps_per_sec"} if mode == "train"
            else {"mse", "loss", "epoch_time"})
    for (_, stats), line in zip(fake.calls[1:], lines):
        assert set(stats) == want
        assert {k: float(v) for k, v in stats.items()} == {k: line[k] for k in want}


def test_groupwise_visualize_writes_keymorph_tpus_montage(rng, tmp_path):
    """The register CLI's ``--groupwise --visualize``: ``groupwise_{align}.png``
    in the group's directory, pixel for pixel keymorph_tpu's
    ``plot_groupwise_register`` of the centre slices of the subjects before
    (``img_m``) and after (``img_a_{align}``) alignment, as its harness
    takes them."""
    from keymorph_tpu_torch.cli import register
    from keymorph_tpu_torch.models.unet import init_weights
    from keymorph_tpu_torch.training.config import build_backbone

    (tmp_path / "group").mkdir()
    for i in range(4):
        save_nifti(str(tmp_path / "group" / f"sub{i}.nii.gz"),
                   rng.uniform(0, 1, size=(12, 12, 12)).astype(np.float32))
    backbone = build_backbone(Config(num_keypoints=K, backbone="unet", num_levels_for_unet=2,
                                     use_amp=True))
    init_weights(backbone, torch.Generator().manual_seed(5))
    torch.save({"state_dict": {"backbone." + k: v for k, v in backbone.state_dict().items()}},
               tmp_path / "weights.pt")
    aligns = ["affine", "tps_1"]
    register.main(["--moving", str(tmp_path / "group"), "--groupwise", "--group_size", "4",
                   "--num_keypoints", str(K), "--backbone", "unet", "--num_levels_for_unet", "2",
                   "--use_amp", "--load_path", str(tmp_path / "weights.pt"), "--size", "16",
                   "--list_of_aligns", *aligns, "--list_of_metrics", "mse", "--visualize",
                   "--save_dir", str(tmp_path / "out"), "--device", "cpu"])
    group_dir = tmp_path / "out" / "group_eval" / "group_rot0_4"
    for align in aligns:
        got = mpimg.imread(str(group_dir / f"groupwise_{align}.png"))
        before = [np.load(p)["img"][0, 0] for p in sorted((group_dir / "img_m").iterdir())]
        after = [np.load(p)[0, 0] for p in sorted((group_dir / f"img_a_{align}").iterdir())]
        want = _pixels(jviz.plot_groupwise_register, tmp_path, f"jax_{align}",
                       [b[b.shape[0] // 2] for b in before], [a[a.shape[0] // 2] for a in after])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transform_type,one_hot", [("tps_1", False), ("affine", True)])
def test_panel_arrays_match_jax_on_trained_weights(tmp_path, monkeypatch, transform_type, one_hot):
    """``_panel_arrays`` against keymorph_tpu's ``render_registration_panels``
    on the committed trained net (keymorph_tpu's keypoints from its backbone
    in float64) and a held-out phantom pair at 32^3 (label maps or one-hot
    segmentations), flat: the moving and fixed images equal, keypoints
    within TRAINED_KEYPOINT_ABS, the aligned image and points within
    TRAINED_ABS (printed); segmentation labels equal but at voxels named as
    nearest-rounding ties."""
    from keymorph_tpu_torch.tools.make_synthetic_dataset import make_subjects

    imgs, segs = make_subjects(n_subjects=2, size=32, seed=7)
    img_f, img_m = imgs[0:1], imgs[1:2]
    seg_f, seg_m = segs[0:1], segs[1:2]
    if one_hot:
        seg_f, seg_m = (np.moveaxis(np.eye(4, dtype=np.float32)[s[:, 0]], -1, 1)
                        for s in (seg_f, seg_m))
    jm, tm = trained_models()
    shown = []
    monkeypatch.setattr(jviz, "imshow_registration_3d",
                        lambda *a, **k: shown.append((a, k.get("weights"))))
    jviz.render_registration_panels(jm, jnp.asarray(img_f), jnp.asarray(img_m), transform_type,
                                    str(tmp_path / "jax"), "t", seg_f=seg_f, seg_m=seg_m)
    got = viz._panel_arrays(tm, img_f, img_m, transform_type, seg_f=seg_f, seg_m=seg_m)
    (want_img, _), (want_seg, _) = shown
    names = ("moving", "fixed", "aligned", "points_m", "points_f", "points_a")
    d = {n: _dist(g, w) for n, g, w in zip(names, got["img"] + got["points"], want_img)}
    print(f"{transform_type} one_hot={one_hot} (trained): port vs keymorph_tpu {d}")
    assert d["moving"] == d["fixed"] == 0.0
    assert max(d["points_m"], d["points_f"]) <= TRAINED_KEYPOINT_ABS
    assert max(d["aligned"], d["points_a"]) <= TRAINED_ABS
    np.testing.assert_array_equal(got["seg"][0], np.asarray(want_seg[0]))
    np.testing.assert_array_equal(got["seg"][1], np.asarray(want_seg[1]))
    res = tm(img_f, img_m, transform_type=transform_type)
    ties = _nearest_ties(res[transform_type]["grid"].numpy(), img_f.shape[2:])
    differ = got["seg"][2] != np.asarray(want_seg[2])
    print(f"labels differ at {differ.sum()} of {differ.size} voxels, {ties.sum()} near a tie")
    assert not np.any(differ & ~ties)
