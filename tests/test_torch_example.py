"""The port's pair example (keymorph_tpu_torch/examples/register_pair.py)
against the repo's examples/register_pair.py on the CPU: the same NIfTI
pair, the same weights (keymorph_tpu's ``KeyMorph.init_params`` patched to
install them; the port reads them from a checkpoint of its own), the same
grids, metrics and panels; and the refusal without matplotlib."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg

from keymorph_tpu.losses import DiceLoss as JDiceLoss
from keymorph_tpu.losses import mse_loss as jmse_loss
from keymorph_tpu.models import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph
from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.models.keymorph import parse_transform_type
from keymorph_tpu.ops.resample import align_img as jalign_img
from keymorph_tpu.utils import one_hot as jone_hot
from keymorph_tpu_torch.data import Preprocessor, save_nifti
from keymorph_tpu_torch.examples import register_pair as ex
from keymorph_tpu_torch.training import checkpoint as ckpt
from keymorph_tpu_torch.training.train import TrainState, make_optimizer
from keymorph_tpu_torch.training.config import Config

ROOT = Path(__file__).resolve().parents[1]
K = 16
SIZE = 32
POINTS_ABS = 1e-5     # fp32 nets on the same weights and volumes
FLOOR = 1e-5          # over twice keymorph_tpu's own move under the points' difference
METRIC_ABS = 1e-5     # MSE and hard Dice of the two packages from the same grid
PANEL_SHARE = 1e-3    # of a panel's pixel values, one 8-bit level apart at most
LINE = re.compile(r"^(rigid|affine|tps_1): mse=\d+\.\d{5} harddice=\d\.\d{4} \(\d+\.\d\ds\)$")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _write_pair(rng, d):
    """A blob pair at 36 x 32 x 28 (resized to SIZE^3 by the example) with
    4-label segmentations; returns the flags naming the files."""
    shape = (36, 32, 28)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    paths = {}
    for name, c in (("fixed", (0.1, -0.2, 0.15)), ("moving", (-0.05, -0.1, 0.25))):
        r2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        img = np.exp(-r2 / 0.3) + 0.05 * rng.random(shape)
        seg = np.digitize(r2, [0.15, 0.35, 0.6]).astype(np.uint8)  # labels 0-3
        seg = 3 - seg
        paths[name] = str(d / f"{name}.nii.gz")
        paths[f"{name}_seg"] = str(d / f"{name}_seg.nii.gz")
        save_nifti(paths[name], img.astype(np.float32))
        save_nifti(paths[f"{name}_seg"], seg)
    return ["--fixed", paths["fixed"], "--moving", paths["moving"], "--fixed_seg",
            paths["fixed_seg"], "--moving_seg", paths["moving_seg"], "--size", str(SIZE),
            "--num_keypoints", str(K)]


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_register_pair",
                                                  ROOT / "examples" / "register_pair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_register_pair_matches_jax_example(rng, tmp_path, monkeypatch, capsys):
    """Both examples on the same files and weights print the same lines in
    order. Keypoints within POINTS_ABS; the grid, the warped image, MSE and
    hard Dice each within twice what keymorph_tpu's own align_pair and
    metrics make of the keypoints' difference (its output from the port's
    keypoints against its output from its own) plus FLOOR, the rule of
    tests/test_torch_entry.py (hard Dice moves by a voxel at an argmax near
    tie: 2.9e-5 at this seed, in keymorph_tpu too); from keymorph_tpu's own
    grid the port's MSE and hard Dice within METRIC_ABS. The panel is
    keymorph_tpu's drawing of the port's arrays pixel for pixel (as
    tests/test_torch_viz.py holds the drawing); against keymorph_tpu's own
    panel file, whose keypoints differ by ~1e-6, at most one 8-bit level
    in at most PANEL_SHARE of the pixel values."""
    from keymorph_tpu import viz as jviz
    from keymorph_tpu_torch.losses import DiceLoss, mse_loss
    from keymorph_tpu_torch.ops.resample import align_img

    flags = _write_pair(rng, tmp_path)
    jkm = JKeyMorph(backbone=JTruncatedUNet3D(out_channels=K, f_maps=32, num_levels=4,
                                              num_truncated_layers=1), num_keypoints=K)
    small = jnp.zeros((1, 1, 8, 8, 8), jnp.float32)  # parameters do not depend on it
    jparams = jax.jit(jkm.net.init)(jax.random.PRNGKey(3), small, small)

    def install(self, key, example_img):
        self.params = jparams
        return jparams

    recorded = {}
    call = JKeyMorph.__call__

    def record(self, img_f, img_m, **kw):
        recorded.update(img_f=img_f, img_m=img_m, res=call(self, img_f, img_m, **kw))
        return recorded["res"]

    monkeypatch.setattr(JKeyMorph, "init_params", install)
    monkeypatch.setattr(JKeyMorph, "__call__", record)
    monkeypatch.setattr("sys.argv", ["register_pair.py", *flags, "--out", str(tmp_path / "jax")])
    _jax_example().main()
    want_lines = capsys.readouterr().out.strip().splitlines()

    # the port reads the same weights from a checkpoint of its own
    km = ex.build_model(K, device="cpu").load_flax_params(
        jax.tree_util.tree_map(np.asarray, jparams))
    state = TrainState.create(km.net, make_optimizer(Config(), km.net))
    ckpt_dir = ckpt.save_checkpoint(str(tmp_path / "ckpt"), 0, state)
    got = ex.main([*flags, "--out", str(tmp_path / "port"), "--device", "cpu",
                   "--checkpoint", ckpt_dir])
    got_lines = capsys.readouterr().out.strip().splitlines()
    assert got_lines[0] == f"loaded checkpoint {ckpt_dir}"
    assert [ln.split(":")[0] for ln in got_lines[1:4]] == [ln.split(":")[0] for ln in
                                                          want_lines[:3]] == list(ex.ALIGNS)
    assert all(LINE.match(ln) for ln in got_lines[1:4] + want_lines[:3]), got_lines + want_lines
    assert got_lines[4:] == [f"grids + panels saved to {tmp_path / 'port'}"]

    img_f, img_m = recorded["img_f"], recorded["img_m"]
    segs = [Preprocessor(size=(SIZE,) * 3).load(flags[flags.index(f"--{s}") + 1],
                                                seg_path=flags[flags.index(f"--{s}_seg") + 1])
            for s in ("fixed", "moving")]
    n_cls = int(max(s["seg"].max() for s in segs)) + 1
    seg_f, seg_m = (jone_hot(jnp.asarray(s["seg"][None], jnp.int32), n_cls) for s in segs)

    def jax_outputs(grid):
        img_a = jalign_img(grid, img_m)
        dice = 1 - float(JDiceLoss(hard=True)(jalign_img(grid, seg_m), seg_f, ign_first_ch=True))
        return {"grid": grid, "img_a": img_a, "mse": float(jmse_loss(img_f, img_a)),
                "harddice": dice}

    t = {k: torch.as_tensor(np.array(v)) for k, v in (("img_f", img_f), ("img_m", img_m),
                                                         ("seg_f", seg_f), ("seg_m", seg_m))}
    for name in ex.ALIGNS:
        g, r = got[name], recorded["res"][name]
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"grid_{name}.npy"),
                                      g["grid"][0].numpy())
        np.testing.assert_array_equal(np.load(tmp_path / "jax" / f"grid_{name}.npy"),
                                      np.asarray(r["grid"][0]))
        d_pts = max(_dist(g[k], r[k]) for k in ("points_f", "points_m"))
        align_type, lm = parse_transform_type(name)
        stage = jalign_pair(jnp.asarray(g["points_f"].numpy()), jnp.asarray(g["points_m"].numpy()),
                            align_type, (SIZE,) * 3,
                            lmbda=None if lm is None else jnp.full((1,), lm), compute_grid=True)
        want, moved_to = jax_outputs(r["grid"]), jax_outputs(stage["grid"])
        d = {k: _dist(g[k], want[k]) for k in want}
        moved = {k: _dist(moved_to[k], want[k]) for k in want}
        jgrid = torch.as_tensor(np.array(r["grid"]))
        on_grid = {"mse": abs(float(mse_loss(t["img_f"], align_img(jgrid, t["img_m"])))
                              - want["mse"]),
                   "harddice": abs(1 - float(DiceLoss(hard=True)(
                       align_img(jgrid, t["seg_m"]), t["seg_f"], ign_first_ch=True))
                       - want["harddice"])}
        print(f"{name}: keypoints {d_pts:.3g}; port vs keymorph_tpu {d}; keymorph_tpu's own "
              f"move {moved}; metrics from keymorph_tpu's grid {on_grid}")
        assert d_pts <= POINTS_ABS, name
        for k in d:
            assert d[k] <= 2 * moved[k] + FLOOR, (name, k)
        assert max(on_grid.values()) <= METRIC_ABS, name

        panel = mpimg.imread(tmp_path / "port" / f"panel_{name}.png")
        np.testing.assert_array_equal(panel, _pixels(
            jviz.imshow_registration_3d, tmp_path / f"jviz_{name}.png", img_m[0, 0], img_f[0, 0],
            g["img_a"][0, 0].numpy(), g["points_m"][0].numpy(), g["points_f"][0].numpy(),
            g["points_a"][0].numpy()))
        theirs = mpimg.imread(tmp_path / "jax" / f"panel_{name}.png")
        off = np.abs(panel - theirs)
        print(f"{name}: panel vs keymorph_tpu's file: {(off > 0).mean():.3g} of the values "
              f"differ, by at most {off.max() * 255:.3g} levels")
        assert panel.shape == theirs.shape
        assert (off > 0).mean() <= PANEL_SHARE and off.max() <= 1.0 / 255 + 1e-7, name


def _pixels(fn, path, *args):
    fn(*(np.asarray(a) for a in args), save_path=str(path))
    return mpimg.imread(path)


def test_main_refuses_without_matplotlib(monkeypatch, tmp_path):
    """Without matplotlib ``main`` raises ImportError naming it before any
    work: no file read, no model built, nothing written."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))

    def never(*a, **k):
        raise AssertionError("work started")

    monkeypatch.setattr(ex, "build_model", never)
    monkeypatch.setattr(ex, "register_pair", never)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match="matplotlib"):
        ex.main(["--fixed", str(tmp_path / "missing.nii.gz"), "--moving",
                 str(tmp_path / "missing.nii.gz"), "--out", str(out), "--device", "cpu"])
    assert not out.exists()
