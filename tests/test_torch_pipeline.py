"""Slice 1 end to end: keymorph_tpu_torch's pairwise TPS registration
(KeyMorphNet keypoints -> align_pair(compute_grid="planes") -> align_planes)
against keymorph_tpu's on the same weights and images.

On the CPU the port's kernel wrappers run their plain versions; keymorph_tpu
runs as it does on the CPU by default (flax extraction, the TPS-flow Pallas
kernel in interpret mode, the gather warp).
"""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.ops.resample import align_planes as jalign_planes
from keymorph_tpu_torch.models.keymorph import KeyMorphNet, align_pair
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.ops.resample import align_img, align_planes
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax

K = 8
CFG = dict(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1)
SPATIAL = (16, 16, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(rng, weight_keypoints):
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG),
                        num_keypoints=K, compute_dtype=jnp.bfloat16,
                        weight_keypoints=weight_keypoints)
    small = jnp.zeros((1, 1, 4, 4, 4), jnp.float32)  # parameters do not depend on it
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(1), small, small)
    flat = flax.traverse_util.flatten_dict(variables)
    for path, v in flat.items():  # GroupNorm affines away from (1, 0), never 0
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    variables = flax.traverse_util.unflatten_dict(flat)
    tnet = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K,
                       weight_keypoints=weight_keypoints)
    tnet.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return jnet, variables, tnet


def _pair(rng):
    """A smooth blob image and a shifted copy, (1, 1, *SPATIAL) each."""
    axes = [np.linspace(-1, 1, s) for s in SPATIAL]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    f = np.exp(-((zz - 0.1) ** 2 + (yy + 0.2) ** 2 + (xx - 0.3) ** 2) / 0.3)
    m = np.exp(-((zz + 0.05) ** 2 + (yy + 0.1) ** 2 + (xx - 0.2) ** 2) / 0.3)
    f = f + 0.05 * rng.random(f.shape)
    m = m + 0.05 * rng.random(m.shape)
    return f[None, None].astype(np.float32), m[None, None].astype(np.float32)


def test_keypoints_match_jax(rng):
    """Port keypoints (kernel executor, plain convs on CPU) vs keymorph_tpu
    keypoints (flax path) on the same weights and images: atol 2e-2, the
    JAX package's own fast-vs-flax bar (tests/test_fast_unet.py). Measured
    at this seed: 1.3e-3 (printed)."""
    jnet, variables, tnet = _nets(rng, "power")
    f, m = _pair(rng)
    jpf, jpm, jw = jax.jit(jnet.apply)(variables, jnp.asarray(f), jnp.asarray(m))
    with torch.no_grad():  # serving: nothing is kept for a backward
        tpf, tpm, tw = tnet(torch.tensor(f), torch.tensor(m))
    err = max(np.abs(tpf.numpy() - np.asarray(jpf)).max(),
              np.abs(tpm.numpy() - np.asarray(jpm)).max())
    print(f"keypoint max abs diff port vs jax: {err:.3g}")
    assert tpf.shape == (1, K, 3) and tpf.dtype == torch.float32
    assert np.all(np.abs(tpf.numpy()) <= 1.0)
    assert err <= 2e-2
    # "power" weights: normalized heatmap masses, same bf16 noise
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-2 / K)


def test_registration_from_identical_keypoints_matches_jax(rng):
    """From identical keypoints: TPS planes within 2e-4 (keymorph_tpu's
    TPS-flow kernel contracts in bf16 hi/lo parts) and the warped moving
    image within 5e-4 (that planes error times the image gradient)."""
    B, T = 1, K
    pf = rng.uniform(-0.7, 0.7, (B, T, 3)).astype(np.float32)
    pm = (pf + rng.normal(0, 0.04, (B, T, 3))).astype(np.float32)
    _, img = _pair(rng)
    lm = np.ones((B,), np.float32)
    jout = jalign_pair(jnp.asarray(pf), jnp.asarray(pm), "tps", SPATIAL,
                       lmbda=jnp.asarray(lm), compute_grid="planes")
    jwarped = np.asarray(jalign_planes(jout["planes"], jnp.asarray(img)))
    tout = align_pair(torch.tensor(pf), torch.tensor(pm), "tps", SPATIAL,
                      lmbda=torch.tensor(lm), compute_grid="planes")
    twarped = align_planes(tout["planes"], torch.tensor(img)).numpy()
    np.testing.assert_allclose(tout["planes"].numpy(), np.asarray(jout["planes"]), atol=2e-4)
    np.testing.assert_allclose(twarped, jwarped, atol=5e-4)
    # the grid form (plain tps_eval + xy grid) is the same registration
    tgrid = align_pair(torch.tensor(pf), torch.tensor(pm), "tps", SPATIAL,
                       lmbda=1.0, compute_grid=True)["grid"]
    np.testing.assert_allclose(align_img(tgrid, torch.tensor(img)).numpy(), twarped,
                               atol=1e-5)


def test_unported_alignment_raises():
    """align_pair refuses what it cannot mean: an unknown transform or grid
    form, one of the two real-world affines alone, TPS without lambda."""
    p = torch.zeros((1, 4, 3))
    eye = torch.eye(4)[None]
    for kw, match in ((dict(align_type="similarity"), "align_type"),
                      (dict(align_type="affine", compute_grid="grid"), "compute_grid"),
                      (dict(align_type="tps", compute_grid=None), "compute_grid"),
                      (dict(align_type="affine", aff_f=eye), "aff_m"),
                      (dict(align_type="tps", aff_m=eye), "aff_f"),
                      (dict(align_type="tps", lmbda=None), "lmbda")):
        kw.setdefault("lmbda", 1.0)
        with pytest.raises(ValueError, match=match):
            align_pair(p, p, grid_shape=(4, 4, 4), **kw)


def test_unported_training_entry_points_name_their_roadmap_item(rng):
    """No module of the port raises a "not ported" error any more: no
    NotImplementedError in its sources names a ROADMAP item or says "not
    ported" (the last, the CLIs' --visualize and --use_wandb, were ported
    with viz.py; tests/test_torch_viz.py runs them). The mesh of groupwise
    registration is ported: a non-mesh object is a TypeError."""
    from keymorph_tpu_torch import augment
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.training import train
    from keymorph_tpu_torch.training.config import Config, build_backbone

    net = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K)
    tps = Config(num_keypoints=K, transform_type="tps_1.0")
    state = train.TrainState.create(net, train.make_optimizer(tps, net))
    km = KeyMorph(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K, device="cpu")
    root = Path(__file__).resolve().parents[1] / "keymorph_tpu_torch"
    refusal = re.compile(r"NotImplementedError\((?:[^()]|\([^()]*\))*?(ROADMAP|not ported)",
                         re.S)
    sources = sorted(root.rglob("*.py"))
    assert len(sources) > 60
    for path in sources:
        assert not refusal.search(path.read_text()), path
    with pytest.raises(TypeError, match="Mesh"):
        km.groupwise_register(np.zeros((2, 1, 8, 8, 8), np.float32), mesh=object())
    assert state.step == 0  # nothing was trained on the way
    # the 2D pipeline is ported: these ran into NotImplementedError before
    assert KeyMorph(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K, dim=2,
                    device="cpu").dim == 2
    assert build_backbone(Config(backbone="unet", dim=2)).dim == 2
    assert build_backbone(Config(backbone="conv", dim=2)).dim == 2
    assert augment.fixed_affine_params(1, 2, (0, 0, 0, 0))[2].shape == (1, 1)
    assert augment.random_affine_augment(None, torch.zeros((1, 1, 8, 8))).shape == (1, 1, 8, 8)


def test_port_imports_neither_jax_nor_keymorph_tpu():
    """The port, every one of its modules (the data layer, the metrics with
    LC2, the CLIs, pretraining, the backbones, the brain extractor and its
    tool, the parallel layer, the panels, the tools, the benchmark, the
    entry points, the example and the weight-parity tool among them) and
    chip_smoke.py import torch only:
    neither jax nor the JAX package may appear in sys.modules (fresh
    interpreter), and no source line imports them."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import keymorph_tpu_torch
        assert "torch" not in sys.modules, "package __init__ must stay lazy"
        names = sorted(m.name for m in pkgutil.walk_packages(
            keymorph_tpu_torch.__path__, "keymorph_tpu_torch."))
        for name in names:
            importlib.import_module(name)
        for want in ("losses", "augment", "utils", "transforms.affine", "transforms.aligners",
                     "training.config",
                     "training.train", "training.checkpoint", "tools.train_step_bench",
                     "tools.import_flax_params", "ops.cuda.conv3d", "models.keymorph",
                     "metrics", "data", "data.nifti", "data.preprocess", "data.datasets",
                     "data.loader", "native.kmio", "cli.register", "cli.eval_pairwise",
                     "cli.eval_groupwise", "cli.script_utils", "cli.hyperparameters",
                     "cli.run", "training.pretrain", "ops.resize", "models.convnet",
                     "models.layers", "models.unet", "brain_extract",
                     "tools.extract_brains", "parallel", "parallel.mesh", "parallel.sharded",
                     "parallel.halo", "viz", "tools.make_synthetic_dataset",
                     "tools.center_volumes", "tools.prepare_ixi", "tools.collect_run_artifacts",
                     "tools.tps_approx_bench", "tools.warp_channels_bench", "tools.flops",
                     "tools.trace_summary", "tools.extract_trace", "tools.train_step_trace",
                     "tools.conv_microbench", "bench", "entry", "examples",
                     "examples.register_pair", "parallel.launch", "tools.weight_parity"):
            assert "keymorph_tpu_torch." + want in names, want
        import chip_smoke
        keymorph_tpu_torch.ops.cuda.counters()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "keymorph_tpu"))
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=root)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|keymorph_tpu)(?:[.\s]|$)",
                         re.M)
    sources = sorted((root / "keymorph_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(sources) > 20
    for path in sources:
        assert not pattern.search(path.read_text()), path
