"""Brain extraction in the port against keymorph_tpu on the CPU: the
``SimpleUnet`` logits on shared weights, ``clean_mask``, ``extract_brain``
and the ``extract_brains`` tool over a small NIfTI directory, in both
packages from one ``.npz`` of flax parameters.

The logits are fp32 in both packages, held within LOGIT_REL of their
largest value or twice keymorph_tpu's distance from the port's float64
module, whichever is larger (the instance norms over the 2^3 bottleneck of a
32^3 volume take E[x^2] - mean^2 of few voxels). ``clean_mask`` is a copy: bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu import brain_extract as jbrain
from keymorph_tpu.data.nifti import load_nifti as jload_nifti
from keymorph_tpu.data.nifti import save_nifti as jsave_nifti
from keymorph_tpu.models import unet as junet
from keymorph_tpu.tools import extract_brains as jtool
from keymorph_tpu_torch import brain_extract
from keymorph_tpu_torch.models.unet import SimpleUnet
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.tools import extract_brains as ttool
from keymorph_tpu_torch.tools.import_flax_params import (
    simple_unet_state_dict_from_flax,
    unflatten_npz,
)

LOGIT_REL = 1e-5
PROB_ABS = 1e-4        # a probability this near 0.5 may fall either side in fp32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    """keymorph_tpu SimpleUnet variables, flax-initialized, with the norm
    affines and conv biases moved off their init."""
    rng = np.random.default_rng(3)
    v = jax.jit(junet.SimpleUnet(out_channels=1).init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 16, 16, 16, 1)))
    flat = flax.traverse_util.flatten_dict(_np(v))
    for path, x in flat.items():
        if path[-1] == "scale":
            flat[path] = (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
        elif path[-1] == "bias":
            flat[path] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _volume(rng, shape):
    """A bright blob (the brain) in a dim, noisy field."""
    axes = [np.linspace(-1, 1, s) for s in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    v = np.exp(-(zz ** 2 + (yy - 0.1) ** 2 + xx ** 2) / 0.3)
    return (v + 0.1 * rng.random(shape)).astype(np.float32)


def test_simple_unet_logits_match_jax(variables, rng):
    """Logits of two 32^3 volumes on keymorph_tpu's weights: within
    LOGIT_REL of the largest, or twice keymorph_tpu's distance from the
    port's float64 module; the weights carried by
    ``simple_unet_state_dict_from_flax`` load strictly. No kernel counter
    moves."""
    x = np.stack([_volume(rng, (32, 32, 32)) for _ in range(2)])[:, None]
    want = np.asarray(jax.jit(junet.SimpleUnet(out_channels=1).apply)(
        variables, jnp.asarray(np.moveaxis(x, 1, -1))))[..., 0]
    sd = simple_unet_state_dict_from_flax(_np(variables))
    kernels.reset_counters()
    outs = {}
    for dtype in (torch.float32, torch.float64):
        m = SimpleUnet(dtype=dtype)
        m.load_state_dict(sd)  # strict
        with torch.no_grad():
            outs[dtype] = m(torch.tensor(x))[:, 0]
    assert all(c["launches"] == c["plain_calls"] == 0 for c in kernels.counters().values())
    out, out64 = outs[torch.float32], outs[torch.float64]
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    ref = float(out64.abs().max())
    err = float((out.double() - torch.tensor(want, dtype=torch.float64)).abs().max()) / ref
    err_jax = float(np.abs(want - out64.numpy()).max()) / ref
    print(f"SimpleUnet logits rel {err:.3g} (keymorph_tpu from float64 {err_jax:.3g})")
    assert err <= max(LOGIT_REL, 2.0 * err_jax)


def test_clean_mask_is_keymorph_tpus(rng):
    """``clean_mask`` on random islands at thresholds 0.05, 0.2 and 0.6:
    bit for bit keymorph_tpu's; the empty mask gives zeros."""
    for seed in range(3):
        mask = np.random.default_rng(seed).random((18, 20, 16)) > 0.7
        for threshold in (0.05, 0.2, 0.6):
            got = brain_extract.clean_mask(mask, threshold)
            want = jbrain.clean_mask(mask, threshold)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    assert brain_extract.clean_mask(np.zeros((4, 4, 4))).sum() == 0


def test_extract_brain_matches_jax(variables, rng):
    """``extract_brain`` on a batch of two 16^3 volumes (the CPU asked for)
    against keymorph_tpu's: the thresholded probabilities agree except at
    voxels whose probability lies within PROB_ABS of the 0.5 threshold
    (counted and printed), and the port's masks are ``clean_mask`` of its
    own (uint8, (B, 1, D, H, W)); where no voxel is that near, the masks
    are keymorph_tpu's bit for bit."""
    x = np.stack([_volume(rng, (16, 16, 16)) for _ in range(2)])[:, None]
    want = jbrain.extract_brain(variables, x)
    p_jax = np.asarray(jax.nn.sigmoid(jax.jit(junet.SimpleUnet(out_channels=1).apply)(
        variables, jnp.asarray(np.moveaxis(x, 1, -1)))))[..., 0]
    model = SimpleUnet()
    model.load_state_dict(simple_unet_state_dict_from_flax(_np(variables)))
    got = brain_extract.extract_brain(model, x, device="cpu")
    p = torch.sigmoid(brain_extract.brain_logits(model, x, device="cpu"))[:, 0].numpy()
    near = np.abs(p_jax - 0.5) <= PROB_ABS
    print(f"extract_brain: {int(got.sum())} mask voxels; {int(near.sum())} within {PROB_ABS} "
          f"of the threshold; probabilities {np.abs(p - p_jax).max():.3g} apart")
    assert np.all(((p > 0.5) == (p_jax > 0.5)) | near)
    assert got.shape == (2, 1, 16, 16, 16) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.stack([brain_extract.clean_mask(m) for m in p > 0.5])[:, None])
    if not near.any():
        np.testing.assert_array_equal(got, want)


def test_extract_brains_tool_writes_jaxs_files(variables, tmp_path):
    """Both packages' ``extract_brains`` over one directory of two NIfTI
    scans (20 x 22 x 24, worked at ``--size 16``) from one ``.npz`` of flax
    parameters: the same file names, the same masks (bit for bit) and the
    same affines; a ``.npz`` round trip (``unflatten_npz``) gives the tree
    back."""
    rng = np.random.default_rng(1)
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(2):
        vol = rng.uniform(0, 0.1, size=(20, 22, 24)).astype(np.float32)
        c = (6 + 4 * i, 10, 12)
        vol[c[0] - 4: c[0] + 4, c[1] - 5: c[1] + 5, c[2] - 5: c[2] + 5] = 1.0
        aff = np.diag([1.1, 0.9, 1.2, 1.0])
        aff[:3, 3] = [-10, 5, 3]
        jsave_nifti(str(raw / f"sub{i}.nii.gz"), vol, aff)
    flat = {"/".join(k): v for k, v in flax.traverse_util.flatten_dict(_np(variables)).items()}
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, **flat)
    with np.load(ckpt) as f:
        back = flax.traverse_util.flatten_dict(unflatten_npz(f))
    assert {"/".join(k) for k in back} == set(flat)
    common = ["--img_dir", str(raw), "--checkpoint", str(ckpt), "--size", "16"]
    jtool.main(common + ["--out_dir", str(tmp_path / "jax")])
    ttool.main(common + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["sub0_mask.nii.gz",
                                                              "sub1_mask.nii.gz"]
    for name in names:
        a, b = (jload_nifti(str(tmp_path / d / name)) for d in ("jax", "port"))
        assert a.shape == (20, 22, 24)
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.affine, a.affine)
    assert sum(int(jload_nifti(str(tmp_path / "port" / n)).data.sum()) for n in names) > 0
