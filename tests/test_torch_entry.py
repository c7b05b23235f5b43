"""The port's entry points (keymorph_tpu_torch/entry.py) against the repo's
__graft_entry__.py on the CPU: ``entry()``'s forward on keymorph_tpu's
``_build()`` parameters carried across and on seeded volumes, and
``dryrun_multichip`` on 2 and 4 gloo ranks."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.ops.resample import align_img as jalign_img
from keymorph_tpu_torch import entry as tentry
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

POINTS_ABS = 1e-5    # fp32 nets on the same weights and volumes
FLOOR = 1e-5         # over twice keymorph_tpu's own move under the points' difference


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _blobs(rng, shape):
    """A smooth blob volume with a little noise (the zeros/ones example
    arguments are degenerate: every keypoint at the centre)."""
    axes = [np.linspace(-1, 1, s) for s in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    c = rng.uniform(-0.3, 0.3, 3)
    v = np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 0.3)
    return (v + 0.05 * rng.random(v.shape))[None, None].astype(np.float32)


def test_entry_matches_graft_entry(rng, monkeypatch):
    """Keypoints within POINTS_ABS of keymorph_tpu's; the affine matrix and
    the warped image within twice what keymorph_tpu's own align_pair +
    align_img make of the keypoints' difference (its output from the port's
    keypoints against its output from its own) plus FLOOR, the rule of
    tests/test_torch_keymorph.py::test_keymorph_forward_matches_jax. The
    example arguments keep keymorph_tpu's contract: the net's parameters,
    zeros, ones (on which every keypoint sits at the centre, in both
    packages). keymorph_tpu's ``_build`` runs with its ``init`` jitted: the
    same parameters, in seconds rather than half a minute."""
    import __graft_entry__

    init = JKeyMorphNet.init
    monkeypatch.setattr(JKeyMorphNet, "init", lambda self, key, *a: jax.jit(
        lambda k, *b: init(self, k, *b))(key, *a))
    jfn, (jparams, jimg, jones) = __graft_entry__.entry()
    fn, (params, img, ones) = tentry.entry(device="cpu")
    assert img.shape == jimg.shape == (1, 1, 32, 32, 32) and not img.any()
    assert bool((ones == 1).all()) and set(params) == set(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    carried = {k: torch.as_tensor(v) for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    f, m = _blobs(rng, (32, 32, 32)), _blobs(rng, (32, 32, 32))
    want = [np.asarray(x) for x in jax.jit(jfn)(jparams, jnp.asarray(f), jnp.asarray(m))]
    with torch.no_grad():
        got = [x.numpy() for x in fn(carried, torch.tensor(f), torch.tensor(m))]
    names = ("warped", "matrix", "points_f", "points_m")
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    d_pts = max(_dist(got[2], want[2]), _dist(got[3], want[3]))
    stage = jalign_pair(jnp.asarray(got[2]), jnp.asarray(got[3]), "affine", (32, 32, 32),
                        compute_grid=True)
    moved = {"warped": _dist(jalign_img(stage["grid"], jnp.asarray(m)), want[0]),
             "matrix": _dist(stage["matrix"], want[1])}
    d = {"warped": _dist(got[0], want[0]), "matrix": _dist(got[1], want[1])}
    print(f"points {d_pts:.3g}; warped {d['warped']:.3g}, matrix {d['matrix']:.3g} "
          f"(keymorph_tpu's own move {moved})")
    assert d_pts <= POINTS_ABS
    for k in d:
        assert d[k] <= 2 * moved[k] + FLOOR, k
    # the example arguments run, as keymorph_tpu's compile test runs them
    with torch.no_grad():
        warped = fn(params, img, ones)[0]
    assert warped.shape == img.shape


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(n, capsys):
    """``dryrun_multichip(n, device="cpu")``: n gloo processes run every
    path and print keymorph_tpu's line with finite losses; every rank sees
    the same whole results; on the CPU no kernel launches (the wrappers run
    their plain versions)."""
    results = tentry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    space = 2
    assert out.startswith(f"dryrun_multichip OK: mesh=(data={n // space}, space={space}), loss=")
    assert f"groupwise points ({n}, 16, 3), fanout warp ({n}, 1, 16, 16, 16), " \
           f"spatial register (1, 1, 16, 16, 16) over space={n}, gspmd-gated TPS grid " \
           f"({n}, 16, 16, 8, 3)" in out
    assert len(results) == n
    for r in results:
        assert np.isfinite(r["loss"]) and r["loss"] == results[0]["loss"]
        assert not any(r["launches"].values())
        assert r["plain_calls"]["warp_planes"] > 0 and r["plain_calls"]["tps_flow"] > 0
    if n >= 4:
        assert all(np.isfinite(r["dcn_loss"]) for r in results)
        assert out.endswith(f"dcn-mesh loss={results[0]['dcn_loss']}")
    else:
        assert results[0]["dcn_loss"] is None and out.endswith("dcn-mesh loss=None")


def test_dryrun_refuses_without_a_card(monkeypatch):
    """The ranks run on the cards unless the CPU is asked for: with no card
    ``dryrun_multichip`` raises before starting any process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.dryrun_multichip(2)
