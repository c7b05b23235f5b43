"""The port's benchmark (keymorph_tpu_torch/bench.py) against the repo's
bench.py on the CPU: the same register and stage builders on the same
carried weights and volumes (keymorph_tpu's run as tests/test_bench_paths.py
runs them), the stages composing to the register, the planes path against
the grid path, and the JSON record."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu.models import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.models.keymorph import KeyMorphNet as JKeyMorphNet
from keymorph_tpu_torch import bench
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.unet import TruncatedUNet3D
from keymorph_tpu_torch.tools.import_flax_params import state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K = 16
CFG = dict(out_channels=K, f_maps=8, num_levels=3, num_truncated_layers=1)  # test_bench_paths
SHAPE = (1, 1, 16, 16, 32)
KEYPOINT_ABS = 2e-2   # tests/test_torch_pipeline.py::test_keypoints_match_jax (bf16 nets)
PLANES_ABS = 2e-4     # from identical keypoints, against keymorph_tpu's TPS-flow kernel
WARP_ABS = 1e-5       # from identical planes, against keymorph_tpu's warp
WARPED_ABS = 5e-4     # from identical keypoints: PLANES_ABS times the image's gradient
GRID_ABS = 1e-5       # the planes path against the grid path, in the port


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """keymorph_tpu's bench net and inputs (tests/test_bench_paths.py) and
    the port's net on the same weights."""
    jnet = JKeyMorphNet(backbone=JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG), num_keypoints=K,
                        compute_dtype=jnp.bfloat16)
    img_f = jax.random.uniform(jax.random.PRNGKey(0), SHAPE, jnp.float32)
    img_m = jax.random.uniform(jax.random.PRNGKey(1), SHAPE, jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(2), img_f, img_m)
    tnet = KeyMorphNet(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), K).eval()
    tnet.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, tnet, np.asarray(img_f), np.asarray(img_m)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_register_and_stages_match_jax(nets):
    """Keypoints within KEYPOINT_ABS of keymorph_tpu's bench stages; from
    the port's keypoints keymorph_tpu's solve_flow gives the port's planes
    within PLANES_ABS, and from the port's planes its warp the port's warped
    volume within WARP_ABS; the port's register is its stages' composition,
    and keymorph_tpu's register from its own keypoints is the port's within
    the keypoints' difference carried through (WARPED_ABS per PLANES_ABS)."""
    import bench as jbench

    jnet, params, tnet, f, m = nets
    jextract, jsolve, jwarp = jbench.build_stages(jnet, 4, planes=True)
    extract, solve_flow, warp = bench.build_stages(tnet)
    tf, tm = torch.tensor(f), torch.tensor(m)
    pf, pm = extract(tf), extract(tm)
    d_kp = max(_dist(pf, jextract(params, jnp.asarray(f))),
               _dist(pm, jextract(params, jnp.asarray(m))))
    planes = solve_flow(pf, pm, SHAPE[2:])
    jplanes = jsolve(jnp.asarray(pf.numpy()), jnp.asarray(pm.numpy()), SHAPE[2:])
    d_planes = _dist(planes, jplanes)
    warped = warp(planes, tm)
    d_warp = _dist(warped, jwarp(jnp.asarray(planes.numpy()), jnp.asarray(m)))
    d_warped = _dist(warped, jwarp(jplanes, jnp.asarray(m)))
    jout = jbench.build_register(jnet, num_chunks=4, planes=True)(params, jnp.asarray(f),
                                                                   jnp.asarray(m))
    out = bench.build_register(tnet)(tf, tm)
    print(f"keypoints {d_kp:.3g}, planes from the port's keypoints {d_planes:.3g}, warp from "
          f"its planes {d_warp:.3g}, warped from its keypoints {d_warped:.3g}, register "
          f"end to end {_dist(out, jout):.3g}")
    assert pf.shape == (1, K, 3) and out.shape == SHAPE and out.dtype == torch.float32
    assert d_kp <= KEYPOINT_ABS
    assert d_planes <= PLANES_ABS and d_warp <= WARP_ABS and d_warped <= WARPED_ABS
    assert torch.equal(out, warped)
    assert np.isfinite(np.asarray(jout)).all()


def test_stages_compose_to_register_bit_for_bit(nets):
    """extract + solve_flow + warp == register, bit for bit (keymorph_tpu's
    test_bench_stage_builders_cover_register holds its jitted programs to
    2e-5; the port's stages are the register's very calls)."""
    _, _, tnet, f, m = nets
    tf, tm = torch.tensor(f), torch.tensor(m) * 0.5 + 0.25
    for planes in (True, False):
        extract, solve_flow, warp = bench.build_stages(tnet, planes=planes)
        staged = warp(solve_flow(extract(tf), extract(tm), SHAPE[2:]), tm)
        assert torch.equal(staged, bench.build_register(tnet, planes=planes)(tf, tm)), planes


def test_register_planes_matches_grid(nets):
    """The planes path and the grid path (``tps_flow`` at every voxel, the
    ``xy`` grid, ``align_img``) register alike within GRID_ABS (keymorph_tpu's
    test_bench_register_planes_matches_grid: 5e-4 there, its bf16 TPS
    contraction)."""
    _, _, tnet, f, m = nets
    tf, tm = torch.tensor(f), torch.tensor(m)
    d = _dist(bench.build_register(tnet, planes=True)(tf, tm),
              bench.build_register(tnet, planes=False)(tf, tm))
    print(f"planes vs grid {d:.3g}")
    assert d <= GRID_ABS


def test_run_record_keys_value_and_baseline():
    """``run`` on the CPU: bench.py's keys (``metric`` in its string form,
    ``value`` = 1000 / ``register_ms``, ``vs_baseline`` from
    BENCH_BASELINE.json as bench.py reads it, ``stages``, ``per_batch`` rows
    at bs 1, 2, 4 and 8), the card (None here) and the timer; the device
    rates are None off the card (not measured); the first warped volume is
    finite and in the image's range."""
    rec, first = bench.run(size=16, num_keypoints=8, iters=2, stages=True, throughput=True,
                           device="cpu", return_first=True)
    json.dumps(rec)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "baseline_hardware", "stages",
                        "per_batch", "device", "timer"}
    assert rec["metric"] == "pairwise tps registrations/sec/chip at 16^3 (8 kp, truncatedunet, bf16)"
    assert rec["unit"] == "registrations/sec" and rec["device"] is None
    assert rec["timer"] == "host_clock"
    st = rec["stages"]
    assert rec["value"] == 1e3 / st["register_ms"]
    base = json.loads((ROOT / "BENCH_BASELINE.json").read_text())
    assert rec["vs_baseline"] == rec["value"] / base["registrations_per_sec"]
    assert rec["baseline_hardware"] == base["hardware"]
    assert bench.baseline(256) == (base["per_size"]["256"], base["hardware"])
    for k in ("extract_ms", "solve_flow_ms", "warp_ms", "extract_gflop", "solve_flow_gflop",
              "warp_gb_lower_bound"):
        assert np.isfinite(st[k]) and st[k] > 0, k
    for k in ("extract_mfu", "solve_flow_mfu", "warp_hbm_frac", "busy_ms", "idle_share"):
        assert st[k] is None, k
    assert list(rec["per_batch"]) == ["1", "2", "4", "8"]
    for bs, row in rec["per_batch"].items():
        assert row["regs_per_sec"] == pytest.approx(1e3 * int(bs) / row["latency_ms"])
        assert row["peak_gib"] is None
    assert first.shape == (1, 1, 16, 16, 16) and torch.isfinite(first).all()
    assert 0.0 <= float(first.min()) and float(first.max()) <= 1.0
    off = bench.run(size=16, num_keypoints=8, iters=1, stages=False, device="cpu")
    assert off["stages"] is None and off["per_batch"] is None


def test_main_runs_on_the_card_only(monkeypatch):
    """``python -m keymorph_tpu_torch.bench`` runs on the card: without one
    it raises before any work (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_SIZE", "16")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
