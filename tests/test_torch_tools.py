"""The port's tools (keymorph_tpu_torch/tools/) against keymorph_tpu's on
the CPU: the synthetic phantoms and dataset, the IXI resample, volume
centring, artifact collection, the FLOP counts, the trace reading, and the
device tools (approximate TPS, the multi-channel warp) at 16^3 with
``--device cpu``. Without ``--device cpu`` every tool that touches a
tensor runs on the card and raises without one.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.models.keymorph import align_pair as jalign_pair
from keymorph_tpu.tools import center_volumes as jcenter
from keymorph_tpu.tools import collect_run_artifacts as jcollect
from keymorph_tpu.tools import flops as jflops
from keymorph_tpu.tools import make_synthetic_dataset as jmake
from keymorph_tpu.tools import prepare_ixi as jprep
from keymorph_tpu.tools.weight_parity import make_subjects as jmake_subjects
from keymorph_tpu_torch.data.nifti import load_nifti, save_nifti
from keymorph_tpu.tools.conv_microbench import flagship_stages as jflagship_stages
from keymorph_tpu_torch.tools import (center_volumes, collect_run_artifacts, conv_microbench,
                                      extract_trace, flops, make_synthetic_dataset, prepare_ixi,
                                      tps_approx_bench, train_step_trace, trace_summary,
                                      warp_channels_bench)

CENTER_ABS = 1e-5   # the warp against keymorph_tpu's (tests/test_torch_warp.py: 1e-5)
PLANES_ABS = 2e-5   # approximate TPS planes from identical keypoints


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def raw_dir(tmp_path, rng):
    """tests/test_tools.py's raw volumes: two 20 x 22 x 24 noise volumes
    with a bright cube each, the cubes apart."""
    d = tmp_path / "raw"
    d.mkdir()
    for i in range(2):
        vol = rng.uniform(0, 0.1, size=(20, 22, 24)).astype(np.float32)
        c = (5 + 4 * i, 8, 12)
        vol[c[0] - 2: c[0] + 2, c[1] - 2: c[1] + 2, c[2] - 2: c[2] + 2] = 1.0
        save_nifti(str(d / f"sub{i}.nii.gz"), vol)
    return d


def _volumes(root):
    """{relative path: (data, affine)} of every NIfTI under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".nii.gz"):
                img = load_nifti(os.path.join(dirpath, f))
                out[os.path.relpath(os.path.join(dirpath, f), root)] = (img.data, img.affine)
    return out


def test_make_subjects_is_keymorph_tpus_bit_for_bit():
    a = make_synthetic_dataset.make_subjects(n_subjects=3, size=12, n_blobs=5, seed=4)
    b = jmake_subjects(n_subjects=3, size=12, n_blobs=5, seed=4)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_make_synthetic_dataset_matches_jax(tmp_path, capsys):
    """Every modality remap: the same volumes, dtypes and affines, and the
    same CSV rows with the paths aside."""
    argv = ["--n", "3", "--size", "12", "--n_test", "1", "--modalities", "T1", "T2", "PD", "X"]
    paths = {}
    for name, mod in (("port", make_synthetic_dataset), ("jax", jmake)):
        paths[name] = mod.main(["--out", str(tmp_path / name)] + argv)
    got, want = _volumes(tmp_path / "port"), _volumes(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 24
    for k in want:
        assert got[k][0].dtype == want[k][0].dtype, k
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)
    rows = {n: open(p).read().replace(str(tmp_path / n), "<out>") for n, p in paths.items()}
    assert rows["port"] == rows["jax"]
    assert capsys.readouterr().out.count("wrote 12 rows") == 2


def test_prepare_ixi_resample_matches_jax(raw_dir, tmp_path, capsys):
    """``--raw_dir``: the same resampled volumes and affines as
    keymorph_tpu's (tests/test_tools.py's case: spacing 20/16 = 1.25 along
    the first axis); without it the port refuses, naming ``--raw_dir``."""
    argv = ["--raw_dir", str(raw_dir), "--modalities", "T1", "T2", "--size", "16"]
    prepare_ixi.main(["--out_dir", str(tmp_path / "port")] + argv)
    jprep.main(["--out_dir", str(tmp_path / "jax")] + argv)
    got, want = _volumes(tmp_path / "port"), _volumes(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 4
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=0, atol=1e-12, err_msg=k)
    out = load_nifti(str(tmp_path / "port" / "T1" / "sub0.nii.gz"))
    assert out.shape == (16, 16, 16)
    assert np.linalg.norm(out.affine[:3, 0]) == pytest.approx(1.25, rel=1e-3)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        prepare_ixi.main(["--out_dir", str(tmp_path / "none")])
    assert e.value.code != 0 and "--raw_dir" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


def test_center_volumes_matches_jax(raw_dir, tmp_path):
    """The port's centring (``--device cpu``: the warp's plain version)
    within CENTER_ABS of keymorph_tpu's, and sub0's centroid moved closer
    to the reference's (tests/test_tools.py::test_center_volumes)."""
    argv = ["--img_dir", str(raw_dir), "--reference", str(raw_dir / "sub1.nii.gz")]
    center_volumes.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jcenter.main(argv + ["--out_dir", str(tmp_path / "jax")])
    got, want = _volumes(tmp_path / "port"), _volumes(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["sub0.nii.gz", "sub1.nii.gz"]
    for k in want:
        d = float(np.abs(got[k][0] - want[k][0]).max())
        print(f"{k}: port vs keymorph_tpu {d:.3g}")
        assert d <= CENTER_ABS
        np.testing.assert_array_equal(got[k][1], want[k][1])
    c = center_volumes.intensity_centroid_voxel
    ref = c(load_nifti(str(raw_dir / "sub1.nii.gz")).data)
    before = np.linalg.norm(c(load_nifti(str(raw_dir / "sub0.nii.gz")).data) - ref)
    after = np.linalg.norm(c(got["sub0.nii.gz"][0]) - ref)
    assert after < before
    np.testing.assert_array_equal(c(got["sub0.nii.gz"][0]), jcenter.intensity_centroid_voxel(
        got["sub0.nii.gz"][0]))


def test_collect_copies_keymorph_tpus_file_list(tmp_path):
    src = tmp_path / "run"
    for rel in ("args.json", "train_log.jsonl", "eval/summary_unimodal.json",
                "eval/eval_unimodal/0_T1_T1/metrics-rot0-affine.json", "img/img_epoch1.png",
                "checkpoints/epoch1_model/meta.json", "eval/eval_unimodal/0_T1_T1/img_f.npy",
                "notes.txt"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    assert collect_run_artifacts.KEEP_NAMES == jcollect.KEEP_NAMES
    assert collect_run_artifacts.KEEP_SUFFIXES == jcollect.KEEP_SUFFIXES
    assert collect_run_artifacts.SKIP_DIRS == jcollect.SKIP_DIRS
    got = collect_run_artifacts.collect(str(src), str(tmp_path / "port"))
    want = jcollect.collect(str(src), str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and len(got) == 5
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("spatial,out,f_maps,levels,trunc", [
    ((256, 256, 256), 128, 32, 4, 1),   # the flagship
    ((128, 128, 128), 512, 32, 4, 1),   # tps_approx_bench --ranked's net
    ((96, 128, 160), 64, 16, 3, 0),     # a full U-Net
])
def test_flop_counts_match_jax(spatial, out, f_maps, levels, trunc):
    assert flops.unet_extract_flops(spatial, out, f_maps, levels, trunc) == \
        jflops.unet_extract_flops(spatial, out, f_maps, levels, trunc)
    n = int(np.prod(spatial))
    for k in (64, 128, 512):
        assert flops.tps_flow_flops(n, k) == jflops.tps_flow_flops(n, k)
        assert flops.tps_solve_flops(k) == jflops.tps_solve_flops(k)
    for c in (1, 6, 14):
        assert flops.warp_flops(n, c) == jflops.warp_flops(n, c)
        assert flops.warp_bytes(n, c, in_bytes=4) == jflops.warp_bytes(n, c, in_bytes=4)
    assert flops.mfu(1e12, 1e-2) == jflops.mfu(1e12, 1e-2, peak=989e12)
    assert flops.H100_BF16_PEAK_FLOPS == 989e12 and flops.H100_HBM_BYTES_PER_S == 3.35e12
    assert not any(name.startswith("V5E") for name in vars(flops))


def test_unet_extract_flops_counts_the_ports_truncated_unet():
    """``unet_extract_flops`` equals a count from the port's
    TruncatedUNet3D itself: 2 x each conv's weights x the voxels of its
    output (hooked), the 1x1 head, and 2 x K x voxels for the centre of
    mass."""
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.models.unet import SingleConv, TruncatedUNet3D

    K, spatial = 16, (16, 16, 32)
    net = TruncatedUNet3D(out_channels=K, f_maps=8, num_levels=4, num_truncated_layers=1,
                          dtype=torch.float32)
    counted = []

    def hook(module, _, output):
        counted.append(2.0 * module.conv.weight.numel() * np.prod(output.shape[2:]))

    for m in net.modules():
        if isinstance(m, SingleConv):
            m.register_forward_hook(hook)
    with torch.no_grad():
        heat = net(torch.zeros((1, 1, *spatial)))
    vox = np.prod(heat.shape[2:])
    center_of_mass(heat.movedim(1, -1))
    total = sum(counted) + 2.0 * net.final_conv.weight.numel() * vox + 2.0 * K * vox
    assert len(counted) == 2 * (4 + 2)  # 4 encoders, 2 decoders, two convs each
    assert flops.unet_extract_flops(spatial, K, 8, 4, 1) == total


def _torch_trace(path):
    """A minimal Chrome trace as torch.profiler exports it: host ops,
    runtime calls, two kernels that overlap, a copy, a memset, a flow
    event."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv3d", "ts": 0, "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "conv3x3_mma_kernel<64>", "ts": 100, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "conv3x3_mma_kernel<64>", "ts": 350, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
         "ts": 500, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 600, "dur": 10},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 10, "id": 1},
    ]
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def test_summarize_trace_reads_device_events(tmp_path):
    d = tmp_path / "traces" / "worker0"
    d.mkdir(parents=True)
    path = d / "host.pt.trace.json.gz"
    _torch_trace(path)
    assert trace_summary.find_trace_file(str(tmp_path)) == str(path)
    assert trace_summary.find_trace_file(str(path)) == str(path)
    assert trace_summary.find_trace_file(str(tmp_path / "traces" / "none")) is None
    rows = trace_summary.summarize_trace(str(path))
    assert rows[0] == ("conv3x3_mma_kernel<64>", 0.4, 2)
    assert [r[0] for r in rows] == ["conv3x3_mma_kernel<64>", "Memcpy DtoH (Device -> Pageable)",
                                    "Memset (Device)"]
    busy, _ = trace_summary.device_reading(trace_summary._trace_intervals(str(path)))
    assert busy == 350 + 50 + 10  # the overlapping kernels count once


def test_profile_fn_on_the_cpu(tmp_path):
    """On the CPU: the result, the host wall time, and no device reading
    (busy and idle share None: not measured); the exported trace holds no
    device event either."""
    x = torch.arange(6.0)
    out, summary = trace_summary.profile_fn(lambda a, b: a * b, x, 2.0,
                                            trace_dir=str(tmp_path / "t"))
    assert torch.equal(out, x * 2.0)
    assert summary["wall_ms"] > 0.0
    assert summary["busy_ms"] is None and summary["idle_share"] is None
    assert summary["ops"] == []
    trace = trace_summary.find_trace_file(str(tmp_path / "t"))
    assert trace is not None and trace_summary.summarize_trace(trace) == []


def test_tps_approx_bench_on_the_cpu(capsys):
    """16^3, K = 16, S = 4 and 8: one JSON line with the exact and
    approximate times on the host clock (no card: ``card`` null), each
    flow's distance from the exact one and the speedups; the approximate
    planes within PLANES_ABS of keymorph_tpu's ``align_pair(tps_centers=S)``
    from the same keypoints."""
    rec = tps_approx_bench.main(["16", "16", "4,8", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["card"] is None and rec["timer"] == "host_clock" and rec["device"] == "cpu"
    assert set(rec["ms"]) == {"exact", "S=4", "S=8"}
    assert set(rec["max_abs_d"]) == set(rec["speedup"]) == {"S=4", "S=8"}
    assert all(np.isfinite(v) and v > 0 for v in rec["max_abs_d"].values())
    rng = np.random.default_rng(2)
    pf = rng.uniform(-0.7, 0.7, (1, 16, 3)).astype(np.float32)
    pm = (pf + 0.05 * rng.normal(size=pf.shape)).astype(np.float32)
    for S in (4, 8):
        got = tps_approx_bench.solve_flow(torch.tensor(pf), torch.tensor(pm), (16,) * 3, S)
        want = jalign_pair(jnp.asarray(pf), jnp.asarray(pm), "tps", (16,) * 3,
                           lmbda=jnp.ones((1,)), compute_grid="planes", tps_centers=S)["planes"]
        d = float(np.abs(got.numpy() - np.asarray(want)).max())
        print(f"S={S}: planes port vs keymorph_tpu {d:.3g}")
        assert d <= PLANES_ABS


def test_tps_approx_bench_ranked_on_the_cpu(capsys):
    rec = tps_approx_bench.main(["--ranked", "16", "8", "4", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["mode"] == "ranked" and rec["size"] == 16 and rec["K"] == 8
    assert [(r["S"], r["order"]) for r in rec["rows"]] == [(4, "first"), (4, "ranked")]
    for r in rec["rows"]:
        assert np.isfinite(r["max_abs_d"]) and r["mean_abs_d"] <= r["max_abs_d"]
        assert 0.0 <= r["dice_vs_exact"] <= 1.0


def test_warp_channels_bench_on_the_cpu(capsys):
    """16^3, C = 1 and 3: the warp equals its plain version, F.grid_sample
    lies within 1e-6 of it, and the byte bound is the flops formula's."""
    rec = warp_channels_bench.main(["16", "1,3", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["card"] is None and rec["timer"] == "host_clock"
    assert [r["C"] for r in rec["rows"]] == [1, 3]
    for r in rec["rows"]:
        assert r["max_abs_err_vs_plain"] == 0.0 and r["grid_sample_max_abs_d"] <= 1e-6
        assert r["ms"] > 0 and r["grid_sample_ms"] > 0
        assert r["bound_ms"] == pytest.approx(16 ** 3 * (8 * r["C"] + 12) / 3.35e12 * 1e3)


@pytest.mark.parametrize("size", [128, 256])
def test_conv_microbench_stages_are_keymorph_tpus(size):
    """The same stages as keymorph_tpu's microbenchmark: every conv of the
    flagship TruncatedUNet3D, with its widths and size."""
    assert conv_microbench.flagship_stages(size) == jflagship_stages(size)


def test_conv_microbench_on_the_cpu(capsys):
    """At 32^3 with ``--device cpu`` (the plain versions, host clock): one
    JSON line per stage and one of totals; each stage names its form and
    instantiation and carries its bound by the conv's bytes and operations."""
    rows, total = conv_microbench.main(["--device", "cpu", "--size", "32", "--reps", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == rows + [total] and len(rows) == 13
    assert [r["stage"] for r in rows] == [s[0] for s in jflagship_stages(32)]
    for r, (name, cin, cout, spatial) in zip(rows, jflagship_stages(32)):
        assert (r["cin"], r["cout"], tuple(r["spatial"])) == (cin, cout, spatial)
        assert r["card"] is None and r["timer"] == "host_clock"
        assert r["kernel_ms"] > 0 and r["library_ms"] > 0
        k = 1 if name == "head" else 3
        n = spatial[0] * spatial[1] * spatial[2]
        assert r["bound_ms"] == pytest.approx(max(
            2 * (n * cin + k ** 3 * cin * cout + n * cout) / 3.35e12,
            2 * n * k ** 3 * cin * cout / 989e12) * 1e3)
    assert rows[0]["kernel"] == "fma" and rows[1]["kernel"] == "mma<32>"
    assert rows[8]["form"] == "upconv" and rows[8]["kernel"] == "mma<64>"
    assert rows[-1]["kernel"] == "matmul (PyTorch)"


def test_trace_tools_on_the_cpu(capsys):
    """extract_trace and train_step_trace run at 16^3 with ``--device
    cpu`` and say that no device time was measured."""
    assert extract_trace.main(["16", "5", "--device", "cpu"])["busy_ms"] is None
    assert train_step_trace.main(["16", "5", "--device", "cpu"])["busy_ms"] is None
    assert capsys.readouterr().out.count("not measured") == 4


@pytest.mark.parametrize("call", [
    lambda: tps_approx_bench.main(["16", "16", "4"]),
    lambda: warp_channels_bench.main(["16", "1"]),
    lambda: extract_trace.main(["16"]),
    lambda: train_step_trace.main(["16"]),
    lambda: center_volumes.main(["--img_dir", ".", "--reference", "r.nii.gz",
                                 "--out_dir", "never"]),
    lambda: conv_microbench.main(["--size", "16"]),
], ids=["tps_approx_bench", "warp_channels_bench", "extract_trace", "train_step_trace",
        "center_volumes", "conv_microbench"])
def test_device_tools_need_a_card_by_default(call, monkeypatch):
    """No tool falls back to the CPU: without ``--device cpu`` each runs on
    the card and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert not os.path.exists("never")
