#!/usr/bin/env python3
"""Smoke run of keymorph_tpu_torch on one NVIDIA GPU (the quickest proof that
the port builds, launches and registers on the card).

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is not 0):

  0. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
     the time to build the CUDA kernels from ``keymorph_tpu_torch/csrc``;
  1. each kernel against its plain PyTorch version on the card at the main
     path's shapes (256^3 input): max abs error against the stated
     tolerance, kernel and plain times (CUDA events);
  2. end to end: the flagship config (TruncatedUNet3D f_maps=32, 4 levels,
     1 truncated, bf16; 128 keypoints; TPS lmbda=1) at 256^3 with seeded
     random weights serves 3 pairs through the kernels: extract fixed and
     moving -> align_pair("tps", compute_grid="planes") -> align_planes.
     Every kernel of the path must have launched and no plain version run;
  3. the same 3 pairs through the plain versions on the card, compared with
     phase 2 (keypoints, planes, warped images) within stated tolerances;
  4. one steady pair through the kernels under ``torch.profiler``: the
     device's busy time, its idle share and the device time by kernel name.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it raises before printing
a result. The script imports neither jax nor keymorph_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SPATIAL = (256, 256, 256)
N_PAIRS = 3
NUM_KEYPOINTS = 128
LMBDA = 1.0
UNET = dict(out_channels=NUM_KEYPOINTS, f_maps=32, num_levels=4, num_truncated_layers=1)

# tolerances, kernel vs plain version on the same inputs
CONV_REL_ULP = 2.0 ** -7   # one bf16 ulp of each output (same fp32 sum, other order)
CONV_FLOOR = 1e-6          # x max|out|: outputs that cancel to near zero
STATS_REL = 1e-5           # x max|stat|: fp32 sums of the same bf16 outputs
TPS_ABS = 1e-5             # fp32 sum over 128 control points in another order
WARP_ABS = 0.0             # the kernel rounds every operation as the plain version
# phase 3, plain path vs kernel path (bf16 conv outputs may differ by 1 ulp
# and the differences propagate through the network and the TPS fit)
KEYPOINT_ABS = 1e-3        # normalized units (0.13 voxel at 256)
PLANES_ABS = 1e-3
# the warped image is held against the plain warp on the kernel path's own
# planes, so it is WARP_ABS (exact)

REPLACES = {
    "conv": "keymorph_tpu/ops/pallas/conv3d.py:337",
    "tps": "keymorph_tpu/ops/pallas/tpsflow.py:60",
    "warp": "keymorph_tpu/ops/pallas/resample3d.py:110",
}


def _import_port():
    sys.path.insert(0, str(ROOT))
    import keymorph_tpu_torch

    pkg = Path(keymorph_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"keymorph_tpu_torch imported from {pkg}, not from {ROOT}")
    return keymorph_tpu_torch


def _smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps):
    """Mean milliseconds per call: one warm-up call, then ``reps`` calls
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _conv_check(k, p):
    """(max abs err, ok) of bf16 conv outputs and their stats."""
    (ko, ks), (po, ps) = k, p
    ko, po = ko.float(), po.float()
    err = (ko - po).abs()
    ok = bool((err <= CONV_REL_ULP * po.abs() + CONV_FLOOR * po.abs().max()).all())
    for a, b in zip(ks, ps):
        ok &= bool(((a - b).abs() <= STATS_REL * b.abs().max()).all())
    return err.max().item(), ok


def phase1(torch, rng, dev):
    """Each kernel vs its plain version at the main path's shapes."""
    from keymorph_tpu_torch.models.fast_unet import gn_affine_from_stats
    from keymorph_tpu_torch.ops.cuda import conv3d, resample3d, tpsflow
    from keymorph_tpu_torch.ops.cuda.conv3d import channel_stats
    from keymorph_tpu_torch.transforms import solvers

    def bf16(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                            device=dev).to(torch.bfloat16)

    def weights(cin, cout):
        return torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32)
                            / np.sqrt(27 * cin), device=dev)

    def gn(x, groups):
        c = x.shape[1]
        gamma = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32), device=dev)
        beta = torch.tensor(rng.normal(size=c).astype(np.float32) * 0.2, device=dev)
        return gn_affine_from_stats(channel_stats(x), gamma, beta, groups)

    results = {}
    Z, Y, X = SPATIAL
    # e0 conv 1: 1 -> 16 at 256^3, GroupNorm affine (1 group) and stats
    img = torch.tensor(rng.random((Z, 1, Y * X), dtype=np.float32), device=dev).to(torch.bfloat16)
    w = weights(1, 16)
    sc, sh = gn(img, 1)
    args = (img, SPATIAL, w, sc, sh)
    err, ok = _conv_check(conv3d.conv3x3_fused_flat(*args, emit_stats=True),
                          conv3d.conv3x3_fused_flat_plain(*args, emit_stats=True))
    torch.cuda.synchronize()
    ms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat(*args, emit_stats=True), 5)
    pms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_plain(*args, emit_stats=True), 3)
    results["conv3x3_fused_flat"] = (err, ms, pms)
    print(f"phase1 conv e0c1 1->16 @256^3 (+GN affine, stats): max_abs_err={err!r} "
          f"within 1 bf16 ulp (+{CONV_FLOOR}*max) and stats rel {STATS_REL}: {ok}; "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if not ok:
        raise AssertionError("conv e0c1 kernel disagrees with its plain version")
    del img, args

    # d1 conv 1 (upconv): [64 skip @128^3 | up2(128 @64^3)] -> 64
    h = (Z // 2, Y // 2, X // 2)
    lo = (Z // 4, Y // 4, X // 4)
    skip = torch.relu(bf16(h[0], 64, h[1] * h[2]))
    low = torch.relu(bf16(lo[0], 128, lo[1] * lo[2]))
    s_skip, s_low = channel_stats(skip), channel_stats(low)
    stats = (torch.cat([s_skip[0], s_low[0]]), torch.cat([s_skip[1], s_low[1]]))
    gamma = torch.tensor(rng.uniform(0.5, 1.5, 192).astype(np.float32), device=dev)
    beta = torch.tensor(rng.normal(size=192).astype(np.float32) * 0.2, device=dev)
    sc, sh = gn_affine_from_stats(stats, gamma, beta, 8)
    w = weights(192, 64)
    args = (skip, low, h, w, sc, sh)
    err, ok = _conv_check(conv3d.conv3x3_fused_flat_upconv(*args, emit_stats=True),
                          conv3d.conv3x3_fused_flat_upconv_plain(*args, emit_stats=True))
    torch.cuda.synchronize()
    ms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_upconv(*args, emit_stats=True), 3)
    pms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_upconv_plain(*args, emit_stats=True), 3)
    results["conv3x3_fused_flat_upconv"] = (err, ms, pms)
    print(f"phase1 conv d1c1 upconv [64@128^3 | up2(128@64^3)]->64: max_abs_err={err!r} "
          f"within 1 bf16 ulp and stats rel {STATS_REL}: {ok}; kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms")
    if not ok:
        raise AssertionError("conv d1c1 upconv kernel disagrees with its plain version")

    # the same conv as parts (the decoder's fallback): upsample materialized
    up = conv3d.upsample_nearest_flat(low, lo, h).contiguous()
    args = (skip, up, h, w, sc, sh)
    err, ok = _conv_check(conv3d.conv3x3_fused_flat_parts(*args, emit_stats=True),
                          conv3d.conv3x3_fused_flat_parts_plain(*args, emit_stats=True))
    torch.cuda.synchronize()
    ms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_parts(*args, emit_stats=True), 3)
    pms = _cuda_ms(lambda: conv3d.conv3x3_fused_flat_parts_plain(*args, emit_stats=True), 3)
    results["conv3x3_fused_flat_parts"] = (err, ms, pms)
    print(f"phase1 conv d1c1 parts [64@128^3 | 128@128^3]->64: max_abs_err={err!r} "
          f"within 1 bf16 ulp and stats rel {STATS_REL}: {ok}; kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms")
    if not ok:
        raise AssertionError("conv parts kernel disagrees with its plain version")
    del skip, low, up, args

    # TPS flow planes at 256^3, T = 128, from a real fit
    src = rng.uniform(-0.8, 0.8, (1, NUM_KEYPOINTS, 3)).astype(np.float32)
    dst = src + rng.normal(0, 0.03, src.shape).astype(np.float32)
    ctrl = torch.tensor(src, device=dev)
    theta = solvers.fit_tps(ctrl, torch.tensor(dst, device=dev), LMBDA).contiguous()
    planes = tpsflow.tps_planes(theta, ctrl, SPATIAL)
    ref = tpsflow.tps_planes_plain(theta, ctrl, SPATIAL)
    torch.cuda.synchronize()
    err = (planes - ref).abs().max().item()
    ms = _cuda_ms(lambda: tpsflow.tps_planes(theta, ctrl, SPATIAL), 5)
    pms = _cuda_ms(lambda: tpsflow.tps_planes_plain(theta, ctrl, SPATIAL), 2)
    results["tps_planes"] = (err, ms, pms)
    print(f"phase1 tps_planes 256^3 T=128: max_abs_err={err!r} (tol {TPS_ABS}); "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if not err <= TPS_ABS:
        raise AssertionError("tps_planes kernel disagrees with its plain version")
    del ref

    # warp at 256^3 on those planes
    vol = torch.tensor(rng.random((1, 1, *SPATIAL), dtype=np.float32), device=dev)
    for mode in ("bilinear", "nearest"):
        out = resample3d.warp_planes(vol, planes, mode)
        ref = resample3d.warp_planes_plain(vol, planes, mode)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = _cuda_ms(lambda: resample3d.warp_planes(vol, planes, mode), 5)
        pms = _cuda_ms(lambda: resample3d.warp_planes_plain(vol, planes, mode), 3)
        if mode == "bilinear":
            results["warp_planes"] = (err, ms, pms)
        print(f"phase1 warp_planes {mode} 256^3 C=1: max_abs_err={err!r} (tol {WARP_ABS}); "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if not err <= WARP_ABS:
            raise AssertionError(f"warp_planes {mode} kernel disagrees with its plain version")
    return results


def _make_pairs(torch, rng, dev):
    """N_PAIRS (fixed, moving) volumes (1, 1, 256, 256, 256) in [0, ~1.2]:
    Gaussian blobs plus noise; the moving blobs are displaced by a few
    voxels each. Parameters and noise come from the numpy generator."""
    axes = [torch.linspace(-1, 1, s, device=dev) for s in SPATIAL]
    pairs = []
    for _ in range(N_PAIRS):
        c = rng.uniform(-0.6, 0.6, (8, 3))
        width = rng.uniform(0.05, 0.2, 8)
        amp = rng.uniform(0.3, 1.0, 8)
        shift = rng.normal(0, 0.03, (8, 3))
        vols = []
        for cs in (c, c + shift):
            v = torch.zeros(SPATIAL, device=dev)
            for (cz, cy, cx), wd, a in zip(cs, width, amp):
                v += a * (torch.exp(-(axes[0] - cz) ** 2 / wd)[:, None, None]
                          * torch.exp(-(axes[1] - cy) ** 2 / wd)[None, :, None]
                          * torch.exp(-(axes[2] - cx) ** 2 / wd)[None, None, :])
            noise = torch.tensor(rng.random(SPATIAL, dtype=np.float32), device=dev)
            vols.append((v.clamp(max=1.0) + 0.2 * noise)[None, None].contiguous())
        pairs.append(tuple(vols))
    return pairs


def phase2(torch, net, pairs):
    """Serve the pairs through the kernels; return per-pair outputs."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.resample import align_planes

    outs, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    for img_f, img_m in pairs:
        t0 = time.perf_counter()
        pf, pm, _ = net(img_f, img_m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        planes = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes")["planes"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        warped = align_planes(planes, img_m)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs.append((pf, pm, planes, warped))
        times.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
    counts = kernels.counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (e, s, w, t) in enumerate(times):
        print(f"phase2 pair {i}: extract {e * 1e3:.3f} ms, solve+flow {s * 1e3:.3f} ms, "
              f"warp {w * 1e3:.3f} ms, total {t * 1e3:.3f} ms")
    print(f"phase2 peak device memory {peak:.3f} GiB; counters {json.dumps(counts)}")
    for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "tps_planes",
                 "warp_planes"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"phase 2 never launched the {name} kernel")
    if any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"phase 2 ran a plain version: {counts}")
    for pf, pm, planes, warped in outs:
        for t, shape in ((pf, (1, NUM_KEYPOINTS, 3)), (planes, (1, 3, *SPATIAL)),
                         (warped, (1, 1, *SPATIAL))):
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"phase 2 output {tuple(t.shape)} not finite {shape}")
        if not bool((pf.abs() <= 1).all() and (pm.abs() <= 1).all()):
            raise AssertionError("phase 2 keypoints leave [-1, 1]")
    return outs, counts, times


def phase3(torch, net, pairs, kernel_outs):
    """The same pairs through the plain versions on the card; compare."""
    from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
    from keymorph_tpu_torch.models.layers import center_of_mass
    from keymorph_tpu_torch.ops.cuda import resample3d, tpsflow
    from keymorph_tpu_torch.transforms import solvers

    worst = [0.0, 0.0, 0.0]
    for i, ((img_f, img_m), (kpf, kpm, kplanes, kwarped)) in enumerate(zip(pairs, kernel_outs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf = center_of_mass(fast_unet_forward(net.backbone, img_f, plain=True))
        pm = center_of_mass(fast_unet_forward(net.backbone, img_m, plain=True))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        theta = solvers.fit_tps(pf, pm, LMBDA).contiguous()
        planes = tpsflow.tps_planes_plain(theta, pf.contiguous(), SPATIAL)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        warped = resample3d.warp_planes_plain(img_m, planes)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        d = [max((pf - kpf).abs().max().item(), (pm - kpm).abs().max().item()),
             (planes - kplanes).abs().max().item(),
             (resample3d.warp_planes_plain(img_m, kplanes) - kwarped).abs().max().item()]
        worst = [max(a, b) for a, b in zip(worst, d)]
        print(f"phase3 pair {i} plain path: extract {(t1 - t0) * 1e3:.3f} ms, "
              f"solve+flow {(t2 - t1) * 1e3:.3f} ms, warp {(t3 - t2) * 1e3:.3f} ms, "
              f"total {(t3 - t0) * 1e3:.3f} ms; vs kernels: keypoints {d[0]!r}, "
              f"planes {d[1]!r}, warped on the kernel planes {d[2]!r}; warped on "
              f"each path's own planes {(warped - kwarped).abs().max().item()!r} (not checked: it "
              f"carries the planes difference)")
    print(f"phase3 worst: keypoints {worst[0]!r} (tol {KEYPOINT_ABS}), planes "
          f"{worst[1]!r} (tol {PLANES_ABS}), warped {worst[2]!r} (tol {WARP_ABS})")
    if not (worst[0] <= KEYPOINT_ABS and worst[1] <= PLANES_ABS and worst[2] <= WARP_ABS):
        raise AssertionError("kernel path and plain path disagree")


def phase4(torch, net, pairs):
    """One steady pair on the kernel path under torch.profiler: host wall,
    device busy time (the union of the device's kernel and copy intervals),
    the device's idle share, and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_planes

    img_f, img_m = pairs[1]  # served in phases 2 and 3 already: steady state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf, pm, _ = net(img_f, img_m)
        planes = align_pair(pf, pm, "tps", SPATIAL, lmbda=LMBDA, compute_grid="planes")["planes"]
        align_planes(planes, img_m)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:  # a measurement gap, not a failure of the port
        print(f"phase4 pair: host wall {wall_us / 1e3:.3f} ms; torch.profiler recorded "
              f"no device activity, device idle share not measured")
        return
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.end - e.time_range.start)
    print(f"phase4 pair: host wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"device idle share {1 - busy / wall_us:.4f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"phase4 {t / 1e3:.3f} ms {n}x share_of_busy {t / busy:.4f} {name[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; the port has no CPU smoke")
    km = _import_port()
    from keymorph_tpu_torch import _build

    km.disable_tf32()
    dev = torch.device("cuda", 0)
    smi = _smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase0 {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"kernel build {build_s:.3f} s")

    rng = np.random.default_rng(SEED)
    k1 = phase1(torch, rng, dev)
    torch.cuda.empty_cache()

    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights

    gen = torch.Generator().manual_seed(SEED)
    net = KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **UNET), gen),
                      NUM_KEYPOINTS).to(dev).eval()
    pairs = _make_pairs(torch, rng, dev)
    outs, counts, _ = phase2(torch, net, pairs)
    phase3(torch, net, pairs, outs)
    phase4(torch, net, pairs)

    def entry(name, key, source):
        err, ms, pms = k1[name]
        return {"name": name, "route": "cuda", "source": f"keymorph_tpu_torch/csrc/{source}",
                "replaces": REPLACES[key], "launches": counts[name]["launches"],
                "max_abs_err": err, "ms": ms, "plain_ms": pms}

    print(smi)
    print(json.dumps({"kernels": [
        entry("conv3x3_fused_flat", "conv", "conv3d.cu"),
        entry("conv3x3_fused_flat_upconv", "conv", "conv3d.cu"),
        entry("tps_planes", "tps", "tpsflow.cu"),
        entry("warp_planes", "warp", "resample3d.cu"),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
