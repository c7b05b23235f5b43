"""Benchmark: pairwise registrations/sec on one card.

The port's counterpart of the repo's ``bench.py``, at its configuration
(``BASELINE.json``'s headline, "pairwise registrations/sec/chip at 256^3"):
TruncatedUNet3D (f_maps 32, 4 levels, 1 truncated layer, bf16) keypoint
extraction of the fixed and the moving volume, TPS solve (lambda 1) and
dense flow as ``ij`` planes, trilinear warp, under ``torch.no_grad()``: the
serving path of ``KeyMorphNet`` -> ``align_pair(..., "tps",
compute_grid="planes")`` -> ``align_planes``, on the port's kernels. The
weights are random, from ``torch.Generator().manual_seed(seed)``; the
volumes are uniform noise from a generator on the device seeded alike.

    python -m keymorph_tpu_torch.bench

Environment: ``BENCH_SIZE`` (256), ``BENCH_KEYPOINTS`` (128), ``BENCH_ITERS``
(8), ``BENCH_STAGES`` (1: the per-stage attribution), ``BENCH_THROUGHPUT``
(0; 1: the batch rows at bs 1, 2, 4 and 8).

Prints ONE JSON line: ``metric``, ``value`` (registrations/sec), ``unit``,
``vs_baseline`` (against ``BENCH_BASELINE.json``, a host-CPU run of the
torch reference; its ``hardware`` field is repeated as
``baseline_hardware``), ``stages``, ``per_batch``, ``device`` (the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` names it)
and ``timer``.

Timing: the headline chains the registrations, each iteration's warped
output the next one's moving volume, between two CUDA events, divided by the
iterations (the host clock spreads 10-30% between calls on this path). The
stages (``extract_ms``, ``solve_flow_ms``, ``warp_ms``) are each the mean of
CUDA events around single calls on fresh inputs, after a first call;
``register_ms`` is the headline's time. ``extract_mfu`` and
``solve_flow_mfu`` are their useful FLOPs (``tools/flops.py``) against the
H100's bf16 tensor-core peak, ``warp_hbm_frac`` the warp's least traffic
against its memory rate; ``busy_ms`` and ``idle_share`` come from
``torch.profiler`` over one registration (``tools/trace_summary.profile_fn``).
A batch row times single calls on fresh moving volumes and reports the peak
device memory since the first call. Nothing here falls back: any failure
(a kernel, an out-of-memory batch) raises.

``run(..., device="cpu")`` runs the same path on the CPU, where the kernels'
plain versions run; times are then the host clock and the device rates are
None (not measured).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

from keymorph_tpu_torch import disable_tf32, resolve_device
from keymorph_tpu_torch.models.keymorph import KeyMorphNet, align_pair
from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
from keymorph_tpu_torch.ops.resample import align_img, align_planes
from keymorph_tpu_torch.tools import card, flops, mean_ms
from keymorph_tpu_torch.tools.trace_summary import profile_fn

ROOT = Path(__file__).resolve().parents[1]
F_MAPS, NUM_LEVELS, NUM_TRUNCATED = 32, 4, 1
LMBDA = 1.0
FRESH = 2                  # fresh inputs a stage or a batch row is timed on
BATCH_SIZES = (1, 2, 4, 8)


def volumes(generator: torch.Generator, batch: int, size: int) -> torch.Tensor:
    """(batch, 1, size, size, size) uniform [0, 1) fp32 on the generator's
    device."""
    return torch.rand((batch, 1, size, size, size), generator=generator,
                      device=generator.device)


def setup(size: int, num_keypoints: int, device=None, seed: int = 0):
    """(net, img_f, img_m, generator): the bench's net (seeded random
    weights, evaluation mode) and its first pair; the generator draws every
    later input."""
    dev = resolve_device(device)
    backbone = TruncatedUNet3D(out_channels=num_keypoints, f_maps=F_MAPS,
                               num_levels=NUM_LEVELS, num_truncated_layers=NUM_TRUNCATED,
                               dtype=torch.bfloat16)
    net = KeyMorphNet(init_weights(backbone, torch.Generator().manual_seed(seed)),
                      num_keypoints).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return net, volumes(gen, 1, size), volumes(gen, 1, size), gen


def build_register(net: KeyMorphNet, planes: bool = True):
    """``register(img_f, img_m) -> warped``: both extractions, the TPS solve
    and flow, the warp. ``planes=False`` is the grid form of the same
    registration (``xy`` grid -> ``align_img``)."""

    @torch.no_grad()
    def register(img_f, img_m):
        points_f, points_m, _ = net(img_f, img_m)
        out = align_pair(points_f, points_m, "tps", img_f.shape[2:],
                         lmbda=torch.full((img_f.shape[0],), LMBDA, device=img_f.device),
                         compute_grid="planes" if planes else True)
        if planes:
            return align_planes(out["planes"], img_m)
        return align_img(out["grid"], img_m)

    return register


def build_stages(net: KeyMorphNet, planes: bool = True):
    """The registration as its three stages, ``(extract(img) -> points,
    solve_flow(points_f, points_m, grid_shape) -> planes or grid,
    warp(flow, img_m) -> warped)``; composed they are
    :func:`build_register`'s calls."""

    @torch.no_grad()
    def extract(img):
        return net.get_keypoints(img)

    @torch.no_grad()
    def solve_flow(points_f, points_m, grid_shape):
        out = align_pair(points_f, points_m, "tps", grid_shape,
                         lmbda=torch.full((points_f.shape[0],), LMBDA, device=points_f.device),
                         compute_grid="planes" if planes else True)
        return out["planes" if planes else "grid"]

    @torch.no_grad()
    def warp(flow, img_m):
        return align_planes(flow, img_m) if planes else align_img(flow, img_m)

    return extract, solve_flow, warp


def chain_ms(register, img_f, img_m, iters: int, device) -> float:
    """Milliseconds a registration when ``iters`` of them run chained (each
    warped output the next moving volume), after a first call: CUDA events
    around the chain on the card, the host clock on the CPU."""
    x = img_m
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            x = register(img_f, x)
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        x = register(img_f, x)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def baseline(size: int):
    """(registrations/sec, hardware) of ``BENCH_BASELINE.json`` at ``size``
    (its ``per_size`` entry, else its headline), (None, None) where the file
    is absent."""
    path = ROOT / "BENCH_BASELINE.json"
    if not path.exists():
        return None, None
    data = json.loads(path.read_text())
    return (data.get("per_size", {}).get(str(size)) or data.get("registrations_per_sec"),
            data.get("hardware"))


def _stages(net, register, img_f, img_m, gen, size, num_keypoints, register_ms, dev):
    on_card = dev.type == "cuda"
    extract, solve_flow, warp = build_stages(net)
    spatial = tuple(img_f.shape[2:])
    fresh = [volumes(gen, 1, size) for _ in range(FRESH)]
    rec = {"extract_ms": mean_ms(extract, [(v,) for v in fresh], dev)[0]}
    points_f = extract(img_f)
    points = [extract(v) for v in fresh]
    rec["solve_flow_ms"] = mean_ms(solve_flow, [(points_f, p, spatial) for p in points], dev)[0]
    flows = [solve_flow(points_f, p, spatial) for p in points]
    rec["warp_ms"] = mean_ms(warp, [(f, img_m) for f in flows], dev)[0]
    rec["register_ms"] = register_ms
    n = size ** 3
    ex = flops.unet_extract_flops(spatial, num_keypoints, F_MAPS, NUM_LEVELS, NUM_TRUNCATED)
    sf = flops.tps_flow_flops(n, num_keypoints) + flops.tps_solve_flops(num_keypoints)
    wb = flops.warp_bytes(n, in_bytes=img_m.element_size())
    rec.update({
        "extract_gflop": ex / 1e9,
        "extract_mfu": flops.mfu(ex, rec["extract_ms"] / 1e3) if on_card else None,
        "solve_flow_gflop": sf / 1e9,
        "solve_flow_mfu": flops.mfu(sf, rec["solve_flow_ms"] / 1e3) if on_card else None,
        "warp_gb_lower_bound": wb / 1e9,
        "warp_hbm_frac": (wb / (rec["warp_ms"] / 1e3) / flops.H100_HBM_BYTES_PER_S
                          if on_card else None),
    })
    summary = profile_fn(register, img_f, fresh[0])[1]
    rec["busy_ms"], rec["idle_share"] = summary["busy_ms"], summary["idle_share"]
    return rec


def _batch_rows(register, gen, size, dev):
    rows = {}
    for bs in BATCH_SIZES:
        img_f = volumes(gen, bs, size)
        moving = [volumes(gen, bs, size) for _ in range(FRESH)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ms = mean_ms(register, [(img_f, m) for m in moving], dev)[0]
        rows[str(bs)] = {"latency_ms": ms, "regs_per_sec": 1e3 * bs / ms,
                         "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                      if dev.type == "cuda" else None)}
        del img_f, moving
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def run(size: int = 256, num_keypoints: int = 128, iters: int = 8, stages: bool = True,
        throughput: bool = False, device=None, seed: int = 0, return_first: bool = False):
    """The bench's record (the JSON object ``main`` prints); with
    ``return_first`` also the first registration's warped volume,
    ``(record, warped)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    net, img_f, img_m, gen = setup(size, num_keypoints, dev, seed)
    register = build_register(net)
    first = register(img_f, img_m)
    register_ms = chain_ms(register, img_f, img_m, iters, dev)
    value = 1e3 / register_ms
    base, base_hw = baseline(size)
    record = {
        "metric": f"pairwise tps registrations/sec/chip at {size}^3 "
                  f"({num_keypoints} kp, truncatedunet, bf16)",
        "value": value,
        "unit": "registrations/sec",
        "vs_baseline": value / base if base else None,
        "baseline_hardware": base_hw,
        "stages": (_stages(net, register, img_f, img_m, gen, size, num_keypoints, register_ms,
                           dev) if stages else None),
        "per_batch": _batch_rows(register, gen, size, dev) if throughput else None,
        "device": card(dev),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
    }
    return (record, first) if return_first else record


def main():
    env = os.environ.get
    print(json.dumps(run(size=int(env("BENCH_SIZE", "256")),
                         num_keypoints=int(env("BENCH_KEYPOINTS", "128")),
                         iters=int(env("BENCH_ITERS", "8")),
                         stages=env("BENCH_STAGES", "1") == "1",
                         throughput=env("BENCH_THROUGHPUT", "0") == "1")))


if __name__ == "__main__":
    main()
