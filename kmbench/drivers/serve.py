"""The serving driver: one client in a closed loop, one pair a request.

A request draws a fixed and a moving volume from the pool (the pairs of
``inputs.PairOrder``), extracts both keypoint sets and aligns and warps the
moving volume under each transform of the mix, under ``torch.no_grad()``:
the calls ``KeyMorphNet.forward`` makes, split (``features``,
``keypoints_from_features``), then ``align_pair(..., compute_grid="planes")``
and ``align_planes`` for each transform. The client waits for the request's
last warp on the card before it sends the next.

Traffic keys: ``clients`` and ``batch`` (1 and 1: the driver runs no
other), ``pool`` (volumes), ``transforms`` (names: ``rigid``,
``affine``, ``tps_<lambda>``), ``warmup`` (requests before the window),
``profiled`` (requests under the profiler at the start of a traced
window), ``kept`` (requests whose planes and warped volumes are kept for
the output check, drawn from the seed).

A request's latency runs from a CUDA event recorded as it is issued, on an
idle stream, to one recorded after its last warp: the time from issue to
the last warped volume complete on the card.
"""

from __future__ import annotations

import random
import time
from collections import defaultdict

import torch

from kmbench import counts, inputs, judge, program
from kmbench.clock import Clock
from kmbench.reference import unet as ref_unet
from kmbench.reference.precision import REFERENCE, exact_fp32
from kmbench.spans import Spans
from kmbench.trace import Profiled


def param_specs(cfg):
    return ref_unet.param_specs(cfg["f_maps"], cfg["num_levels_for_unet"],
                                cfg["num_truncated_layers_for_truncatedunet"],
                                cfg["num_keypoints"])


def spatial(cfg):
    return tuple(int(s) for s in cfg["img_size"])


class Window:
    """A served window: ``data`` for the metric readers, ``answers`` for the
    output check, ``attempted``/``failed`` requests."""

    def __init__(self, ctx):
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        if tr["clients"] != 1 or tr["batch"] != 1:
            raise ValueError("the serving driver runs one client with one pair a request")
        from keymorph_tpu_torch.models import keymorph
        from keymorph_tpu_torch.ops import resample

        t_imported = time.perf_counter()
        self.net = program.keypoint_net(cfg, inputs.make_weights(ctx.seed, param_specs(cfg), dev),
                                        dev).eval()
        size = spatial(cfg)
        self.pool = inputs.make_pool(ctx.seed, tr["pool"], size[0], dev)
        order = inputs.PairOrder(ctx.seed, tr["pool"])
        transforms = []
        for name in tr["transforms"]:
            kind, lmbda = keymorph.parse_transform_type(name)
            lm = None if lmbda is None else torch.full((1,), float(lmbda), device=dev)
            transforms.append((name, kind, lm))
        clock = Clock(dev)
        spans = Spans(clock)
        t_built = time.perf_counter()

        def request(i):
            f, m = order(i)
            img_f, img_m = self.pool[f: f + 1], self.pool[m: m + 1]
            points = []
            for img in (img_f, img_m):
                with spans("backbone"):
                    feat = self.net.features(img)
                with spans("head"):
                    points.append(self.net.keypoints_from_features(feat))
                del feat
            outs = []
            for name, kind, lm in transforms:
                with spans("align"):
                    planes = keymorph.align_pair(points[0], points[1], kind, size, lmbda=lm,
                                                 compute_grid="planes")["planes"]
                with spans("warp"):
                    outs.append((name, planes, resample.align_planes(planes, img_m)))
            return f, m, points[0], points[1], outs

        with torch.no_grad():
            for i in range(tr["warmup"]):
                request(i)
            clock.sync()
            t = time.perf_counter()
            request(tr["warmup"])
            clock.sync()
            per_request = time.perf_counter() - t
            first = tr["warmup"] + 1
            expected = max(tr["profiled"] + tr["kept"], int(0.8 * ctx.seconds / per_request))
            keep = set(random.Random(inputs.sub_seed(ctx.seed, inputs.ORDER))
                       .sample(range(tr["profiled"], expected), tr["kept"]))
            setup_s = time.perf_counter() - ctx.t_start
            setup_parts = {"imports": t_imported - ctx.t_start, "inputs": t_built - t_imported,
                           "warmup": ctx.t_start + setup_s - t_built}

            events, keypoints, kept = [], defaultdict(list), []
            n, paused = 0, 0.0
            prof = Profiled(ctx.trace and tr["profiled"] > 0, clock)
            spans.on = ctx.trace
            t0 = time.perf_counter()
            over = False
            while not over:
                if n == 0:  # starting the profiler is not the window's work
                    t = time.perf_counter()
                    prof.__enter__()
                    paused += time.perf_counter() - t
                start = clock.mark()
                f, m, pf, pm, outs = request(first + n)
                end = clock.mark()
                clock.wait(end)
                n += 1
                if n == tr["profiled"]:
                    paused += _close(prof)
                events.append((start, end))
                keypoints[f].append(pf)
                keypoints[m].append(pm)
                over = time.perf_counter() - t0 - paused >= ctx.seconds
                # the sampled requests, and the last where the sample is short,
                # are copied to the host outside the window's clock
                if n - 1 in keep or (over and len(kept) < tr["kept"]):
                    t = time.perf_counter()
                    kept.append((f, m, pf.cpu(), pm.cpu(),
                                 [(name, p.cpu(), w.cpu()) for name, p, w in outs]))
                    paused += time.perf_counter() - t
                del outs
            window_s = time.perf_counter() - t0 - paused
            if n < tr["profiled"]:
                _close(prof)

        self.attempted, self.failed = n, 0
        self.answers = {"keypoints": keypoints, "kept": kept}
        plan, _, _ = counts.conv_plan(size, cfg["f_maps"], cfg["num_levels_for_unet"],
                                      cfg["num_truncated_layers_for_truncatedunet"])
        conv_bound = sum(counts.bound_s(counts.conv_flops(c), counts.conv_bytes(c)) for c in plan)
        self.data = {
            "unit": "request", "units": n, "window_s": window_s, "setup_s": setup_s,
            "setup_parts_s": setup_parts,
            "registrations": n * len(transforms), "volumes": 2 * n,
            "latencies_ms": [clock.ms(s, e) for s, e in events],
            "spans": spans.milliseconds(), "profile": prof.reading,
            "profiled_units": min(n, tr["profiled"]),
            "flops_per_unit": counts.registration_flops(
                size, cfg["num_keypoints"], cfg["f_maps"], cfg["num_levels_for_unet"],
                cfg["num_truncated_layers_for_truncatedunet"], tr["transforms"]),
            "conv_calls_per_unit": 2 * len(plan), "conv_bound_s_per_unit": 2 * conv_bound,
        }

    def release(self):
        """Drop the program's state: the net and the pool."""
        self.net = self.pool = None


def _close(prof) -> float:
    """Close the profiled stretch; the seconds its reading took."""
    t = time.perf_counter()
    prof.__exit__(None, None, None)
    return time.perf_counter() - t


def run(ctx) -> Window:
    return Window(ctx)


def judge_window(ctx, answers) -> dict:
    """The output check's numbers, from the inputs drawn anew."""
    cfg, dev = ctx.config, ctx.device
    exact_fp32()
    with torch.no_grad():
        weights = inputs.make_weights(ctx.seed, param_specs(cfg), dev)
        pool = inputs.make_pool(ctx.seed, ctx.traffic["pool"], spatial(cfg)[0], dev)
        return judge.serve_numbers(answers, weights, pool, cfg, REFERENCE)
