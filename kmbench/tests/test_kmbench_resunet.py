"""The residual cell ``serve-resunetse-tps1`` on the CPU at a small size: the
run to a ``correct`` result, its driver's net against the reference's
parameters, the counts against hand counts, the new readers on a synthetic
profile, and the control's refusal."""

import json

import pytest
import torch

from kmbench import inputs, run
from kmbench.counts import resunet as counts
from kmbench.drivers import serve_resunet
from kmbench.registry import Cell
from kmbench.trace import Reading

CELL = "serve-resunetse-tps1"
SMALL = {"img_size": [32, 32, 32], "f_maps": 8, "num_keypoints": 16}
NEW = {"tconv_ms.serve": "unet.tconv", "se_gate_ms.serve": "unet.se",
       "residual_ms.serve": "unet.residual"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_to_a_correct_result(trace):
    result, rows = run.execute(CELL, 2 ** 31 + 13, 0.3, trace, device="cpu", config=SMALL)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["attempted"] >= 1
    assert [r[0] for r in rows] == ["keypoints", "keypoints.median", "planes.tps_1", "warped"]
    if trace:  # no device on the CPU: the device readers report nothing
        assert not {"conv_roofline.serve", "tconv_roofline.serve",
                    "se_gate_roofline.serve"} & set(line["metrics"])
    else:
        assert line["metrics"]["regs_per_s"]["value"] > 0


def test_the_drivers_net_holds_the_references_parameters():
    cfg = dict(Cell(CELL).config, **SMALL)
    w = inputs.make_weights(3, serve_resunet.param_specs(cfg), "cpu")
    net = serve_resunet.keypoint_net(cfg, w, "cpu")
    sd = net.state_dict()
    assert {f"backbone.{k}" for k in w} == set(sd)
    assert all(torch.equal(sd[f"backbone.{k}"], v) for k, v in w.items())


def test_counts_of_the_full_configuration():
    """256^3, f_maps 32, 4 levels: 14 3x3x3 convs a volume (two a block,
    seven blocks), the residual read by every second; ~7.1 TFLOP of convs
    with the three transposed convs; the last transposed conv by hand."""
    size = (256, 256, 256)
    plan, cin, vox = counts.conv_plan(size, 32, 4, 0)
    assert len(plan) == 14 and (cin, vox) == (32, 256 ** 3)
    assert [c["res"] for c in plan] == [0, 32, 0, 64, 0, 128, 0, 256, 0, 128, 0, 64, 0, 32]
    t = counts.tconv_plan(size, 32, 4)
    assert [(x["cin"], x["cout"], x["vox"]) for x in t] == [
        (256, 128, 64 ** 3), (128, 64, 128 ** 3), (64, 32, 256 ** 3)]
    assert counts.tconv_flops(t[2]) == 2 * 27 * 64 * 32 * 128 ** 3
    conv = sum(counts.conv_flops(c) for c in plan) + sum(counts.tconv_flops(x) for x in t)
    assert 7.0e12 < conv < 7.2e12
    g = counts.gate_plan(size, 32, 4)
    assert [x["c"] for x in g] == [32, 64, 128, 256, 128, 64, 32]
    assert counts.gate_bytes(g[0]) == 2 * 32 * 256 ** 3 * 2
    assert counts.conv_bytes(plan[1]) == counts.conv_bytes(plan[0]) + 32 * 256 ** 3 * 2
    with pytest.raises(ValueError):
        counts.conv_plan(size, 32, 4, 1)


def _profile(name, n):
    """``n`` kernels named ``name`` of 10 us each, launched inside
    ``km.unet.tconv``."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "km.unet.tconv", "ts": 0,
               "dur": 100 * n, "tid": 1}]
    for i in range(n):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": 20 * i, "dur": 1, "tid": 1, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "ts": 20 * i + 5, "dur": 10, "tid": 99,
                       "name": f"void (anonymous namespace)::{name}<64>(MmaArgs)",
                       "args": {"correlation": i}})
    return Reading(events, wall_us=100.0 * n)


def test_roofline_readers_read_their_kernels_by_name():
    cell = Cell(CELL)
    tconv, gate = cell.reader("tconv_roofline.serve"), cell.reader("se_gate_roofline.serve")
    data = {"profile": _profile("tconv3_mma_kernel", 6), "profiled_units": 1,
            "tconv_calls_per_unit": 6, "tconv_bound_s_per_unit": 30e-6,
            "gate_calls_per_unit": 14, "gate_bound_s_per_unit": 1e-5}
    assert tconv(data) == pytest.approx(50.0)
    assert gate(data) is None  # no gate kernel in the profile
    assert tconv(dict(data, tconv_calls_per_unit=3)) is None  # not the plan's calls
    assert tconv({"profile": data["profile"], "profiled_units": 1}) is None  # no plan
    # the 3x3x3 convs' reader does not count the transposed conv
    conv = cell.reader("conv_roofline.serve")
    assert conv(dict(data, conv_calls_per_unit=6, conv_bound_s_per_unit=1e-5)) is None
    assert cell.reader("tconv_ms.serve")(data) == pytest.approx(0.06 / 2)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_span_reader(metric):
    c = Cell(CELL)
    assert metric in {m["name"] for m in c.per_layer()}
    read = c.reader(metric)
    assert read({"profile": None, "profiled_units": 0}) is None
    events = [{"ph": "X", "cat": "user_annotation", "name": f"km.{NEW[metric]}", "ts": 0,
               "dur": 50, "tid": 1},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
               "tid": 1, "args": {"correlation": 1}},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 8, "tid": 99,
               "args": {"correlation": 1}}]
    data = {"profile": Reading(events, wall_us=60.0), "profiled_units": 2}
    assert read(data) == pytest.approx(0.008 / 4)


def test_the_control_is_not_correct():
    """The reference with fp8 conv operands and TF32 products, put in the
    program's place at the small size, fails the cell's limits."""
    from kmbench import judge

    cell = Cell(CELL)
    ctx = run.Context(CELL, dict(cell.config, **SMALL), cell.traffic, 7, 0.3, False,
                      torch.device("cpu"), 0.0)
    correct, rows = judge.verdict(serve_resunet.control_numbers(ctx), cell.limits)
    assert not correct, rows


def test_a_run_without_the_gate_is_not_correct(monkeypatch):
    """The program with its scSE gates left out, at the small size: its
    keypoints move as a whole, and ``keypoints.median`` fails its limit by
    far more than the sound run's reading."""
    from keymorph_tpu_torch.models import fast_resunet

    sound, _ = run.execute(CELL, 2 ** 31 + 11, 0.3, 0, device="cpu", config=SMALL)
    monkeypatch.setattr(fast_resunet._KERNELS, "gate", lambda xf, se, mean=None: xf)
    broken, _ = run.execute(CELL, 2 ** 31 + 11, 0.3, 0, device="cpu", config=SMALL)
    limit = Cell(CELL).limits["keypoints.median"]
    assert sound["correct"] is True and broken["correct"] is False
    assert broken["check"]["keypoints.median"]["value"] > 10 * limit
    assert broken["check"]["keypoints.median"]["value"] > 100 * \
        sound["check"]["keypoints.median"]["value"]
