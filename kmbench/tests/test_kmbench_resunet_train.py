"""The residual training cell ``train-resunetse-tps`` on the CPU at a small
size: the run to a ``correct`` result, the refusal of a program that trains the
residual nets through their modules, the counts against hand counts, the new
readers on a synthetic profile, and the control's and a fault's refusal."""

import json

import pytest
import torch

from kmbench import judge, run
from kmbench.counts import resunet_train as counts
from kmbench.drivers import train_resunet
from kmbench.reference.precision import CONTROL, REFERENCE
from kmbench.registry import Cell
from kmbench.trace import Reading

CELL = "train-resunetse-tps"
SMALL = {"img_size": [32, 32, 32], "f_maps": 8, "num_keypoints": 16, "max_train_keypoints": 8}
NEW = {"tconv_bwd_ms.train": "unet.tconv.bwd", "se_gate_bwd_ms.train": "unet.se.bwd",
       "residual_bwd_ms.train": "unet.residual.bwd"}
NUMBERS = ["keypoints", "keypoints.median", "loss", "loss.step1", "grad_norm", "grad_norm.median",
           "param_change", "param_change.median"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_to_a_correct_result(trace):
    result, rows = run.execute(CELL, 2 ** 31 + 17, 0.3, trace, device="cpu", config=SMALL)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["attempted"] >= 1
    assert [r[0] for r in rows] == NUMBERS
    if trace:  # no device on the CPU: the device readers report nothing
        assert not {"conv_roofline.train", "tconv_bwd_roofline.train",
                    "se_gate_bwd_roofline.train"} & set(line["metrics"])
    else:
        assert line["metrics"]["train_step_ms"]["value"] > 0


def test_a_program_training_through_the_modules_is_refused(monkeypatch):
    """With ``features`` taking the module's forward under grad (as a program
    without the residual executor's backward does), the run fails before any
    weights are made or any step is taken."""
    from keymorph_tpu_torch.models import keymorph

    from kmbench import inputs

    monkeypatch.setattr(keymorph, "supports_fast_resunet", lambda backbone: False)
    made = []
    monkeypatch.setattr(inputs, "make_weights", lambda *a: made.append(a))
    with pytest.raises(ValueError, match="through their modules"):
        run.execute(CELL, 3, 0.3, 0, device="cpu", config=SMALL)
    assert not made


def test_counts_of_the_full_configuration():
    """128^3, f_maps 32, 4 levels: the 14 3x3x3 convs of the serving count
    (~0.89 TFLOP a volume with the transposed convs), three transposed convs
    whose backward's least time is their two gradients', seven gates read
    three times a value; a step ~5.5 TFLOP of useful work (no recomputation)."""
    size = (128, 128, 128)
    plan, cin, vox = counts.conv_plan(size, 32, 4, 0)
    t = counts.tconv_plan(size, 32, 4)
    g = counts.gate_plan(size, 32, 4)
    assert len(plan) == 14 and (cin, vox) == (32, 128 ** 3) and len(t) == 3 and len(g) == 7
    conv = sum(counts.conv_flops(c) for c in plan) + sum(counts.tconv_flops(x) for x in t)
    assert 0.88e12 < conv < 0.90e12
    d2 = t[2]
    assert (d2["cin"], d2["cout"], d2["vox"]) == (64, 32, 128 ** 3)
    assert counts.tconv_bwd_bound_s(d2) == pytest.approx(
        counts.bound_s(counts.tconv_flops(d2), counts.tconv_dgrad_bytes(d2))
        + counts.bound_s(counts.tconv_flops(d2), counts.tconv_wgrad_bytes(d2)))
    assert counts.tconv_dgrad_bytes(d2) == (32 * 128 ** 3 + 27 * 64 * 32 + 64 * 64 ** 3) * 2
    assert counts.gate_bwd_bytes(g[0]) == 3 * 32 * 128 ** 3 * 2
    step = counts.train_step_flops(size, 128, 32, 4, 0, 64)
    assert 5.3e12 < step < 5.7e12


def _profile(names, span="km.unet.tconv.bwd"):
    """Kernels of 10 us each, one a name, launched inside ``span``."""
    events = [{"ph": "X", "cat": "user_annotation", "name": span, "ts": 0,
               "dur": 100 * len(names), "tid": 1}]
    for i, name in enumerate(names):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": 20 * i, "dur": 1, "tid": 1, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "ts": 20 * i + 5, "dur": 10, "tid": 99,
                       "name": f"void (anonymous namespace)::{name}(MmaArgs)",
                       "args": {"correlation": i}})
    return Reading(events, wall_us=100.0 * len(names))


def test_roofline_readers_read_their_kernels_by_name():
    """The transposed convs' backward reader takes the input gradient, the
    weight gradient and its reduce, not the forward ``tconv3_mma_kernel``;
    the gate's reader the backward kernel, not the forward; neither is a
    ``conv3x3_*`` kernel for the convs' reader. None where the profile does
    not hold the plan's calls or the record has no plan."""
    cell = Cell(CELL)
    tconv, gate = cell.reader("tconv_bwd_roofline.train"), cell.reader("se_gate_bwd_roofline.train")
    names = ["tconv3_dgrad_mma_kernel<64>", "tconv3_wgrad_mma_kernel<32>",
             "tconv3_wgrad_reduce_kernel", "tconv3_mma_kernel<64>", "scse_gate_bwd_kernel",
             "scse_gate_kernel"]
    data = {"profile": _profile(names), "profiled_units": 1,
            "tconv_bwd_calls_per_unit": 3, "tconv_bwd_bound_s_per_unit": 15e-6,
            "gate_bwd_calls_per_unit": 1, "gate_bwd_bound_s_per_unit": 2e-6}
    assert tconv(data) == pytest.approx(50.0)
    assert gate(data) == pytest.approx(20.0)
    assert tconv(dict(data, tconv_bwd_calls_per_unit=4)) is None
    assert gate({"profile": data["profile"], "profiled_units": 1}) is None
    conv = cell.reader("conv_roofline.train")
    assert conv(dict(data, conv_calls_per_unit=6, conv_bound_s_per_unit=1e-5)) is None
    assert {"tconv_bwd_roofline.train", "se_gate_bwd_roofline.train", "conv_roofline.train",
            "mfu.train"} <= {m["name"] for m in cell.per_layer()}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_span_reader(metric):
    c = Cell(CELL)
    assert metric in {m["name"] for m in c.per_layer()}
    read = c.reader(metric)
    assert read({"profile": None, "profiled_units": 0}) is None
    data = {"profile": _profile(["k"], span=f"km.{NEW[metric]}"), "profiled_units": 2}
    assert read(data) == pytest.approx(0.010 / 2)
    other = {"profile": _profile(["k"], span="km.unet.tconv"), "profiled_units": 2}
    assert read(other) is None


@pytest.mark.parametrize("who", ["control", "half"])
def test_the_control_and_a_fault_are_not_correct(who):
    """The reference with fp8 conv operands and TF32 products, or with each
    step's loss over half of the voxels, put in the program's place at the
    small size, fails the cell's limits; the reference in its own place
    reads 0 on every number."""
    cell = Cell(CELL)
    ctx = run.Context(CELL, dict(cell.config, **SMALL), cell.traffic, 7, 0.3, False,
                      torch.device("cpu"), 0.0)
    numbers = (train_resunet.control_numbers(ctx, CONTROL) if who == "control"
               else train_resunet.control_numbers(ctx, REFERENCE, "half"))
    correct, rows = judge.verdict(numbers, cell.limits)
    assert list(numbers) == NUMBERS and not correct, rows
    same = train_resunet.control_numbers(ctx, REFERENCE)
    assert all(v == 0.0 for v in same.values()), same
