"""The metric arithmetic against hand counts: the percentile, the idle
share and its gaps from a synthetic trace, the attribution of kernels to
the host range that launched them, the conv roofline and the MFU."""

import pytest

from kmbench import counts, readings
from kmbench.registry import Cell
from kmbench.trace import Reading, union_us


def test_p95_over_known_samples():
    assert readings.quantile(list(range(1, 101)), 0.95) == pytest.approx(95.05)
    assert readings.quantile([3.0], 0.95) == 3.0
    assert readings.quantile([1.0, 2.0], 0.5) == 1.5
    assert readings.quantile([], 0.95) is None
    reader = Cell("serve-full-tps1").reader("pair_p95_ms")
    assert reader({"latencies_ms": [float(x) for x in range(20, 0, -1)]}) == pytest.approx(19.05)


def _trace():
    """Host thread 1 runs a span with two ops, each launching a kernel;
    thread 2 runs an autograd node that launches a third; the device is
    busy 10-20, 15-30 (overlapping) and 50-60 of a 100-us stretch."""
    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "kmbench.backbone", 0, 45),
        x("cpu_op", "aten::mm", 2, 5),
        x("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=7),
        x("cpu_op", "aten::sum", 9, 5),
        x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=8),
        x("cpu_op", "autograd::engine::evaluate_function: _FusedConvBackward", 40, 10, tid=2),
        x("cuda_runtime", "cudaLaunchKernel", 41, 1, tid=2, corr=9),
        x("kernel", "conv3x3_mma_kernel<64>", 10, 10, tid=99, corr=7),
        x("kernel", "reduce_kernel", 15, 15, tid=99, corr=8),
        x("kernel", "conv3x3_mma_kernel<64>", 50, 10, tid=99, corr=9),
        {"ph": "i", "name": "marker", "ts": 1},
    ]
    return Reading(events, wall_us=100.0)


def test_busy_idle_and_breakdown():
    r = _trace()
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert r.busy_us() == 30
    data = {"profile": r, "profiled_units": 1}
    assert readings.idle_share_pct(data) == pytest.approx(70.0)
    assert r.top_device_ops(1) == [["conv3x3_mma_kernel<64>", 20e-6]]
    gaps = r.idle_gaps()
    assert gaps == [["outside spans / autograd::engine::evaluate_function: _FusedConvBackward",
                     20e-6]]


def test_attribution_to_the_launching_range():
    r = _trace()
    kernels = r.kernels()
    under = [d[0] for d in kernels if r.launched_under(d, "_FusedConvBackward")]
    assert under == ["conv3x3_mma_kernel<64>"]
    assert r.enclosing(8) == ["kmbench.backbone", "aten::sum"]
    reader = Cell("train-half-tps").reader("conv_bwd_ms.train")
    assert reader({"profile": r, "profiled_units": 2}) == pytest.approx(0.005)
    launches = Cell("train-half-tps").reader("launches_per_step.train")
    assert launches({"profile": r, "profiled_units": 2}) == 1.5


def test_conv_roofline_against_a_hand_count():
    plan, cin, vox = counts.conv_plan((32, 32, 32), 32, 4, 1)
    assert [c["name"] for c in plan] == ["e0c1", "e0c2", "e1c1", "e1c2", "e2c1", "e2c2",
                                         "e3c1", "e3c2", "d0c1", "d0c2", "d1c1", "d1c2"]
    d0c1 = plan[8]
    assert (d0c1["cin"], d0c1["cout"], d0c1["vox"], d0c1["lowres"]) == (384, 128, 8 ** 3, 256)
    assert (cin, vox) == (64, 16 ** 3)
    # d0c1 by hand: 2 * 27 * 384 * 128 * 512 operations; bytes: 128 channels of
    # the skip at 8^3 and 256 at 4^3 read, 27 * 384 * 128 weights, 128 out at 8^3
    assert counts.conv_flops(d0c1) == 2 * 27 * 384 * 128 * 512
    assert counts.conv_bytes(d0c1) == 2 * (128 * 512 + 256 * 64 + 27 * 384 * 128 + 128 * 512)
    r = _trace()
    bound = 1e-5  # two conv kernels of 10 us each: a 10-us bound a unit is 50%
    data = {"profile": r, "profiled_units": 2, "conv_calls_per_unit": 1,
            "conv_bound_s_per_unit": bound}
    assert readings.conv_roofline_pct(data) == pytest.approx(100.0 * 2 * bound / 20e-6)
    data["conv_calls_per_unit"] = 2  # the profile lacks calls the plan predicts
    assert readings.conv_roofline_pct(data) is None


def test_mfu_and_rates():
    data = {"units": 10, "window_s": 2.0, "flops_per_unit": 989e12 * 0.1, "unit": "step",
            "registrations": 70, "peak_bytes": 3 * 2 ** 30, "setup_s": 4.0}
    assert readings.mfu_pct(data) == pytest.approx(50.0)
    serve, train = Cell("serve-full-evalsweep"), Cell("train-half-tps")
    assert serve.reader("regs_per_s")(data) == 35.0
    assert train.reader("train_step_ms")(data) == 200.0
    assert train.reader("peak_mem_gib")(data) == 3.0
    assert readings.idle_share_pct({"profile": None, "profiled_units": 0}) is None


def test_flop_counts_match_the_ports_formula():
    """counts.extract_flops is tools/flops.py's unet_extract_flops."""
    got = counts.extract_flops((256, 256, 256), 128, 32, 4, 1)
    from keymorph_tpu_torch.tools import flops

    assert got == flops.unet_extract_flops((256, 256, 256), 128, 32, 4, 1)
