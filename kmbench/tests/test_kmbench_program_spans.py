"""The readings of the program's ``km.*`` spans (``kmbench/program_spans.py``)
against hand counts on a synthetic trace, each of their metrics, and a CPU
traced run, whose profile holds no device operation: the metrics are left
out there, not reported as 0."""

import pytest

from kmbench import program_spans, run
from kmbench.program_spans import device_ms, idle_ms
from kmbench.registry import Cell
from kmbench.trace import Reading

NEW = {  # metric: (cell, span, reading, units a profiled request or step)
    "pool_ms.serve": ("serve-full-tps1", "unet.pool", device_ms, 2),
    "final_conv_ms.serve": ("serve-full-tps1", "unet.final", device_ms, 2),
    "fit_ms.serve": ("serve-full-evalsweep", "align.fit", device_ms, 1),
    "flow_ms.serve": ("serve-full-evalsweep", "align.flow", device_ms, 1),
    "align_idle_ms.serve": ("serve-full-tps1", "align", idle_ms, 1),
    "weight_grad_ms.train": ("train-half-tps", "conv.weight_grad", device_ms, 1),
    "backward_idle_ms.train": ("train-half-tps", "train.backward", idle_ms, 1),
    "augment_idle_ms.train": ("train-half-tps", "train.augment", idle_ms, 1),
    "optimizer_ms.train": ("train-half-tps", "train.optimizer", device_ms, 1),
}


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1):
    return x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr)


def kernel(start, end, corr):
    return x("kernel", f"k{corr}", start, end - start, tid=99, corr=corr)


def _trace():
    """Thread 1: ``km.align`` (0-60) with a fit (5-20) and a flow (30-50)
    inside, a launch outside any span (80), then ``km.train.backward``
    (100-200); thread 2 (autograd's): ``km.conv.weight_grad`` (120-150).
    Device (us): 12-20 fit, 36-46 flow, 56-58 align, 81-90 outside,
    126-140 weight gradient, 141-144 launched by thread 1 inside the
    backward while thread 2's span is open, 161-171 launched by thread 2
    outside its own spans."""
    events = [
        x("user_annotation", "km.align", 0, 60),
        x("user_annotation", "km.align.fit", 5, 15),
        x("user_annotation", "km.align.flow", 30, 20),
        x("user_annotation", "km.train.backward", 100, 100),
        x("user_annotation", "km.conv.weight_grad", 120, 30, tid=2),
        x("cpu_op", "aten::mm", 8, 4),
        launch(10, 1), launch(35, 2), launch(55, 3), launch(80, 4),
        launch(125, 5, tid=2), launch(132, 7), launch(160, 6, tid=2),
        kernel(12, 20, 1), kernel(36, 46, 2), kernel(56, 58, 3), kernel(81, 90, 4),
        kernel(126, 140, 5), kernel(141, 144, 7), kernel(161, 171, 6),
    ]
    return Reading(events, wall_us=200.0)


def test_device_time_by_span_nested_and_across_threads():
    r = _trace()
    assert device_ms(r, "align") == pytest.approx(0.020)
    assert device_ms(r, "align.fit") == pytest.approx(0.008)
    assert device_ms(r, "align.flow") == pytest.approx(0.010)
    # thread 2's span lies within thread 1's backward; thread 2's launch
    # outside its own span falls to the backward, thread 1's stays its own
    assert device_ms(r, "conv.weight_grad") == pytest.approx(0.014)
    assert device_ms(r, "train.backward") == pytest.approx(0.027)


def test_idle_gaps_by_span():
    r = _trace()
    assert idle_ms(r, "align") == pytest.approx(0.026)  # 20-36 and 46-56
    assert idle_ms(r, "align.fit") == 0.0  # its op is the first: a range, no gap
    assert idle_ms(r, "conv.weight_grad") == pytest.approx(0.036)
    assert idle_ms(r, "train.backward") == pytest.approx(0.054)  # 90-126, 140-141, 144-161


def test_a_span_the_profile_lacks_reads_none():
    r = _trace()
    for span in ("train.augment", "unet.pool", "align.fi", "kmbench.align"):
        assert device_ms(r, span) is None and idle_ms(r, span) is None
    assert device_ms(Reading([], wall_us=1.0), "align") is None


def _one_span(span):
    """Thread 1 launches a 10-us kernel outside any span, then one of 6 us
    inside ``km.<span>``, 20 us after the first ended."""
    return Reading([kernel(0, 10, 1), launch(1, 1), x("user_annotation", f"km.{span}", 20, 20),
                    launch(25, 2), kernel(30, 36, 2)], wall_us=50.0)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_reader(metric):
    cell, span, reading, per = NEW[metric]
    c = Cell(cell)
    assert metric in {m["name"] for m in c.per_layer()}
    entry = next(m for m in c.bench["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    read = c.reader(metric)
    data = {"unit": "step" if cell.startswith("train") else "request", "profiled_units": 2,
            "profile": _one_span(span)}
    want = (0.006 if reading is device_ms else 0.020) / (2 * per)
    assert read(data) == pytest.approx(want)
    assert read(dict(data, profile=_one_span("other"))) is None
    assert read(dict(data, profile=None)) is None


def test_each_op_falls_inside_the_spans_around_its_range():
    names, ops = program_spans._attribution(_trace())
    assert names == {"km.align", "km.align.fit", "km.align.flow", "km.train.backward",
                     "km.conv.weight_grad"}
    inside = {d[0]: set(s) for d, s in ops}
    assert inside["k4"] == set()
    assert inside["k5"] == {"km.conv.weight_grad", "km.train.backward"}
    assert inside["k6"] == inside["k7"] == {"km.train.backward"}


@pytest.mark.parametrize("cell", ["serve-full-tps1", "train-half-tps"])
def test_cpu_traced_run_leaves_the_new_metrics_out(cell, small):
    result, _ = run.execute(cell, 2 ** 31 + 11, 0.3, 1, device="cpu", config=small)
    assert not set(NEW) & set(result["metrics"])
