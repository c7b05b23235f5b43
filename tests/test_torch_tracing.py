"""The port's spans (keymorph_tpu_torch/tracing.py) on the CPU: nothing is
built with the profiler off; under ``torch.profiler`` a serving request
and a training step record every ``km.*`` span where it belongs; and
``KeyMorph``'s time fields come from one wait per call."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keymorph_tpu_torch import tracing
from keymorph_tpu_torch.models import keymorph
from keymorph_tpu_torch.models.keymorph import KeyMorph, KeyMorphNet, align_pair
from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
from keymorph_tpu_torch.ops import resample
from keymorph_tpu_torch.training import train
from keymorph_tpu_torch.training.config import Config

K = 8
SPATIAL = (32, 32, 32)
CFG = dict(out_channels=K, f_maps=4, num_levels=4, num_truncated_layers=1)
SERVING_SPANS = {"km.backbone", "km.unet.pool", "km.unet.final", "km.head", "km.align",
                 "km.align.fit", "km.align.flow", "km.warp"}
# span -> the span every occurrence of it lies inside
PARENT = {"km.unet.pool": "km.backbone", "km.unet.final": "km.backbone",
          "km.align.fit": "km.align", "km.align.flow": "km.align"}
TRAIN_PARENT = dict(PARENT, **{"km.backbone": "km.train.extract", "km.head": "km.train.extract",
                               "km.conv.recompute": "km.train.backward",
                               "km.conv.input_grad": "km.train.backward",
                               "km.conv.weight_grad": "km.train.backward"})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net():
    gen = torch.Generator().manual_seed(0)
    return KeyMorphNet(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **CFG), gen), K)


def _volume(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((1, 1, *SPATIAL), generator=g)


def _ranges(prof, prefix="km."):
    """[(name, start us, end us)] of the profile's host ranges named ``prefix*``."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix)]


def _assert_nested(ranges, parent_of):
    for name, s, e in ranges:
        parent = parent_of.get(name)
        if parent is not None:
            assert any(n == parent and ps <= s and e <= pe for n, ps, pe in ranges), (name, parent)


def test_span_builds_nothing_with_the_profiler_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("backbone") is tracing.span("align.fit")
    with tracing.span("backbone"):
        pass
    with torch.no_grad():  # a request runs every span of the serving path
        net = _net()
        feat = net.features(_volume(0))
        points = net.keypoints_from_features(feat)
        planes = align_pair(points, points, "affine", SPATIAL, compute_grid="planes")["planes"]
        resample.align_planes(planes, _volume(1))


def test_span_records_km_ranges_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("align"):
            with tracing.span("align.fit"):
                torch.ones(4).sum()
    names = [n for n, _, _ in _ranges(prof)]
    assert sorted(names) == ["km.align", "km.align.fit"]
    _assert_nested(_ranges(prof), PARENT)


def test_serving_request_records_every_serving_span():
    """The benchmark's serving call sequence: both extractions (features, then
    the centre of mass), then each transform's fit and planes and its warp."""
    net = _net()
    img_f, img_m = _volume(0), _volume(1)
    lm = torch.full((1,), 1.0)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        points = [net.keypoints_from_features(net.features(img)) for img in (img_f, img_m)]
        for kind, lmbda in (("tps", lm), ("affine", None)):
            planes = align_pair(points[0], points[1], kind, SPATIAL, lmbda=lmbda,
                                compute_grid="planes")["planes"]
            resample.align_planes(planes, img_m)
    ranges = _ranges(prof)
    counts = {n: sum(1 for r in ranges if r[0] == n) for n in SERVING_SPANS}
    # 4 levels: 3 pools a volume; one fit and one flow a transform
    assert counts == {"km.backbone": 2, "km.unet.pool": 6, "km.unet.final": 2, "km.head": 2,
                      "km.align": 2, "km.align.fit": 2, "km.align.flow": 2, "km.warp": 2}
    _assert_nested(ranges, PARENT)
    # the fit and the flow do not overlap
    fits = [r for r in ranges if r[0] == "km.align.fit"]
    flows = [r for r in ranges if r[0] == "km.align.flow"]
    assert all(f[2] <= g[1] for f, g in zip(fits, flows))


def test_train_step_records_its_phases_and_the_conv_backward():
    net = _net()
    cfg = Config(num_keypoints=K, max_train_keypoints=6, transform_type="tps_loguniform",
                 loss_fn="mse", lr=1e-4, img_size=SPATIAL, use_amp=True,
                 max_random_affine_augment_params=(0.2, 0.2, 3.1416, 0.1))
    state = train.TrainState.create(net, train.make_optimizer(cfg, net))
    step = train.make_train_step(net, cfg)
    gen = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, gen, _volume(0), _volume(1), None, None, 1.0)
    assert torch.isfinite(metrics["loss"])
    ranges = _ranges(prof)
    names = {n for n, _, _ in ranges}
    assert {"km.train.augment", "km.train.extract", "km.train.loss", "km.train.backward",
            "km.train.optimizer", "km.align", "km.align.fit", "km.align.flow"} <= names
    for phase in ("augment", "extract", "loss", "backward", "optimizer"):
        assert sum(1 for n, _, _ in ranges if n == f"km.train.{phase}") == 1, phase
    nodes = [r for r in _ranges(prof, "_FusedConvBackward")]
    assert len(nodes) == 2 * 2 * (2 * CFG["num_levels"] - 1 - CFG["num_truncated_layers"])
    for span in ("km.conv.recompute", "km.conv.input_grad", "km.conv.weight_grad"):
        mine = [r for r in ranges if r[0] == span]
        assert len(mine) == len(nodes), span
        # one inside each backward node
        assert all(sum(1 for _, s, e in mine if ns <= s and e <= ne) == 1
                   for _, ns, ne in nodes), span
    _assert_nested(ranges, TRAIN_PARENT)


class _CountingTimer(tracing.StageTimer):
    waits = 0

    def wait(self):
        type(self).waits += 1
        super().wait()


@pytest.mark.parametrize("types", [["affine"], ["rigid", "affine", "tps_1", "tps_0.1"]])
def test_keymorph_forward_waits_once(monkeypatch, types):
    monkeypatch.setattr(keymorph, "StageTimer", _CountingTimer)
    monkeypatch.setattr(_CountingTimer, "waits", 0)
    model = KeyMorph(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **CFG),
                                  torch.Generator().manual_seed(0)), K, device="cpu")
    rng = np.random.default_rng(0)
    img_f, img_m = (rng.random((1, 1, *SPATIAL)).astype(np.float32) for _ in range(2))
    result = model(img_f, img_m, transform_type=types)
    assert _CountingTimer.waits == 1
    assert list(result) == types
    for res in result.values():
        fields = [res[k] for k in ("time_keypoint_extract", "time_align", "time")]
        assert all(isinstance(v, float) and v >= 0.0 for v in fields)
        assert res["time"] == res["time_keypoint_extract"] + res["time_align"]


def test_groupwise_register_waits_once(monkeypatch):
    monkeypatch.setattr(keymorph, "StageTimer", _CountingTimer)
    monkeypatch.setattr(_CountingTimer, "waits", 0)
    model = KeyMorph(init_weights(TruncatedUNet3D(dtype=torch.bfloat16, **CFG),
                                  torch.Generator().manual_seed(0)), K, device="cpu")
    subjects = torch.stack([_volume(i)[0] for i in range(3)])
    result = model.groupwise_register(subjects, transform_type=["affine", "tps_1"], num_iters=2)
    assert _CountingTimer.waits == 1
    assert all(isinstance(r["time"], float) and r["time"] >= 0.0 for r in result.values())
