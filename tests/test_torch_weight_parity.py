"""Registration parity between the port and keymorph_tpu on the port's
TRAINED nets (``runs/torch_weight_parity/``, written by
``keymorph_tpu_torch.tools.weight_parity``).

The truth is keymorph_tpu's, in float64 (:class:`Float64KeyMorph`): the
committed weights go in through its unchanged
``tools/import_torch_weights.load_torch_backbone``, its backbone runs under
``jax.enable_x64`` on parameters cast to float64 (its 1x1 output conv, which
accumulates in fp32 whatever its dtype, is taken in float64 on its own
parameters), its centre-of-mass head reads the keypoints, and its fp32
alignment registers from them. keymorph_tpu's fp32 backbone is not the
truth: its GroupNorm on the CPU lies ~10x further from float64 than the
port's (the GroupNorm test below), so its fp32 keypoints lie further from
the float64 ones than the port's do (both printed in PARITY.md).

(a) For each config the port registers the held-out pair in fp32 on the
CPU (``weight_parity.port_register``), keymorph_tpu registers it from its
float64 keypoints, and keymorph_tpu's own ``weight_parity._compare`` reads
|dDice|, keypoint MSE and grid max|d| (the port as the reference side)
against flat bars from keymorph_tpu's readings against the torch reference
on trained weights (PARITY_WEIGHTS.md). The port's modules in float64 hold
to keymorph_tpu's float64 heatmaps and keypoints of the pair's fixed image
at float64's level.
(b) ``train_port``'s save format loads into keymorph_tpu, whose float64
heatmaps hold the port's.
(c) ``runs/torch_weight_parity/PARITY.md`` is what (a) reads, to the
printed digits: regenerate it with
``env PYTHONPATH=. python tests/test_torch_weight_parity.py``.

keymorph_tpu runs its plain XLA TPS route (``KM_NO_FAST_TPS=1``, its own
switch) rather than its Pallas TPS kernel in interpret mode, and initializes
its parameter tree on an 8^3 example before the import replaces every
backbone parameter (shapes do not depend on the image size): both only to
keep each test inside 90 s on one thread.
"""

import contextlib
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from keymorph_tpu.models import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu.models import UNet3D as JUNet3D
from keymorph_tpu.models.keymorph import KeyMorph as JKeyMorph
from keymorph_tpu.models.layers import center_of_mass as jcenter_of_mass
from keymorph_tpu.models.unet import PointwiseConv
from keymorph_tpu.tools import weight_parity as jwp
from keymorph_tpu.tools.import_torch_weights import load_torch_backbone
from keymorph_tpu_torch.models.layers import center_of_mass
from keymorph_tpu_torch.tools import weight_parity as wp

RUN = Path(__file__).resolve().parents[1] / "runs" / "torch_weight_parity"
REPORT = RUN / "PARITY.md"
NET = dict(num_keypoints=32, f_maps=8, num_levels=3)
EVAL_SIZE = 128                    # the truncated configs' held-out pair (--eval_size)
KP_MSE = 1e-9                      # keypoint MSE, the port's fp32 from keymorph_tpu's float64
FLOAT64_BAR = 1e-12                # the port's float64 heatmaps (x their max) and keypoints (MSE)
DICE_ABS = 1e-4
GRID_ABS = {"tps_0": 1e-3}         # normalized units; 2e-4 for the other aligns
GRID_ABS_DEFAULT = 2e-4
GRID_RW_TPS_ABS = 5e-3             # real-world TPS: the fp32 limit both packages share
TITLES = {
    "unet64": "UNet3D @ {size}^3",
    "truncatedunet128": "TruncatedUNet3D @ {eval_size}^3",
    "truncatedunet128_rw": "TruncatedUNet3D @ {eval_size}^3, REAL-WORLD coords (same weights, "
                           "anisotropic NIfTI affines)",
}


@contextlib.contextmanager
def _cpu_parity_route():
    """One torch thread; keymorph_tpu on its XLA TPS route."""
    n, env = torch.get_num_threads(), os.environ.get("KM_NO_FAST_TPS")
    torch.set_num_threads(1)
    os.environ["KM_NO_FAST_TPS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(n)
        if env is None:
            os.environ.pop("KM_NO_FAST_TPS")
        else:
            os.environ["KM_NO_FAST_TPS"] = env


def _float64_head(next_fun, args, kwargs, context):
    """keymorph_tpu's 1x1 output conv (``PointwiseConv``) accumulates in fp32
    whatever its dtype: in float64 here, on its own parameters."""
    if not (isinstance(context.module, PointwiseConv) and context.method_name == "__call__"):
        return next_fun(*args, **kwargs)
    (x,) = args
    p = context.module.variables["params"]
    return jnp.einsum("...c,ck->...k", x, p["kernel"].reshape(x.shape[-1], -1)) + p["bias"]


class Float64KeyMorph(JKeyMorph):
    """keymorph_tpu's ``KeyMorph`` whose keypoints come from its backbone in
    float64 and its centre-of-mass head; its alignment, fp32, registers from
    them. Each image's keypoints are computed once."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.computed = {}

    def float64_keypoints(self, img):
        """((B, *S', K) float64 heatmaps, (B, K, 3) fp32 keypoints) of a
        (B, 1, *S) image."""
        img = np.asarray(img, np.float32)
        key = (img.shape, img.tobytes())
        if key not in self.computed:
            with jax.enable_x64(True), fnn.intercept_methods(_float64_head):
                net = self.net.backbone.clone(dtype=jnp.float64)
                params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                      self.params["params"]["backbone"])
                x = jnp.moveaxis(jnp.asarray(img, jnp.float64), 1, -1)
                heat = jax.jit(lambda p, v: net.apply({"params": p}, v))(params, x)
                points = np.asarray(jcenter_of_mass(heat), np.float32)
            self.computed[key] = (np.asarray(heat), points)
        return self.computed[key]

    def _ensure_extract_jit(self):
        def extract(params, img_f, img_m):
            return (*(jnp.asarray(self.float64_keypoints(x)[1]) for x in (img_f, img_m)), None)

        return extract


def jax_float64_model(path, backbone, num_keypoints=NET["num_keypoints"], f_maps=NET["f_maps"],
                      num_levels=NET["num_levels"]):
    """A :class:`Float64KeyMorph` (eval mode) on the backbone file at
    ``path``, read by ``load_torch_backbone``."""
    kw = dict(out_channels=num_keypoints, f_maps=f_maps, num_levels=num_levels)
    net = (JTruncatedUNet3D(num_truncated_layers=1, **kw) if backbone == "truncatedunet"
           else JUNet3D(**kw))
    model = Float64KeyMorph(net, num_keypoints)
    x = jnp.zeros((1, 1, 8, 8, 8), jnp.float32)
    model.params = load_torch_backbone(str(path), jax.jit(model.net.init)(jax.random.PRNGKey(0), x, x))
    return model.eval()


def port_float64(path, backbone, imgs, num_keypoints=NET["num_keypoints"], f_maps=NET["f_maps"],
                 num_levels=NET["num_levels"]):
    """[((B, *S', K) float64 heatmaps, (B, K, 3) keypoints)] of each image,
    the port's modules and head on the backbone file at ``path`` in
    float64."""
    net = wp.build_backbone(num_keypoints, f_maps, num_levels, backbone, dtype=torch.float64)
    net.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["state_dict"])
    with torch.no_grad():
        heats = [net(torch.from_numpy(np.asarray(x)).double()).movedim(1, -1) for x in imgs]
    return [(h.numpy(), center_of_mass(h).numpy()) for h in heats]


@functools.lru_cache(maxsize=None)
def held_out():
    """``weight_parity.eval_pairs`` at the committed nets' size."""
    return wp.eval_pairs(wp.read_record(RUN, "unet")["size"], EVAL_SIZE)


@functools.lru_cache(maxsize=None)
def committed_jax_model(backbone):
    """:func:`jax_float64_model` on the committed ``backbone``, one for all
    its configs."""
    return jax_float64_model(RUN / wp.CHECKPOINTS[backbone], backbone)


@functools.lru_cache(maxsize=None)
def float64_readings(backbone):
    """On the held-out pair of ``backbone``'s configs: (the port's float64
    heatmaps' max|d| from keymorph_tpu's over their max and its float64
    keypoints' MSE from keymorph_tpu's, both of the fixed image;
    keymorph_tpu's fp32 keypoints' keypoint MSE from its float64 ones)."""
    config = "unet64" if backbone == "unet" else "truncatedunet128"
    imgs = held_out()[config][:2]
    jm = committed_jax_model(backbone)
    with _cpu_parity_route():
        truth = [jm.float64_keypoints(x) for x in imgs]
        port = port_float64(RUN / wp.CHECKPOINTS[backbone], backbone, imgs[:1])[0]
        jax32 = [np.asarray(jm.get_keypoints(jnp.asarray(x))) for x in imgs]
    heat = float(np.abs(port[0] - truth[0][0]).max() / np.abs(truth[0][0]).max())
    return (heat, float(np.mean((port[1] - truth[0][1]) ** 2)),
            sum(float(np.mean((j - t[1]) ** 2)) for j, t in zip(jax32, truth)))


@functools.lru_cache(maxsize=None)
def parity_rows(config):
    """keymorph_tpu's ``_compare`` rows of one config on the committed
    weights: (align, Dice port, Dice keymorph_tpu, |dDice|, keypoint MSE,
    grid max|d|), keymorph_tpu registering from its float64 keypoints."""
    backbone = wp.config_backbone(config)
    img_f, img_m, seg_f, seg_m, aff_f, aff_m = held_out()[config]
    jm = committed_jax_model(backbone)
    jm.align_keypoints_in_real_world_coords = aff_f is not None
    kwargs = {} if aff_f is None else {"aff_f": jnp.asarray(aff_f), "aff_m": jnp.asarray(aff_m)}
    with _cpu_parity_route():
        port = wp.load_port(RUN / wp.CHECKPOINTS[backbone], backbone=backbone, device="cpu", **NET)
        ref_res, ref_warp = wp.port_register(port, img_f, img_m, wp.ALIGNS, aff_f, aff_m)
        ours = jm(jnp.asarray(img_f), jnp.asarray(img_m), transform_type=list(wp.ALIGNS), **kwargs)
        return tuple(jwp._compare(config, ref_res, ref_warp, ours, seg_f, seg_m, wp.ALIGNS))


def _grid_bar(config, align):
    if config.endswith("_rw") and align.startswith("tps"):
        return GRID_RW_TPS_ABS
    return GRID_ABS.get(align, GRID_ABS_DEFAULT)


def render_report(rows, readings):
    """PARITY.md's text from the committed training records, the rows
    ({config: parity_rows(config)}) and the float64 readings ({backbone:
    float64_readings(backbone)})."""
    out = ["# Registration parity with keymorph_tpu on the port's trained weights", ""]
    for backbone in wp.CHECKPOINTS:
        rec = wp.read_record(RUN, backbone)
        where = f"on the card ({rec['card']})" if rec["card"] else f"on {rec['device']}"
        out.append(f"- `{wp.CHECKPOINTS[backbone]}`: {backbone}, {rec['num_keypoints']} "
                   f"keypoints, f_maps {rec['f_maps']}, {rec['num_levels']} levels, trained "
                   f"{rec['steps']} steps at {rec['size']}^3 {where}, "
                   f"{rec['ms_per_step_host_clock']:.1f} ms a step (host clock).")
    out += ["",
            "The port's KeyMorph was trained end to end (unsupervised MSE through the "
            "closed-form affine solve, Adam, random affine augmentation of the moving image) by "
            "`python -m keymorph_tpu_torch.tools.weight_parity`. keymorph_tpu imported each "
            "backbone with its `tools/import_torch_weights.load_torch_backbone` and is the "
            "truth in float64: its backbone under `jax.enable_x64` on parameters cast to float64 "
            "(its 1x1 output conv, fp32 by design, taken in float64 on its own parameters), its "
            "centre-of-mass head, then its fp32 alignment (XLA TPS route). The port registered "
            "the same held-out pairs in fp32 on the CPU, and keymorph_tpu's "
            "`weight_parity._compare` read the deltas (keypoint MSE: the port's fp32 keypoints "
            "against keymorph_tpu's float64 ones). Bars (tests/test_torch_weight_parity.py), "
            "flat: keypoint MSE 1e-9, |ΔDice| 1e-4, grid max|Δ| 2e-4 (tps_0: 1e-3; real-world "
            "TPS: 5e-3); the port's float64 heatmaps of the fixed image within 1e-12 of "
            "keymorph_tpu's (x their max) and its float64 keypoints within an MSE of 1e-12.",
            ""]
    for config, config_rows in rows.items():
        backbone = wp.config_backbone(config)
        rec = wp.read_record(RUN, backbone)
        heat, port64, jax32 = readings[backbone]
        title = TITLES[config].format(size=rec["size"], eval_size=EVAL_SIZE)
        losses = rec["losses"]
        out += [f"## {title} (trained {rec['steps']} steps at {rec['size']}^3, final MSE "
                f"{losses[-1]:.5f} from {losses[0]:.5f})", "",
                f"From keymorph_tpu's float64: the port's float64 heatmaps of the fixed image "
                f"{heat:.2e} (max|Δ| over max) and its keypoints {port64:.2e} (MSE); "
                f"keymorph_tpu's own fp32 keypoints {jax32:.2e} (keypoint MSE).", "",
                "| align | Dice (port) | Dice (keymorph_tpu) | |ΔDice| | keypoint MSE | "
                "grid max|Δ| |",
                "|---|---|---|---|---|---|"]
        out += [f"| {k} | {dt:.5f} | {dj:.5f} | {dd:.2e} | {km:.2e} | {gd:.2e} |"
                for k, dt, dj, dd, km, gd in config_rows]
        out.append("")
    out.append("Generated by `env PYTHONPATH=. python tests/test_torch_weight_parity.py`.")
    return "\n".join(out) + "\n"


def _report():
    return render_report({c: parity_rows(c) for c in wp.CONFIGS},
                         {b: float64_readings(b) for b in wp.CHECKPOINTS})


@pytest.mark.parametrize("config", wp.CONFIGS)
def test_registration_parity_on_trained_weights(config):
    """Every align of the config, the port in fp32 against keymorph_tpu
    registering from its float64 keypoints, within the flat bars: keypoint
    MSE KP_MSE, |dDice| DICE_ABS, grid max|d| 2e-4 (tps_0 1e-3, the
    real-world TPS rows GRID_RW_TPS_ABS). Each reading printed."""
    rows = parity_rows(config)
    assert [r[0] for r in rows] == list(wp.ALIGNS)
    for k, dt, dj, dd, km, gd in rows:
        bars = (DICE_ABS, KP_MSE, _grid_bar(config, k))
        print(f"{config} {k}: Dice port {dt!r} keymorph_tpu {dj!r}; |dDice| {dd!r}, keypoint MSE "
              f"{km!r}, grid max|d| {gd!r}; bars {bars}")
        assert 0.0 < dt < 1.0 and 0.0 < dj < 1.0
        assert dd <= bars[0] and km <= bars[1] and gd <= bars[2], k


@pytest.mark.parametrize("backbone", list(wp.CHECKPOINTS))
def test_float64_modules_match_keymorph_tpu_on_trained_weights(backbone):
    """On the held-out pair's fixed image, the port's modules and head in
    float64 against keymorph_tpu's float64 truth: heatmaps within
    FLOAT64_BAR x their max, keypoints within an MSE of FLOAT64_BAR
    (printed, with keymorph_tpu's own fp32 keypoints' distance from it)."""
    heat, port64, jax32 = float64_readings(backbone)
    print(f"{backbone}: from keymorph_tpu's float64: port float64 heatmaps {heat!r}, keypoints "
          f"{port64!r} (bar {FLOAT64_BAR}); keymorph_tpu fp32 keypoints {jax32!r}")
    assert heat <= FLOAT64_BAR and port64 <= FLOAT64_BAR


def test_groupnorm_statistics_on_the_cpu_against_float64():
    """Why keymorph_tpu's fp32 backbone is not the truth: keymorph_tpu's
    GroupNorm (flax ``nn.GroupNorm``, eps 1e-5, 8 groups of one channel) on
    a channel-last 64^3 x 8 activation of mean ~3.5 and std ~0.3 (a pooled
    ReLU output's shape), and the port's (``models.layers.GroupNorm``), each
    against the port's module in float64: the port's output lies at most a
    quarter of keymorph_tpu's distance from float64 (both printed; both
    compute E[x^2] - mean^2 in fp32, which costs the port ~1.4e-5 x max
    here)."""
    from keymorph_tpu_torch.models.layers import GroupNorm

    x = (3.0 + np.random.default_rng(4).random((1, 64, 64, 64, 8))).astype(np.float32)
    want = np.asarray(fnn.GroupNorm(num_groups=8, epsilon=1e-5).apply(
        {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}}, jnp.asarray(x)))
    xt = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad():
        got = GroupNorm(8, 8)(xt).movedim(1, -1).numpy()
        truth = GroupNorm(8, 8, dtype=torch.float64).double()(xt.double()).movedim(1, -1).numpy()
    top = float(np.abs(truth).max())
    d_port, d_jax = (float(np.abs(a - truth).max()) for a in (got, want))
    print(f"GroupNorm from float64 (max {top!r}): port {d_port!r}, keymorph_tpu {d_jax!r}")
    assert d_port <= 0.25 * d_jax


def test_train_port_save_format_loads_into_keymorph_tpu(tmp_path):
    """``train_port`` for 3 steps at 32^3 on the CPU (the parity nets' width:
    keymorph_tpu's UNet3D groups its norms by 8, ``train_port`` by ``min(8,
    f_maps)``, as the reference's harness does): every loss finite; the
    saved backbone loads into keymorph_tpu through ``load_torch_backbone``;
    on one seeded input the port's fp32 heatmaps lie within 1e-5 x their max
    of keymorph_tpu's float64 ones, and the port's float64 heatmaps within
    FLOAT64_BAR x their max."""
    imgs, _ = wp.make_subjects(n_subjects=4, size=32, seed=5)
    with _cpu_parity_route():
        model, losses = wp.train_port(imgs, 3, 8, NET["f_maps"], 3, 1e-3, device="cpu",
                                      log_every=0)
        assert len(losses) == 3 and np.all(np.isfinite(losses))
        path = tmp_path / "net.pt"
        wp.save_backbone(model, path)
        x = np.random.default_rng(11).random((1, 1, 32, 32, 32), dtype=np.float32)
        truth = jax_float64_model(path, "unet", num_keypoints=8).float64_keypoints(x)[0]
        port = wp.load_port(path, 8, NET["f_maps"], 3, device="cpu")
        with torch.no_grad():
            got = port.get_keypoints(x, return_feat=True)[1].numpy()
        got64 = port_float64(path, "unet", [x], num_keypoints=8)[0][0]
    top = float(np.abs(truth).max())
    d, d64 = (float(np.abs(a - truth).max()) for a in (got, got64))
    print(f"heatmaps (max {top!r}) from keymorph_tpu's float64: port fp32 {d!r}, port float64 "
          f"{d64!r}")
    assert got.shape == truth.shape and d <= 1e-5 * top and d64 <= FLOAT64_BAR * top


def test_parity_report_matches_the_weights():
    """PARITY.md is the report of (a)'s readings on the committed weights,
    character for character."""
    assert REPORT.read_text() == _report()


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    REPORT.write_text(_report())
    print(f"wrote {REPORT}")
