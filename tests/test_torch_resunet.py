"""The residual U-Nets' serving executor (``models/fast_resunet.py``) on the
CPU: its plain route against the bf16 modules and the benchmark's plain
reference (``kmbench/reference/resunet_se.py``), the route
``KeyMorphNet.features`` takes, and the backbones the predicate refuses.

A random-weight bf16 net is held to its own rounding: the bf16 module's
distance from the same module in float64 is the yardstick, and every sound
bf16 computation of the net (the executor, the module, the reference) lies
within it of each other. They differ by bf16 rounding flips only (GroupNorm
folded into the conv against normalize-then-affine, fp32 sums in other
orders), which the scSE gate's global squeeze spreads over whole channels.
The reference with fp8 conv operands lies several yardsticks away.
"""

import pytest
import torch
import torch.nn.functional as F

from keymorph_tpu_torch.models import fast_resunet
from keymorph_tpu_torch.models.fast_resunet import fast_resunet_forward
from keymorph_tpu_torch.models.fast_unet import _single_conv_operands
from keymorph_tpu_torch.models.keymorph import KeyMorphNet
from keymorph_tpu_torch.models.layers import center_of_mass
from keymorph_tpu_torch.models.unet import (ResidualUNet3D, ResidualUNetSE3D, ResNetBlock,
                                            TransposeConvUpsampling, TruncatedUNet3D,
                                            init_weights, supports_fast_resunet)
from keymorph_tpu_torch.ops import cuda as kernels
from keymorph_tpu_torch.ops.cuda import conv3d
from kmbench import inputs
from kmbench.reference import resunet_se
from kmbench.reference.precision import REFERENCE, Precision, store

K, F_MAPS, LEVELS, SIZE = 8, 4, 3, 32
KINDS = {"resnetse": (ResidualUNetSE3D, True), "resnet": (ResidualUNet3D, False)}


def _nets(kind, seed=0):
    """(bf16 net, float64 net, weights, volume) from the benchmark's draws."""
    cls, se = KINDS[kind]
    w = inputs.make_weights(seed, resunet_se.param_specs(F_MAPS, LEVELS, K, se=se), "cpu")
    net = cls(K, f_maps=F_MAPS, num_levels=LEVELS, dtype=torch.bfloat16)
    net.load_state_dict(w, strict=True)
    n64 = cls(K, f_maps=F_MAPS, num_levels=LEVELS, dtype=torch.float64).double()
    n64.load_state_dict(w, strict=True)
    return net, n64, w, inputs.make_pool(seed, 1, SIZE, "cpu")


def _reference_heatmaps(w, img, prec):
    """The reference's heatmaps, channel-last, whole (a 32^3 volume)."""
    x = resunet_se.features(w, img, LEVELS, prec)
    heat = store(F.conv3d(prec.conv_operand(x), prec.conv_operand(w["final_conv.weight"]))
                 + w["final_conv.bias"].reshape(1, -1, 1, 1, 1))
    return heat.movedim(1, -1)


def _gap(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_executor_module_and_reference_agree(kind):
    """Heatmaps and keypoints of the executor's plain route, the bf16
    module and the reference lie within the module's distance from float64
    of each other (the module docstring's yardstick)."""
    net, n64, w, img = _nets(kind)
    with torch.no_grad():
        exe = fast_resunet_forward(net, img)
        mod = net(img).movedim(1, -1)
        f64 = n64(img.double()).movedim(1, -1)
        ref = _reference_heatmaps(w, img, REFERENCE)
        kref = resunet_se.keypoints(w, img, LEVELS, REFERENCE)
    assert exe.dtype == torch.bfloat16 and exe.shape == (1, SIZE, SIZE, SIZE, K)
    heat_bar = _gap(mod, f64)
    k_exe, k_mod, k_64 = center_of_mass(exe), center_of_mass(mod), center_of_mass(f64).float()
    kp_bar = _gap(k_mod, k_64)
    assert 0 < heat_bar and 0 < kp_bar
    assert _gap(exe, mod) <= heat_bar and _gap(ref, mod) <= heat_bar and _gap(ref, exe) <= heat_bar
    assert _gap(k_exe, k_mod) <= kp_bar and _gap(kref, k_mod) <= kp_bar
    assert _gap(kref, k_exe) <= kp_bar
    # the reference's slab-by-slab centre of mass is the whole volume's
    assert _gap(kref, center_of_mass(ref)) <= 1e-6


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fp8_convs_fail_the_yardstick(kind):
    """The reference with fp8 (e4m3) conv operands: its keypoints lie more
    than twice the yardstick from the executor's, so a check at the
    yardstick rejects it."""
    net, n64, w, img = _nets(kind)
    with torch.no_grad():
        k_exe = center_of_mass(fast_resunet_forward(net, img))
        k_mod = center_of_mass(net(img).movedim(1, -1))
        k_64 = center_of_mass(n64(img.double()).movedim(1, -1)).float()
        k8 = resunet_se.keypoints(w, img, LEVELS, Precision("fp8", "fp32"))
    assert _gap(k8, k_exe) > 2 * _gap(k_mod, k_64)


def test_features_takes_the_executor_only_without_grad():
    """``KeyMorphNet.features`` serves a bf16 'gcr' residual net through the
    executor under ``torch.no_grad()`` (its plain versions count calls on
    the CPU) and through the module's forward with grad enabled (training:
    no executor call, a differentiable output)."""
    net, _, _, img = _nets("resnetse")
    km = KeyMorphNet(net, K)
    kernels.reset_counters()
    with torch.no_grad():
        served = km.features(img)
    counts = kernels.counters()
    assert counts["conv3x3_fused_flat_res"]["plain_calls"] == 2 * LEVELS - 1
    assert counts["conv_transpose3x3s2_flat"]["plain_calls"] == LEVELS - 1
    assert counts["scse_gate_flat"]["plain_calls"] == 2 * LEVELS - 1
    assert served.is_contiguous() and served.shape == (1, SIZE, SIZE, SIZE, K)
    kernels.reset_counters()
    trained = km.features(img)
    assert trained.requires_grad
    assert all(c["plain_calls"] == 0 for c in kernels.counters().values())
    assert torch.equal(trained.detach(), net(img).movedim(1, -1).detach())


def test_predicate_refuses_other_backbones():
    """A 'cr' or fp32 residual net, one with an encoder that keeps its width
    (no lift, from a list ``f_maps``) and the DoubleConv nets are refused:
    ``fast_resunet_forward`` raises before any conv, and ``features``
    takes the module's forward for the residual ones."""
    img = inputs.make_pool(1, 1, 16, "cpu")
    refused = (ResidualUNet3D(K, f_maps=F_MAPS, num_levels=2, layer_order="cr",
                              dtype=torch.bfloat16),
               ResidualUNetSE3D(K, f_maps=F_MAPS, num_levels=2, dtype=torch.float32),
               ResidualUNet3D(K, f_maps=[F_MAPS, F_MAPS], dtype=torch.bfloat16),
               TruncatedUNet3D(K, f_maps=F_MAPS, num_levels=2, dtype=torch.bfloat16))
    assert supports_fast_resunet(_nets("resnet")[0]) and supports_fast_resunet(_nets("resnetse")[0])
    kernels.reset_counters()
    for backbone in refused:
        assert not supports_fast_resunet(backbone)
        with pytest.raises(ValueError, match="residual executor runs bf16 'gcr'"):
            fast_resunet_forward(backbone, img)
    with torch.no_grad():
        for backbone in refused[:3]:
            KeyMorphNet(backbone, K).features(img)
    assert all(c["launches"] == 0 and c["plain_calls"] == 0
               for c in kernels.counters().values())


def test_final_conv_bias_on_the_k_axis():
    """The card's final conv carries the fp32 bias as three bf16 terms on
    columns of ones of a bf16 matmul; on the CPU (bf16 operands, fp32 sums,
    one rounding) it lands within one bf16 ulp of the fp32 matmul route, and
    the three terms sum to the bias within 2^-24 of it."""
    torch.manual_seed(0)
    conv = torch.nn.Conv3d(12, 40, 1)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(40) * 3.0)
    xf = torch.randn((5, 12, 6 * 7)).to(torch.bfloat16)
    a = torch.empty((5, 6, 7, 40), dtype=torch.bfloat16)
    b = torch.empty_like(a)
    with torch.no_grad():
        fast_resunet._final_conv(xf, (5, 6, 7), conv, a, mma=True)
        fast_resunet._final_conv(xf, (5, 6, 7), conv, b, mma=False)
    af, bf = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(af.abs(), bf.abs()))
    assert bool(((af - bf).abs() <= torch.ldexp(torch.ones_like(af), e - 8)).all())
    hb = conv.bias.detach().float()
    hi = hb.to(torch.bfloat16).float()
    mid = (hb - hi).to(torch.bfloat16).float()
    lo = (hb - hi - mid).to(torch.bfloat16).float()
    assert bool(((hi + mid + lo - hb).abs() <= 2 ** -24 * hb.abs()).all())


def test_odd_skips_are_refused_as_the_module_refuses():
    """A volume whose halving leaves an odd skip cannot join the transposed
    conv's output: the executor raises as the module does."""
    net = _nets("resnet")[0]
    img = torch.rand((1, 1, 18, 16, 16))
    with torch.no_grad(), pytest.raises(ValueError, match="cannot join the skip"):
        net(img)
    with torch.no_grad(), pytest.raises(ValueError, match="cannot join the skip"):
        fast_resunet_forward(net, img)


def _flat(t):
    """(1, C, Z, Y, X) -> the executor's flat (Z, C, Y*X)."""
    return t[0].transpose(0, 1).reshape(t.shape[2], t.shape[1], -1).contiguous()


def _module_pair(cls, *args):
    """A bf16 module with random weights (biases and norm affines moved off
    their init) and the same module in float64."""
    gen = torch.Generator().manual_seed(1)
    m = init_weights(cls(*args, dtype=torch.bfloat16), gen)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    m64 = cls(*args, dtype=torch.float64).double()
    m64.load_state_dict(m.state_dict())
    return m, m64


@pytest.mark.parametrize("form", ["res", "tconv"])
def test_form_plain_matches_its_module(form):
    """Each serving form's plain version against the port's module on the
    same bf16 operands: the residual form against a ``ResNetBlock``'s last
    conv (``conv3``: GroupNorm, conv), the residual sum and the ReLU; the
    transposed form against ``TransposeConvUpsampling`` (its
    ``ConvTranspose3d``, the skip sum). Within the module's distance from
    float64 (the yardstick of test_executor_module_and_reference_agree), and
    counted as one plain call."""
    C, spatial = 16, (6, 8, 10)
    gen = torch.Generator().manual_seed(2)
    kernels.reset_counters()
    with torch.no_grad():
        if form == "res":
            block, b64 = _module_pair(ResNetBlock, C, C)
            x = torch.randn((1, C, *spatial), generator=gen).to(torch.bfloat16)
            y = block.conv2(x)  # the last conv's input, as the module computes it
            mod = torch.relu(block.conv3(y) + x)
            f64 = torch.relu(b64.conv3(y.double()) + x.double())
            w, sc, sh, _ = _single_conv_operands(block.conv3, conv3d.channel_stats(_flat(y)), 8)
            got = conv3d.conv3x3_fused_flat_res_plain(_flat(y), spatial, w, sc, sh, None,
                                                      residual=_flat(x))
            name = "conv3x3_fused_flat_res"
        else:
            up, u64 = _module_pair(TransposeConvUpsampling, C, C // 2)
            x = torch.randn((1, C, *(s // 2 for s in spatial)), generator=gen).to(torch.bfloat16)
            skip = torch.randn((1, C // 2, *spatial), generator=gen).to(torch.bfloat16)
            mod, f64 = up(skip, x), u64(skip.double(), x.double())
            t = up.upsample
            got = conv3d.conv_transpose3x3s2_flat_plain(_flat(x), spatial, t.weight,
                                                        t.bias.to(torch.bfloat16).float(),
                                                        skip=_flat(skip))
            name = "conv_transpose3x3s2_flat"
    bar = _gap(mod, f64)
    assert got.dtype == torch.bfloat16 and 0 < bar
    assert _gap(got, _flat(mod)) <= bar
    counts = kernels.counters()
    assert counts[name] == {"launches": 0, "plain_calls": 1}
    assert sum(c["plain_calls"] for c in counts.values()) == 1


@pytest.mark.parametrize("form", ["res", "tconv"])
def test_forms_refuse_grad_requiring_inputs(form):
    """Both serving forms are forward-only: with grad enabled, a source that
    requires grad raises the forward-only RuntimeError before any work (no
    plain call is counted); under no_grad the same call runs."""
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16, requires_grad=True)
    if form == "res":
        name = "conv3x3_fused_flat_res"
        def call():
            return conv3d.conv3x3_fused_flat_res(x, (2, 4, 4), torch.zeros((3, 3, 3, 8, 8)),
                                                 residual=x.detach())
    else:
        name = "conv_transpose3x3s2_flat"
        def call():
            return conv3d.conv_transpose3x3s2_flat(x, (4, 8, 8), torch.zeros((8, 4, 3, 3, 3)))
    kernels.reset_counters()
    with pytest.raises(RuntimeError, match=f"{name} is forward-only"):
        call()
    assert all(c["plain_calls"] == 0 for c in kernels.counters().values())
    with torch.no_grad():
        call()
    assert kernels.counters()[name]["plain_calls"] == 1

