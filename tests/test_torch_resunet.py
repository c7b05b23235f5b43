"""The residual U-Nets' executor (``models/fast_resunet.py``) on the CPU: its
plain route against the bf16 modules and the benchmark's plain references
(``kmbench/reference/resunet_se.py``, ``train_resunet.py``), forward and
backward, the route ``KeyMorphNet.features`` takes, the backward of each form
against autograd of its equations, and the backbones the predicate refuses.

A random-weight bf16 net is held to its own rounding: the bf16 module's
distance from the same module in float64 is the yardstick, and every sound
bf16 computation of the net (the executor, the module, the reference) lies
within it of each other. They differ by bf16 rounding flips only (GroupNorm
folded into the conv against normalize-then-affine, fp32 sums in other
orders), which the scSE gate's global squeeze spreads over whole channels.
The reference with fp8 conv operands lies several yardsticks away.

Gradients likewise: every sound bf16 computation of the net's gradient (the
executor, the module, the reference) lies within the bf16 module's distance
from the float64 module's gradient of each other (relative L2 over all
leaves: 0.22-0.30 at these sizes, each from the others 0.03-0.11), and the
training step's within the reference's own distance from itself on weights
nudged by half a bf16 ulp (0.15-0.25; the program 0.01-0.08 from it). fp8
conv operands move the gradient by 0.44-1.06 of its norm.
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
from keymorph_tpu_torch.ops.cuda import conv3d, heatmap, resblock
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
    """``KeyMorphNet.features`` runs a bf16 'gcr' residual net through the
    executor under ``torch.no_grad()`` (serving; its plain versions count
    calls on the CPU) and with grad enabled (training: the same calls and a
    differentiable output, equal to the served heatmaps; its pool is then
    the differentiable reshape-and-amax), and an fp32 or a
    'cr' residual net through its module's forward with grad enabled (no
    executor call)."""
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
    # the pool under autograd is the uncounted reshape-and-amax
    assert kernels.counters() == dict(counts, maxpool2_flat={"launches": 0, "plain_calls": 0})
    assert torch.equal(trained.detach(), served)
    for module in (ResidualUNetSE3D(K, f_maps=F_MAPS, num_levels=2, dtype=torch.float32),
                   ResidualUNet3D(K, f_maps=F_MAPS, num_levels=2, layer_order="cr",
                                  dtype=torch.bfloat16)):
        kernels.reset_counters()
        out = KeyMorphNet(module, K).features(img[..., :16, :16, :16])
        assert out.requires_grad
        assert all(c["plain_calls"] == 0 for c in kernels.counters().values())
        assert torch.equal(out.detach(), module(img[..., :16, :16, :16]).movedim(1, -1).detach())


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


def _old_doubleconv_final(xf, spatial, conv):
    """The DoubleConv executor's serving final conv before the kernel: one
    fp32 matmul of the whole volume, the fp32 bias, one rounding."""
    hw = conv.weight[:, :, 0, 0, 0].t().to(torch.bfloat16).float()
    hb = conv.bias.float()
    out = torch.matmul(xf.float().transpose(1, 2), hw) + hb
    return out.reshape(*spatial, -1).to(torch.bfloat16)


def _old_residual_final(xf, spatial, conv, slab_elems):
    """The residual executor's plain final conv before the kernel: the same
    in Z-slabs of at most ``slab_elems`` fp32 products."""
    Z, _, N = xf.shape
    K = conv.weight.shape[0]
    wf = conv.weight[:, :, 0, 0, 0].t().to(torch.bfloat16).float()
    hb = conv.bias.float()
    out = torch.empty((*spatial, K), dtype=torch.bfloat16)
    n = max(1, slab_elems // (K * N))
    for z0 in range(0, Z, n):
        y = torch.matmul(xf[z0:z0 + n].float().transpose(1, 2), wf) + hb
        out[z0:z0 + n] = y.reshape(-1, *spatial[1:], K).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("cin,k,spatial", [(1, 5, (3, 5, 7)), (16, 128, (4, 6, 11)),
                                           (32, 256, (2, 9, 13)), (40, 300, (5, 3, 11))])
def test_final_conv1x1_plain_is_both_executors_old_form(monkeypatch, cin, k, spatial):
    """``heatmap.final_conv1x1_plain``, the final conv's plain version for
    both executors, equals bit for bit the DoubleConv executor's former
    whole-volume fp32 form and the residual executor's former slab form
    (fp32 weights rounded to bf16, the fp32 bias, one rounding), in one slab
    and in slabs of one plane; planes of 33 to 117 voxels, ragged against the
    kernel's 32-voxel tiles. On the CPU the wrapper runs it, counted."""
    gen = torch.Generator().manual_seed(cin * 1000 + k)
    conv = torch.nn.Conv3d(cin, k, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / cin ** 0.5)
        conv.bias.copy_(torch.randn(k, generator=gen) * 3.0)
    Z, Y, X = spatial
    xf = torch.randn((Z, cin, Y * X), generator=gen).to(torch.bfloat16)
    w2, b = conv.weight.detach()[:, :, 0, 0, 0], conv.bias.detach()
    whole = _old_doubleconv_final(xf, spatial, conv).detach()
    for slab_elems in (heatmap.SLAB_ELEMS, k * Y * X):
        monkeypatch.setattr(heatmap, "SLAB_ELEMS", slab_elems)
        out = torch.full((*spatial, k), float("nan"), dtype=torch.bfloat16)
        assert heatmap.final_conv1x1_plain(xf, spatial, w2, b, out) is out
        assert torch.equal(out, whole)
        assert torch.equal(out, _old_residual_final(xf, spatial, conv, slab_elems).detach())
    calls, launches = heatmap.final_conv1x1_plain.calls, heatmap.final_conv1x1.launches
    out = torch.empty((*spatial, k), dtype=torch.bfloat16)
    with torch.no_grad():
        heatmap.final_conv1x1(xf, spatial, conv.weight[:, :, 0, 0, 0], conv.bias, out)
    assert torch.equal(out, whole)
    assert heatmap.final_conv1x1_plain.calls == calls + 1
    assert heatmap.final_conv1x1.launches == launches


def test_final_conv_wrapper_is_forward_only():
    """``final_conv1x1`` writes into a tensor of its own and has no backward:
    with grad enabled it refuses an operand that requires a gradient before
    anything runs (the executors take it only without one, or inside
    ``_FinalConv``'s forward)."""
    conv = torch.nn.Conv3d(4, 6, 1)
    xf = torch.randn((2, 4, 15)).to(torch.bfloat16)
    out = torch.empty((2, 3, 5, 6), dtype=torch.bfloat16)
    calls = heatmap.final_conv1x1_plain.calls
    with pytest.raises(RuntimeError, match="final_conv1x1 is forward-only"):
        heatmap.final_conv1x1(xf, (2, 3, 5), conv.weight[:, :, 0, 0, 0], conv.bias, out)
    assert heatmap.final_conv1x1_plain.calls == calls
    with torch.no_grad():
        heatmap.final_conv1x1(xf, (2, 3, 5), conv.weight[:, :, 0, 0, 0], conv.bias, out)
    assert heatmap.final_conv1x1_plain.calls == calls + 1


@pytest.mark.parametrize("cin,k,want", [(32, 256, (8, 4, 256)), (32, 128, (8, 4, 128)),
                                        (1, 5, (8, 4, 5)), (40, 300, (8, 2, 300)),
                                        (256, 256, (4, 1, 128)), (300, 200, (4, 1, 64)),
                                        (780, 16, (1, 1, 16))])
def test_final_conv_plan_fits_a_block(cin, k, want):
    """The final conv's plan (warps a block, warp tiles a block tile, output
    channels a launch): the first of FC_SHAPES whose block holds W of at
    least 64 channels, as many channels a launch as then fit; every launch's
    shared memory within the block's limit, each launch but the last a
    multiple of 64 channels (the kernel's 16-byte stores need launches that
    start on a multiple of 8). 32 -> 256, both executors' serving shape, is
    one launch of 8 warps of 4 tiles (1024 voxels) in 190,464 bytes."""
    warps, tpw, group = heatmap.final_conv_plan(cin, k)
    assert (warps, tpw, group) == want
    assert group == k or group % heatmap.FC_NCH == 0
    for n0 in range(0, k, group):
        assert heatmap.final_conv_smem(cin, min(group, k - n0), warps, tpw) <= heatmap.FC_MAX_SMEM
    assert heatmap.final_conv_smem(32, 256, 8, 4) == 190464


def test_final_conv_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="input channels leave no room"):
        heatmap.final_conv_plan(800, 5)


def test_residual_executor_final_conv_takes_the_wrapper():
    """The residual executor's final conv goes through ``final_conv1x1``
    once a volume, serving and under autograd (``_FinalConv``'s forward), and
    through ``final_conv1x1_plain`` on its plain route; the three give the
    same heatmaps, the trained ones with a gradient for the final conv."""
    net, _, _, img = _nets("resnet")
    img = torch.cat([img, img.flip(2)])
    kernels.reset_counters()
    with torch.no_grad():
        served = fast_resunet_forward(net, img)
    assert kernels.counters()["final_conv1x1"] == {"launches": 0, "plain_calls": 2}
    n0 = heatmap.final_conv1x1_plain.calls
    with pytest.MonkeyPatch.context() as mp:
        seen = []
        mp.setattr(fast_resunet._PLAINS, "final",
                   lambda *a: seen.append(a) or heatmap.final_conv1x1_plain(*a))
        with torch.no_grad():
            plain = fast_resunet_forward(net, img, plain=True)
    assert len(seen) == 2 and heatmap.final_conv1x1_plain.calls == n0 + 2
    kernels.reset_counters()
    trained = fast_resunet_forward(net, img)
    assert kernels.counters()["final_conv1x1"] == {"launches": 0, "plain_calls": 2}
    assert torch.equal(served, plain) and torch.equal(trained.detach(), served)
    trained.float().square().mean().backward()
    assert float(net.final_conv.weight.grad.abs().sum()) > 0


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
    """With grad enabled and a source that requires grad, both forms run
    (one plain call) and their output carries its backward, whose plain
    versions are counted; only the pool kernel, which has no backward,
    refuses such an input (the forward-only RuntimeError, before any
    work)."""
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16, requires_grad=True)
    if form == "res":
        name, grads = "conv3x3_fused_flat_res", ("conv3x3_input_grad", "conv3x3_weight_grad")
        def call():
            return conv3d.conv3x3_fused_flat_res(x, (2, 4, 4), w, residual=x.detach())
        w = torch.zeros((3, 3, 3, 8, 8), requires_grad=True)
    else:
        name = "conv_transpose3x3s2_flat"
        grads = ("conv_transpose3x3s2_input_grad", "conv_transpose3x3s2_weight_grad")
        def call():
            return conv3d.conv_transpose3x3s2_flat(x, (4, 8, 8), w)
        w = torch.zeros((8, 4, 3, 3, 3), requires_grad=True)
    kernels.reset_counters()
    out = call()
    assert out.requires_grad and kernels.counters()[name]["plain_calls"] == 1
    out.float().sum().backward()
    counts = kernels.counters()
    assert all(counts[g]["plain_calls"] == 1 for g in grads), counts
    assert x.grad is not None and x.grad.shape == x.shape and w.grad.shape == w.shape
    with pytest.raises(RuntimeError, match="maxpool2_flat is forward-only"):
        resblock.maxpool2_flat(x, (2, 4, 4))
    assert kernels.counters()["maxpool2_flat"]["plain_calls"] == 0


def _flat_grads(net, fn, proj):
    """The gradient of <fn(), proj> over every parameter of ``net`` and the
    input (``fn`` takes the input), flattened in float64."""
    img = fn.img.clone().requires_grad_(True)
    net.zero_grad()
    (fn(img).double() * proj).sum().backward()
    return torch.cat([p.grad.double().ravel() for p in net.parameters()]
                     + [img.grad.double().ravel()])


def _d(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_executor_gradients_match_the_module_and_the_reference(kind):
    """The gradient of the heatmaps' inner product with a fixed projection,
    over every parameter and the input volume: the executor's (CPU default
    and ``plain=True``, the same plain versions and backward here), the bf16
    module's autograd and the reference's (``resunet_se.features`` and its
    head, autograd in float32) lie within the bf16 module's distance from
    float64 of each other (the module docstring's yardstick); the reference
    with fp8 conv operands does not."""
    net, n64, w, img = _nets(kind, seed=1)
    proj = torch.randn((1, SIZE, SIZE, SIZE, K), generator=torch.Generator().manual_seed(5),
                       dtype=torch.float64)

    def route(f):
        f.img = img
        return f

    exe = _flat_grads(net, route(lambda x: fast_resunet_forward(net, x)), proj)
    plain = _flat_grads(net, route(lambda x: fast_resunet_forward(net, x, plain=True)), proj)
    mod = _flat_grads(net, route(lambda x: net(x).movedim(1, -1)), proj)
    f64 = _flat_grads(n64, route(lambda x: n64(x.double()).movedim(1, -1)), proj)

    def reference(prec):
        p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        x = img.clone().requires_grad_(True)
        heat = _reference_heatmaps(p, x, prec)
        (heat.double() * proj).sum().backward()
        return torch.cat([p[n].grad.double().ravel() for n, _ in net.named_parameters()]
                         + [x.grad.double().ravel()])

    ref, ref8 = reference(REFERENCE), reference(Precision("fp8", "fp32"))
    bar = _d(mod, f64)
    print(f"{kind}: executor-module {_d(exe, mod):.3g}, executor-reference {_d(exe, ref):.3g}, "
          f"module-float64 {bar:.3g}, fp8-executor {_d(ref8, exe):.3g}")
    assert torch.equal(exe, plain)
    assert _d(exe, mod) <= bar and _d(exe, ref) <= bar and _d(ref, mod) <= bar
    assert _d(ref8, exe) > bar


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_checkpointed_executor_gives_the_same_gradients(kind):
    """``use_checkpoint`` replays each residual block in the backward through
    ``KeyMorphNet.features``: the same arithmetic, so the heatmaps and the
    gradients of every parameter and of the input are bit-identical, and
    the replay shows as extra forward calls of the residual conv."""
    cls, _ = KINDS[kind]
    _, _, w, img = _nets(kind, seed=2)
    img = img[..., :16, :16, :16]
    proj = torch.randn((1, 16, 16, 16, K), generator=torch.Generator().manual_seed(7))
    heats, grads, calls = [], [], []
    for ckpt in (False, True):
        net = cls(K, f_maps=F_MAPS, num_levels=LEVELS, dtype=torch.bfloat16,
                  use_checkpoint=ckpt)
        net.load_state_dict(w, strict=True)
        x = img.clone().requires_grad_(True)
        kernels.reset_counters()
        heat = KeyMorphNet(net, K).features(x)
        (heat.float() * proj).sum().backward()
        calls.append(kernels.counters()["conv3x3_fused_flat_res"]["plain_calls"])
        heats.append(heat.detach())
        grads.append({"img": x.grad, **{k: p.grad for k, p in net.named_parameters()}})
    # without the replay: each block's forward and its backward's recomputation
    assert calls[0] == 2 * (2 * LEVELS - 1) and calls[1] > calls[0], calls
    assert torch.equal(heats[0], heats[1])
    for k in grads[0]:
        assert grads[0][k] is not None and torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_training_step_gradient_matches_the_reference_step(kind):
    """One ``make_train_step`` step of the port (the executor under autograd)
    against ``kmbench/reference/train_resunet.py``'s first step following its
    keypoints, from the same weights, pair and draws: the first gradient
    (Adam's first moment over 1 - beta1) lies within the reference's own
    distance from itself on weights nudged by half a bf16 ulp, and the
    reference with fp8 conv operands lies beyond it; the loss agrees to
    1e-5 of itself."""
    from kmbench import judge
    from kmbench.drivers.train import recipe
    from kmbench.reference import train_resunet
    from keymorph_tpu_torch.training import train

    cfg = {"backbone": kind.replace("resnet", "residualunet"), "num_levels_for_unet": LEVELS,
           "num_truncated_layers_for_truncatedunet": 0, "f_maps": F_MAPS, "layer_order": "gcr",
           "num_groups": 8, "kp_layer": "com", "precision": {"backbone": "bf16"},
           "num_keypoints": K, "img_size": [16] * 3, "transform_type": "tps_loguniform",
           "loss_fn": "mse", "max_train_keypoints": 4, "max_train_tps_lmbda": 10.0, "lr": 3e-6,
           "batch_size": 1}
    _, se = KINDS[kind]
    w = inputs.make_weights(2, resunet_se.param_specs(F_MAPS, LEVELS, K, se=se), "cpu")
    net = KeyMorphNet(KINDS[kind][0](K, f_maps=F_MAPS, num_levels=LEVELS, dtype=torch.bfloat16),
                      K)
    net.backbone.load_state_dict(w, strict=True)
    config = recipe(cfg)
    state = train.TrainState.create(net, train.make_optimizer(config, net))
    pool = inputs.make_pool(2, 2, 16, "cpu")
    d = inputs.train_draws(2, 1, K, 4, 10.0, (0.2, 0.2, 3.1416, 0.1), "cpu")
    points = []
    hook = net.register_forward_hook(
        lambda m, a, o: points.append((o[0].detach().clone(), o[1].detach().clone())))
    out = train.make_train_step(net, config)(
        state, None, pool[:1], pool[1:], None, None, 1.0, lmbda=d["lmbda"],
        keypoint_idx=d["keypoint_idx"][0],
        aug_params=tuple(d[k] for k in ("scale", "offset", "theta", "shear")))[1]
    hook.remove()
    names = {p: n.removeprefix("backbone.") for n, p in net.named_parameters()}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    prog = torch.cat([(state.optimizer.state[p]["exp_avg"] / (1 - beta1)).ravel()
                      for p in net.parameters()])

    def reference(weights, prec=REFERENCE):
        losses, first, _, _ = train_resunet.run(weights, [(pool[:1], pool[1:])], d, 3e-6, 1,
                                                LEVELS, prec, forced=points)
        return losses[0], torch.cat([first[names[p]].ravel() for p in net.parameters()])

    loss, ref = reference(w)
    _, nudged = reference(judge.nudge(w, torch.Generator().manual_seed(9)))
    _, fp8 = reference(w, Precision("fp8", "fp32"))
    bar = _d(nudged, ref)
    print(f"{kind}: step gradient program-reference {_d(prog, ref):.3g}, nudged-reference "
          f"{bar:.3g}, fp8-program {_d(fp8, prog):.3g}")
    assert abs(float(out["loss"]) - loss) <= 1e-5 * loss
    assert _d(prog, ref) <= bar < _d(fp8, prog)


def _through(x):
    """bf16 rounding forward, the identity backward."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def test_gate_backward_splits_ties_as_torch_maximum():
    """``scse_gate_bwd_plain`` (the arithmetic of ``scse_gate_bwd_kernel``)
    against autograd of the gate's equations in float32 with straight-through
    roundings and ``torch.maximum``, on a block output with zeros (both gated
    values 0: a tie) and planted positive ties (g_c equal to a voxel's g_s, so
    the two rounded products are equal): the input gradient to one bf16
    rounding (2^-8 of its largest value), the sums for g_c and the spatial
    gate's weights and bias to 1e-5 of their largest term sums."""
    gen = torch.Generator().manual_seed(3)
    Z, C, N = 3, 8, 40
    x = torch.relu(torch.randn((Z, C, N), generator=gen)).to(torch.bfloat16)
    ws = (torch.randn(C + 1, generator=gen) / 3).to(torch.bfloat16).float()
    g = torch.randn((Z, C, N), generator=gen).to(torch.bfloat16)
    xf = x.float()
    gs = torch.sigmoid(_through(torch.einsum("c,zcn->zn", ws[:C], xf) + ws[C]))
    gs = _through(gs)
    g_c = torch.sigmoid(torch.randn(C, generator=gen)).to(torch.bfloat16).float()
    g_c[:4] = gs[0, :4].detach()  # channel c of voxel c on plane 0: a positive tie
    a = _through(xf * g_c[None, :, None])
    b = _through(xf * gs[:, None, :])
    ties = (a == b) & (xf > 0)
    assert int(ties.sum()) >= 4 and int(((a == b) & (xf == 0)).sum()) > 0

    xr = xf.clone().requires_grad_(True)
    gcr = g_c.clone().requires_grad_(True)
    wr = ws.clone().requires_grad_(True)
    s = torch.sigmoid(_through(torch.einsum("c,zcn->zn", wr[:C], xr) + wr[C]))
    out = torch.maximum(_through(xr * gcr[None, :, None]), _through(xr * _through(s)[:, None, :]))
    want = torch.autograd.grad((out * g.float()).sum(), [xr, gcr, wr])
    got = resblock.scse_gate_bwd_plain(x, g_c, ws, g)
    assert got[0].dtype == torch.bfloat16
    assert float((got[0].float() - want[0]).abs().max()) <= 2 ** -8 * float(want[0].abs().max())
    mag_c = (g.float().abs() * xf).sum(dim=(0, 2))
    assert bool(((got[1] - want[1]).abs() <= 1e-5 * mag_c.max()).all())
    assert float((got[2] - want[2]).abs().max()) <= 1e-5 * float(
        (g.float().abs() * xf).sum() * (xf.max() + 1))


@pytest.mark.parametrize("form", ["lift", "tconv", "res"])
def test_form_backward_matches_autograd_of_its_equations(form):
    """Each form's backward (its plain route: ``_Lift``, ``_TConv`` and the
    residual form of ``_FusedConv``) against autograd of the same equations
    in float32 with straight-through roundings, through the output and its
    stats (a scalar of both): every input's gradient within 2^-7 of its norm
    (relative L2). The forms round the cotangent to bf16 once, as the kernels
    take it, and a bf16 gradient once more: two roundings of 2^-9 an
    element; a term left out or a tap flipped moves it by its own size."""
    gen = torch.Generator().manual_seed(4)
    spatial = (4, 6, 8)
    Z, Y, X = spatial
    N = Y * X
    if form == "lift":
        ins = [torch.randn((Z, 5, N), generator=gen).to(torch.bfloat16),
               torch.randn((12, 5), generator=gen), torch.randn(12, generator=gen)]

        def ours(x, w, b):
            return resblock.lift1x1_flat_plain(x, w, b)

        def eq(x, w, b):
            y = _through(torch.einsum("oc,zcn->zon", _through(w), x.float())
                         + _through(b)[None, :, None])
            return y, (y.mean(dim=(0, 2)), (y * y).mean(dim=(0, 2)))
    elif form == "tconv":
        ins = [torch.randn((Z // 2, 6, N // 4), generator=gen).to(torch.bfloat16),
               torch.randn((6, 4, 3, 3, 3), generator=gen) / 4, torch.randn(4, generator=gen),
               torch.randn((Z, 4, N), generator=gen).to(torch.bfloat16)]

        def ours(x, wt, b, skip):
            return conv3d.conv_transpose3x3s2_flat_plain(x, spatial, wt, b, skip, True)

        def eq(x, wt, b, skip):
            lhs = x.float().reshape(Z // 2, 6, Y // 2, X // 2).permute(1, 0, 2, 3)[None]
            t = torch.nn.functional.conv_transpose3d(lhs, _through(wt), b, stride=2, padding=1,
                                                     output_padding=1)[0]
            y = _through(_through(t.permute(1, 0, 2, 3).reshape(Z, 4, N)) + skip.float())
            return y, (y.mean(dim=(0, 2)), (y * y).mean(dim=(0, 2)))
    else:
        ins = [torch.randn((Z, 6, N), generator=gen).to(torch.bfloat16),
               torch.randn((3, 3, 3, 6, 6), generator=gen) / 8,
               torch.rand(6, generator=gen) + 0.5, torch.randn(6, generator=gen) / 4,
               torch.randn((Z, 6, N), generator=gen).to(torch.bfloat16)]

        def ours(x, w, sc, sh, res):
            return conv3d.conv3x3_fused_flat_res_plain(x, spatial, w, sc, sh, None, True, True,
                                                       residual=res)

        def eq(x, w, sc, sh, res):
            u = _through(x.float() * sc[None, :, None] + sh[None, :, None])
            lhs = u.reshape(Z, 6, Y, X).permute(1, 0, 2, 3)[None]
            v = torch.nn.functional.conv3d(lhs, _through(w).permute(4, 3, 0, 1, 2), padding=1)[0]
            y = _through(torch.relu(_through(v.permute(1, 0, 2, 3).reshape(Z, 6, N))
                                    + res.float()))
            return y, (y.mean(dim=(0, 2)), (y * y).mean(dim=(0, 2)))
    proj = torch.randn(ins[-1].shape if form != "lift" else (Z, 12, N), generator=gen)
    if form == "tconv":
        proj = torch.randn((Z, 4, N), generator=gen)
    pm, pq = torch.randn(proj.shape[1], generator=gen), torch.randn(proj.shape[1], generator=gen)

    def grads(fn):
        leaves = [t.clone().float().requires_grad_(True) if t.dtype == torch.float32
                  else t.clone().requires_grad_(True) for t in ins]
        y, (m, q) = fn(*leaves)
        ((y.float() * proj).sum() + (m * pm).sum() + (q * pq).sum()).backward()
        return [t.grad.float() for t in leaves]

    for got, want in zip(grads(ours), grads(eq)):
        assert float((got - want).norm()) <= 2 ** -7 * float(want.norm())
