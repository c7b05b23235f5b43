"""Gradients through the port's kernel-layout U-Net executor
(keymorph_tpu_torch/models/fast_unet.py) against keymorph_tpu's, on weights
carried across by tools/import_flax_params.py.

The losses sit on the center-of-mass keypoints and on the heatmaps, so the
gradient runs through the keypoint head, the final matmul, every conv's
backward (the input-gradient kernel's plain version on the CPU),
the GroupNorm statistics and folds, and the max-pool. keymorph_tpu runs its
executor with its Pallas conv in interpret mode (KM_FORCE_FAST_CONV=1: the
hand-written ``_conv_bwd``), and its flax modules in fp32 give the truth.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from keymorph_tpu.models import fast_unet as jfast_unet
from keymorph_tpu.models.layers import center_of_mass as jcenter_of_mass
from keymorph_tpu.models.unet import TruncatedUNet3D as JTruncatedUNet3D
from keymorph_tpu_torch.models import fast_unet
from keymorph_tpu_torch.models.fast_unet import fast_unet_forward
from keymorph_tpu_torch.models.layers import center_of_mass
from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
from keymorph_tpu_torch.tools.import_flax_params import backbone_state_dict_from_flax

CFG = dict(out_channels=8, f_maps=4, num_levels=3, num_truncated_layers=1)
IMG_SHAPE = (1, 1, 16, 16, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_backbone(rng):
    backbone = JTruncatedUNet3D(dtype=jnp.bfloat16, **CFG)
    params = jax.jit(backbone.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 4, 4, 4, 1), jnp.bfloat16))["params"]
    flat = flax.traverse_util.flatten_dict(params)
    for path, v in flat.items():  # GroupNorm affines away from (1, 0), never 0
        if path[-2] == "GroupNorm_0":
            base = 1.0 if path[-1] == "scale" else 0.0
            flat[path] = jnp.asarray(base + 0.2 * rng.normal(size=v.shape).astype(np.float32))
    return backbone, flax.traverse_util.unflatten_dict(flat)


def _blob(rng):
    axes = [np.linspace(-1, 1, s) for s in IMG_SHAPE[2:]]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    f = np.exp(-((zz - 0.1) ** 2 + (yy + 0.2) ** 2 + (xx - 0.3) ** 2) / 0.3)
    return (f + 0.05 * rng.random(f.shape))[None, None].astype(np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("head", ["keypoints", "energy"])
def test_executor_gradients_within_bf16_noise_of_jax(rng, monkeypatch, head):
    """Every parameter's gradient from the port's executor against the fp32
    flax truth, with keymorph_tpu's executor on the same weights as the
    yardstick of what bf16 costs. Two losses: a random cotangent on the
    center-of-mass keypoints (the training path's head) and the heatmaps'
    energy sum(h^2)/2 (a smooth cotangent, so less of the gradient cancels).

    Both executors round every activation and every conv cotangent to bf16,
    and GroupNorm's backward cancels most of what reaches it, so the first
    layers' small gradients carry relative errors of tens of percent in
    either package (printed). The bars are therefore stated against
    keymorph_tpu's own distance from the truth:

      * all parameters as one vector: relative L2 at most 2x keymorph_tpu's
        + 1e-2;
      * each parameter: L2 distance at most 3x keymorph_tpu's + 2e-2 of its
        norm + 2e-3 of the whole gradient's norm. One draw of rounding noise
        against another needs the factor, and at this size keymorph_tpu's
        small convs take its unrounded XLA VJP, so its distance is the
        smaller of the two by construction; the last term is for parameters
        whose own gradient nearly cancels (the first GroupNorm's scalar
        weight) while the noise they receive scales with their neighbours'.
    """
    monkeypatch.setenv("KM_FORCE_FAST_CONV", "1")
    backbone, params = _jax_backbone(rng)
    img = _blob(rng)
    if head == "keypoints":
        cot = rng.normal(size=(1, CFG["out_channels"], 3)).astype(np.float32)
        jhead, thead = jcenter_of_mass, center_of_mass
    else:
        cot = np.float32(0.5)
        jhead, thead = (lambda h: h.astype(jnp.float32) ** 2), (lambda h: h.float() ** 2)

    def truth_loss(p):
        heat = backbone.clone(dtype=jnp.float32).apply(
            {"params": p}, jnp.moveaxis(jnp.asarray(img), 1, -1))
        return jnp.sum(jhead(heat) * jnp.asarray(cot))

    def fast_loss(p):
        heat = jfast_unet.fast_unet_forward(backbone, p, jnp.asarray(img))
        return jnp.sum(jhead(heat) * jnp.asarray(cot))

    def to_np(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    truth = backbone_state_dict_from_flax(to_np(jax.jit(jax.grad(truth_loss))(params)))
    jfast = backbone_state_dict_from_flax(to_np(jax.jit(jax.grad(fast_loss))(params)))

    unet = TruncatedUNet3D(dtype=torch.bfloat16, **CFG)
    unet.load_state_dict(backbone_state_dict_from_flax(to_np(params)))
    (thead(fast_unet_forward(unet, torch.tensor(img))) * torch.tensor(cot)).sum().backward()

    assert {k for k, _ in unet.named_parameters()} == set(truth)
    worst, sq = 0.0, np.zeros(3)
    total = np.sqrt(sum(float((v.numpy() ** 2).sum()) for v in truth.values()))
    for k, p in unet.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        got, want, jgot = p.grad.numpy(), truth[k].numpy(), jfast[k].numpy()
        err, noise = np.linalg.norm(got - want), np.linalg.norm(jgot - want)
        bar = 3.0 * noise + 2e-2 * np.linalg.norm(want) + 2e-3 * total
        sq += [err ** 2, noise ** 2, np.sum(want ** 2)]
        worst = max(worst, err / bar)
        print(f"{k}: port vs truth {_rel_l2(got, want):.3g}, jax executor vs truth "
              f"{_rel_l2(jgot, want):.3g}, share of the bar {err / bar:.3g}")
        assert err <= bar, (k, err, bar)
    whole, jwhole = np.sqrt(sq[0] / sq[2]), np.sqrt(sq[1] / sq[2])
    print(f"whole gradient: port vs truth {whole:.3g}, jax executor vs truth {jwhole:.3g}; "
          f"worst share of a parameter's bar {worst:.3g}")
    assert whole <= 2.0 * jwhole + 1e-2


def test_checkpointed_executor_gives_the_same_gradients(rng):
    """use_checkpoint replays each DoubleConv in the backward: the same
    arithmetic, so loss and gradients are bit-identical, and the replay shows
    as extra forward conv calls."""
    from keymorph_tpu_torch.ops.cuda import conv3d

    img = torch.tensor(rng.uniform(0, 1, size=(2, 1, 8, 8, 16)).astype(np.float32))
    cot = torch.tensor(rng.normal(size=(2, 8, 3)).astype(np.float32))
    grads, calls = [], []
    for ckpt in (False, True):
        unet = init_weights(TruncatedUNet3D(dtype=torch.bfloat16, use_checkpoint=ckpt, **CFG),
                            torch.Generator().manual_seed(0))
        n0 = conv3d.conv3x3_fused_flat_plain.calls
        (center_of_mass(fast_unet_forward(unet, img)) * cot).sum().backward()
        calls.append(conv3d.conv3x3_fused_flat_plain.calls - n0)
        grads.append({k: p.grad.clone() for k, p in unet.named_parameters()})
    assert calls[1] > calls[0]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    # under no_grad the checkpoint wrapper is not entered and nothing is kept
    with torch.no_grad():
        out = fast_unet_forward(unet, img)
    assert not out.requires_grad


def test_maxpool_splits_the_gradient_evenly_among_ties(rng):
    """The reshape-and-amax pool against keymorph_tpu's layout-native
    ``_maxpool2_rw`` backward on quantized input (many exact ties, and
    all-zero windows as after a ReLU): identical gradients, each tied maximum
    getting an equal share."""
    Z, C, Y, X = 4, 3, 6, 8
    x = np.round(rng.normal(size=(Z, C, Y, X)).astype(np.float32) * 2) / 2
    x[:2, 0, :2, :2] = 0.0  # one all-zero window: 8 tied maxima
    g = rng.normal(size=(Z // 2, C, Y // 2, X // 2)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.vdot(jfast_unet._maxpool2_rw(v, (2, 1, 2, 2)), jnp.asarray(g)))(
            jnp.asarray(x)))
    tx = torch.tensor(x).reshape(Z, C, Y * X).requires_grad_(True)
    pooled, spatial = fast_unet._maxpool2_flat(tx, (Z, Y, X))
    assert spatial == (2, 3, 4)
    np.testing.assert_array_equal(
        pooled.detach().numpy().reshape(Z // 2, C, Y // 2, X // 2),
        np.asarray(jfast_unet._maxpool2_rw(jnp.asarray(x), (2, 1, 2, 2))))
    pooled.backward(torch.tensor(g).reshape(Z // 2, C, -1))
    got = tx.grad.numpy().reshape(Z, C, Y, X)
    np.testing.assert_allclose(got, want, atol=1e-7)
    np.testing.assert_allclose(got[:2, 0, :2, :2], g[0, 0, 0, 0] / 8.0, atol=1e-7)


@pytest.mark.parametrize("spatial", [(4, 6, 8), (5, 7, 9)])
@pytest.mark.parametrize("route", ["no_grad", "input_without_grad", "input_with_grad"])
def test_executor_pool_routes_by_whether_a_gradient_is_needed(rng, spatial, route):
    """``fast_unet._maxpool2_flat`` takes the kernel wrapper ``maxpool2_flat``
    (its counted plain version on CPU tensors) when no gradient is needed,
    and the uncounted, differentiable ``maxpool2_amax`` when one is: the same
    maxima either way, NaN included, odd sizes floored."""
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.cuda import resblock

    Z, Y, X = spatial
    x = torch.tensor(np.round(rng.normal(size=(Z, 3, Y * X)) * 2) / 2,
                     dtype=torch.float32).to(torch.bfloat16)
    x[0, 1, 0] = float("nan")
    want, want_sp = resblock.maxpool2_amax(x, spatial)
    x.requires_grad_(route == "input_with_grad")
    kernels.reset_counters()
    with torch.set_grad_enabled(route != "no_grad"):
        got, got_sp = fast_unet._maxpool2_flat(x, spatial)
    count = kernels.counters()["maxpool2_flat"]
    assert got_sp == want_sp == (Z // 2, Y // 2, X // 2)
    got = got.detach() if route == "input_with_grad" else got
    assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if route == "input_with_grad":
        assert count == {"launches": 0, "plain_calls": 0}
    else:
        assert count == {"launches": 0, "plain_calls": 1}


def test_executor_pool_keeps_the_graph_only_where_a_gradient_is_needed(rng):
    """A 4-level net at an odd size (20 x 18 x 15): under no_grad the
    executor's three pools go through ``maxpool2_flat``; under autograd
    through ``maxpool2_amax``, uncounted, whose pooled tensors keep the graph,
    so the first conv still gets a gradient. The heatmaps are the same."""
    from keymorph_tpu_torch.ops.cuda import resblock

    unet = init_weights(TruncatedUNet3D(out_channels=4, f_maps=4, num_levels=4,
                                        num_truncated_layers=1, dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    img = torch.tensor(rng.uniform(0, 1, size=(1, 1, 20, 18, 15)).astype(np.float32))
    n0 = resblock.maxpool2_flat_plain.calls
    with torch.no_grad():
        served = fast_unet_forward(unet, img)
    assert resblock.maxpool2_flat_plain.calls == n0 + 3
    out = fast_unet_forward(unet, img)
    assert resblock.maxpool2_flat_plain.calls == n0 + 3
    assert out.grad_fn is not None and torch.equal(out.detach(), served)
    out.float().square().sum().backward()
    grad = unet.encoders[0].basic_module.SingleConv1.conv.weight.grad
    assert grad is not None and float(grad.abs().sum()) > 0


@pytest.mark.parametrize("route", ["no_grad", "frozen", "grad", "plain"])
def test_executor_final_conv_routes_by_whether_a_gradient_is_needed(rng, route):
    """The DoubleConv executor's final conv: without a gradient to keep
    (under no_grad, or a frozen net under autograd) one ``final_conv1x1`` a
    volume writes into the heatmaps returned (its counted plain version on
    the CPU); ``plain=True`` under no_grad calls ``final_conv1x1_plain``
    itself; where a gradient is needed the autograd matmul runs, uncounted,
    and the first conv gets a gradient. All four give the same heatmaps."""
    from keymorph_tpu_torch.ops import cuda as kernels

    unet = init_weights(TruncatedUNet3D(out_channels=5, f_maps=4, num_levels=3,
                                        num_truncated_layers=1, dtype=torch.bfloat16),
                        torch.Generator().manual_seed(1))
    img = torch.tensor(rng.uniform(0, 1, size=(2, 1, 12, 10, 14)).astype(np.float32))
    with torch.no_grad():
        want = fast_unet_forward(unet, img)
    unet.requires_grad_(route != "frozen")
    kernels.reset_counters()
    with torch.set_grad_enabled(route in ("frozen", "grad")):
        got = fast_unet_forward(unet, img, plain=route == "plain")
    count = kernels.counters()["final_conv1x1"]
    assert got.shape == (2, 6, 5, 7, 5) and torch.equal(got.detach(), want)
    assert count == {"launches": 0, "plain_calls": 0 if route == "grad" else 2}
    assert (got.grad_fn is not None) == (route == "grad")
    if route == "grad":
        got.float().square().sum().backward()
        grad = unet.encoders[0].basic_module.SingleConv1.conv.weight.grad
        assert grad is not None and float(grad.abs().sum()) > 0


def test_executor_final_conv_gradient_is_the_former_forms(rng):
    """Under autograd the executor's final conv is the form it had before the
    kernel (an fp32 matmul of the bf16 values, the fp32 bias, one rounding,
    over the whole volume): the same heatmaps and the same gradients to the
    features, the weight and the bias, bit for bit."""
    conv = torch.nn.Conv3d(6, 9, 1)
    xf0 = torch.tensor(rng.normal(size=(4, 6, 35)).astype(np.float32)).to(torch.bfloat16)
    g = torch.tensor(rng.normal(size=(4, 5, 7, 9)).astype(np.float32))
    got = []
    for form in ("now", "former"):
        conv.zero_grad()
        xf = xf0.clone().requires_grad_(True)
        if form == "now":
            out = fast_unet._final_conv_autograd(xf, (4, 5, 7), conv)
        else:
            hw = conv.weight[:, :, 0, 0, 0].t().to(torch.bfloat16).float()
            hb = conv.bias.float()
            out = (torch.matmul(xf.float().transpose(1, 2), hw) + hb).reshape(4, 5, 7, -1)
            out = out.to(torch.bfloat16)
        (out.float() * g).sum().backward()
        got.append((out.detach(), xf.grad, conv.weight.grad.clone(), conv.bias.grad.clone()))
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_pool_kernel_wrapper_refuses_an_input_that_needs_a_gradient():
    """``resblock.maxpool2_flat`` is forward only: with grad enabled it
    raises on an input that requires a grad (it would return a tensor cut
    from the graph) before anything runs; under no_grad it pools."""
    from keymorph_tpu_torch.ops.cuda import resblock

    x = torch.arange(16, dtype=torch.float32).to(torch.bfloat16).reshape(2, 1, 8)
    x.requires_grad_(True)
    n0 = resblock.maxpool2_flat_plain.calls
    with pytest.raises(RuntimeError, match="maxpool2_flat is forward-only"):
        resblock.maxpool2_flat(x, (2, 2, 4))
    assert resblock.maxpool2_flat_plain.calls == n0
    with torch.no_grad():
        p, sp = resblock.maxpool2_flat(x, (2, 2, 4))
    assert sp == (1, 1, 2) and p.flatten().tolist() == [13.0, 15.0]


def test_gn_affine_from_stats_gradient_matches_jax(rng):
    """The GroupNorm fold (per-channel stats -> per-channel scale and shift)
    under autograd against jax.grad of keymorph_tpu's: rel 1e-5 of the
    largest value (fp32, a handful of operations)."""
    C, groups = 8, 2
    mean = rng.normal(size=C).astype(np.float32)
    msq = (mean ** 2 + rng.uniform(0.5, 1.5, C)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.normal(size=C).astype(np.float32)
    ca, cb = rng.normal(size=C).astype(np.float32), rng.normal(size=C).astype(np.float32)

    def jloss(m, q, ga, be):
        a, b = jfast_unet._gn_affine_from_stats((m, q), ga, be, groups)
        return jnp.sum(a * ca) + jnp.sum(b * cb)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in (mean, msq, gamma, beta)))
    leaves = [torch.tensor(v, requires_grad=True) for v in (mean, msq, gamma, beta)]
    a, b = fast_unet.gn_affine_from_stats((leaves[0], leaves[1]), leaves[2], leaves[3], groups)
    ((a * torch.tensor(ca)).sum() + (b * torch.tensor(cb)).sum()).backward()
    for t, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5 * np.abs(w).max())
