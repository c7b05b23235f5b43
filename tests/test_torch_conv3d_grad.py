"""Gradients of the port's fused conv (keymorph_tpu_torch/ops/cuda/conv3d.py)
against keymorph_tpu's (keymorph_tpu/ops/pallas/conv3d.py).

The same numpy inputs go through ``jax.grad`` of the JAX conv and through
``backward()`` of the port's. The JAX side runs twice: with its Pallas kernels
in interpret mode (KM_FORCE_FAST_CONV=1: the hand-written ``_conv_bwd``,
whose input gradient rides the Pallas conv kernel) and through its XLA VJP
(KM_NO_FAST_CONV=1). On the CPU the port runs the plain versions of its
forward and input-gradient kernels through the same autograd Function the
card uses.

Tolerance: 3e-2 of each gradient's largest value, keymorph_tpu's own bar
between its two paths (tests/test_conv3d.py): every cotangent is rounded to
bf16 at the conv boundary and the two packages sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu.ops.pallas import conv3d as jconv
from keymorph_tpu_torch.ops.cuda import conv3d as tconv

TOL = 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mode(monkeypatch, ref):
    if ref == "pallas":
        monkeypatch.setenv("KM_FORCE_FAST_CONV", "1")
        monkeypatch.delenv("KM_NO_FAST_CONV", raising=False)
    else:
        monkeypatch.setenv("KM_NO_FAST_CONV", "1")
        monkeypatch.delenv("KM_FORCE_FAST_CONV", raising=False)


def _bf16(a):
    return torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    sc = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() / sc < tol, np.abs(got - want).max() / sc


def _torch_grads(loss_fn, arrays, bf16_mask):
    """backward() of ``loss_fn`` over leaf tensors made from numpy arrays;
    inputs flagged in ``bf16_mask`` enter as bf16 leaves."""
    leaves = []
    for a, is_bf in zip(arrays, bf16_mask):
        t = torch.tensor(a)
        leaves.append((t.to(torch.bfloat16) if is_bf else t).requires_grad_(True))
    loss_fn(*leaves).backward()
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_flat_grad_with_stats_matches_jax(rng, monkeypatch, ref):
    """x, w, scale and shift gradients of relu(conv(a*x+b)) with cotangents
    on the output AND on both emitted statistics (tests/test_conv3d.py:149)."""
    _jax_mode(monkeypatch, ref)
    Z, C, Y, X, K = 6, 16, 16, 128, 32
    x = _bf16(rng.normal(size=(Z, C, Y, X)).astype(np.float32))
    w = (rng.normal(size=(3, 3, 3, C, K)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    shift = (rng.normal(size=C) * 0.3).astype(np.float32)

    def jloss(x_, w_, a_, b_):
        o, (m, m2) = jconv.conv3x3_fused(x_, w_, a_, b_, relu=True, emit_stats=True)
        return (jnp.sum(o.astype(jnp.float32) ** 2) * 1e-2
                + jnp.sum(m * jnp.arange(K)) + jnp.sum(m2))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(shift))

    def tloss(x_, w_, a_, b_):
        o, (m, m2) = tconv.conv3x3_fused(x_, w_, a_, b_, relu=True, emit_stats=True)
        return ((o.float() ** 2).sum() * 1e-2
                + (m * torch.arange(K, dtype=torch.float32)).sum() + m2.sum())

    got = _torch_grads(tloss, (x, w, scale, shift), (True, False, False, False))
    for g, wnt in zip(got, want):
        _close(g, np.asarray(wnt.astype(jnp.float32)))


def test_flat_grad_bias_no_relu_matches_jax(rng, monkeypatch):
    """No ReLU, with a bias: g_bias is the plain sum of the bf16 cotangent."""
    _jax_mode(monkeypatch, "pallas")
    Z, C, Y, X, K = 4, 8, 16, 128, 16
    xf = _bf16(rng.normal(size=(Z, C, Y * X)).astype(np.float32))
    w = (rng.normal(size=(3, 3, 3, C, K)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=K) * 0.1).astype(np.float32)
    cot = rng.normal(size=(Z, K, Y * X)).astype(np.float32)

    def jloss(x_, w_, b_):
        o = jconv.conv3x3_fused_flat(x_, (Z, Y, X), w_, bias=b_, relu=False)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(xf).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(bias))

    def tloss(x_, w_, b_):
        o = tconv.conv3x3_fused_flat(x_, (Z, Y, X), w_, bias=b_, relu=False)
        return (o.float() * torch.tensor(cot)).sum()

    got = _torch_grads(tloss, (xf, w, bias), (True, False, False))
    for g, wnt in zip(got, want):
        _close(g, np.asarray(wnt.astype(jnp.float32)))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_parts_grad_matches_jax(rng, monkeypatch, ref):
    """Both sources' gradients and the weight gradient of the two-source conv
    (tests/test_conv3d.py:205)."""
    _jax_mode(monkeypatch, ref)
    Z, Y, X, Ca, Cb, K = 4, 16, 128, 16, 8, 8
    xa = _bf16(rng.normal(size=(Z, Ca, Y * X)).astype(np.float32) * 0.5)
    xb = _bf16(rng.normal(size=(Z, Cb, Y * X)).astype(np.float32) * 0.5)
    w = (rng.normal(size=(3, 3, 3, Ca + Cb, K)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, Ca + Cb).astype(np.float32)
    shift = (rng.normal(size=Ca + Cb) * 0.3).astype(np.float32)

    def jloss(xa_, xb_, w_, a_, b_):
        o = jconv.conv3x3_fused_flat_parts(xa_, xb_, (Z, Y, X), w_, a_, b_)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(xa).astype(jnp.bfloat16), jnp.asarray(xb).astype(jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift))

    def tloss(xa_, xb_, w_, a_, b_):
        o = tconv.conv3x3_fused_flat_parts(xa_, xb_, (Z, Y, X), w_, a_, b_)
        return (o.float() ** 2).sum()

    got = _torch_grads(tloss, (xa, xb, w, scale, shift), (True, True, False, False, False))
    for g, wnt in zip(got, want):
        _close(g, np.asarray(wnt.astype(jnp.float32)))


@pytest.mark.parametrize("emit_stats", [False, True])
def test_upconv_grad_matches_jax(rng, monkeypatch, emit_stats):
    """The decoder conv: the half-resolution source's gradient is the 2x2x2
    block sum of the full-resolution one (tests/test_conv3d.py:302; the JAX
    VJP differentiates upsample + concat + conv in XLA)."""
    _jax_mode(monkeypatch, "pallas")
    Z, Y, X, Ca, Cb, K = 4, 16, 128, 16, 16, 8
    xa = _bf16(rng.normal(size=(Z, Ca, Y * X)).astype(np.float32) * 0.5)
    xb = _bf16(rng.normal(size=(Z // 2, Cb, (Y // 2) * (X // 2))).astype(np.float32) * 0.5)
    w = (rng.normal(size=(3, 3, 3, Ca + Cb, K)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, Ca + Cb).astype(np.float32)
    shift = (rng.normal(size=Ca + Cb) * 0.3).astype(np.float32)

    def jloss(xa_, xb_, w_, a_, b_):
        r = jconv.conv3x3_fused_flat_upconv(xa_, xb_, (Z, Y, X), w_, a_, b_,
                                            emit_stats=emit_stats)
        if emit_stats:
            o, (m, m2) = r
            return jnp.sum(o.astype(jnp.float32) ** 2) + 50.0 * jnp.sum(m) + 20.0 * jnp.sum(m2)
        return jnp.sum(r.astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(xa).astype(jnp.bfloat16), jnp.asarray(xb).astype(jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift))

    def tloss(xa_, xb_, w_, a_, b_):
        r = tconv.conv3x3_fused_flat_upconv(xa_, xb_, (Z, Y, X), w_, a_, b_,
                                            emit_stats=emit_stats)
        if emit_stats:
            o, (m, m2) = r
            return (o.float() ** 2).sum() + 50.0 * m.sum() + 20.0 * m2.sum()
        return (r.float() ** 2).sum()

    got = _torch_grads(tloss, (xa, xb, w, scale, shift), (True, True, False, False, False))
    assert got[1].shape == (Z // 2, Cb, (Y // 2) * (X // 2))
    for g, wnt in zip(got, want):
        _close(g, np.asarray(wnt.astype(jnp.float32)))


def test_input_grad_plain_is_the_flipped_conv(rng):
    """conv3x3_input_grad's plain version equals keymorph_tpu's conv of the
    cotangent with flipped taps and swapped channels (``_conv_bwd``'s
    ``w_t``), to one bf16 ulp of each value; the split returns the halves."""
    Z, Y, X, C, K = 4, 8, 32, 12, 8
    g_v = _bf16(rng.normal(size=(Z, K, Y * X)).astype(np.float32))
    w = (rng.normal(size=(3, 3, 3, C, K)) * 0.2).astype(np.float32)
    w_t = jnp.swapaxes(jnp.flip(jnp.asarray(w), axis=(0, 1, 2)), 3, 4)
    want = np.asarray(jconv._conv_xla(
        jnp.asarray(g_v).astype(jnp.bfloat16).reshape(Z, K, Y, X), w_t, None, None, None,
        False).astype(jnp.float32)).reshape(Z, C, Y * X)
    tg = torch.tensor(g_v).to(torch.bfloat16)
    whole, none = tconv.conv3x3_input_grad(tg, (Z, Y, X), torch.tensor(w))
    assert none is None and whole.dtype == torch.bfloat16
    got = whole.float().numpy()
    _, e = np.frexp(np.abs(want).astype(np.float32))
    bound = np.ldexp(np.float32(1.0), e - 8) + 1e-6 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound)
    a, b = tconv.conv3x3_input_grad(tg, (Z, Y, X), torch.tensor(w), ca=5)
    assert torch.equal(torch.cat([a, b], dim=1), whole)


def test_weight_grad_is_the_tap_sliced_product(rng):
    """The 27 tap-sliced matmuls against a float64 einsum over a padded copy:
    bf16-valued operands have exact fp32 products, so only the fp32 sum's
    order differs (rel 1e-5)."""
    Z, Y, X, C, K = 3, 5, 7, 4, 6
    u = torch.tensor(_bf16(rng.normal(size=(Z, C, Y * X)).astype(np.float32)))
    g = torch.tensor(_bf16(rng.normal(size=(Z, K, Y * X)).astype(np.float32)))
    got = tconv._weight_grad_plain(u.to(torch.bfloat16), None, (Z, Y, X),
                                   g.to(torch.bfloat16)).numpy()
    up = np.pad(u.numpy().astype(np.float64).reshape(Z, C, Y, X),
                ((1, 1), (0, 0), (1, 1), (1, 1)))
    g4 = g.numpy().astype(np.float64).reshape(Z, K, Y, X)
    want = np.zeros((3, 3, 3, C, K))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                want[dz, dy, dx] = np.einsum(
                    "zcyx,zkyx->ck", up[dz:dz + Z, :, dy:dy + Y, dx:dx + X], g4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["parts", "upconv"])
def test_weight_grad_plain_builds_u_from_both_sources(rng, mode):
    """The plain weight gradient of a two-source conv with the affine (the
    concat, the nearest x2 upsample of a half-resolution source, bf16(a*x +
    b) and pad0 built inside it) against a float64 einsum over u made here:
    only the fp32 sum's order differs (rel 1e-5)."""
    Z, Y, X, ca, cb, K = 4, 6, 8, 3, 5, 7
    lo = mode == "upconv"
    xa = torch.tensor(_bf16(rng.normal(size=(Z, ca, Y * X)).astype(np.float32)))
    src = (Z // 2, cb, (Y // 2) * (X // 2)) if lo else (Z, cb, Y * X)
    xb = torch.tensor(_bf16(rng.normal(size=src).astype(np.float32)))
    g = torch.tensor(_bf16(rng.normal(size=(Z, K, Y * X)).astype(np.float32)))
    a = rng.uniform(0.5, 1.5, ca + cb).astype(np.float32)
    b = (rng.normal(size=ca + cb) * 0.3).astype(np.float32)
    bf = torch.bfloat16
    got = tconv._weight_grad_plain(xa.to(bf), xb.to(bf), (Z, Y, X), g.to(bf), torch.tensor(a),
                                   torch.tensor(b), lo).numpy()
    xb4 = xb.numpy().reshape(src[0], cb, *((Y // 2, X // 2) if lo else (Y, X)))
    if lo:
        xb4 = xb4.repeat(2, axis=0).repeat(2, axis=2).repeat(2, axis=3)
    x = np.concatenate([xa.numpy().reshape(Z, ca, Y, X), xb4], axis=1)
    u = _bf16(x * a[None, :, None, None] + b[None, :, None, None]).astype(np.float64)
    up = np.pad(u, ((1, 1), (0, 0), (1, 1), (1, 1)))
    g4 = g.numpy().astype(np.float64).reshape(Z, K, Y, X)
    want = np.zeros((3, 3, 3, ca + cb, K))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                want[dz, dy, dx] = np.einsum(
                    "zcyx,zkyx->ck", up[dz:dz + Z, :, dy:dy + Y, dx:dx + X], g4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_fused_4d_entry_is_the_flat_conv(rng):
    """conv3x3_fused on (Z, C, Y, X) is a view onto conv3x3_fused_flat."""
    Z, C, Y, X, K = 3, 4, 6, 8, 5
    x = torch.tensor(rng.normal(size=(Z, C, Y, X)).astype(np.float32)).to(torch.bfloat16)
    w = torch.tensor((rng.normal(size=(3, 3, 3, C, K)) * 0.2).astype(np.float32))
    o4, (m, m2) = tconv.conv3x3_fused(x, w, emit_stats=True)
    of, (fm, fm2) = tconv.conv3x3_fused_flat(x.reshape(Z, C, Y * X), (Z, Y, X), w,
                                             emit_stats=True)
    assert o4.shape == (Z, K, Y, X)
    assert torch.equal(o4.reshape(Z, K, Y * X), of) and torch.equal(m, fm)
