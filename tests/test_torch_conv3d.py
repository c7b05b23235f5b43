"""The port's fused conv (keymorph_tpu_torch/ops/cuda/conv3d.py) against
keymorph_tpu's conv (keymorph_tpu/ops/pallas/conv3d.py).

On the CPU the port's wrappers run their plain versions, which must compute
keymorph_tpu's ``_conv_xla`` function: bf16 operands, fp32 accumulation, a
bf16 output, GroupNorm affine applied before zero padding. The JAX Pallas
kernel runs in interpret mode (KM_FORCE_FAST_CONV=1), as keymorph_tpu's own
tests run it. The CUDA kernel itself is compared with the plain version on
the card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.ops.pallas import conv3d as jconv
from keymorph_tpu_torch.ops.cuda import conv3d as tconv


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """Round a numpy array to bf16-representable float32 values."""
    return torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).float().numpy()


def _operands(rng, Z, Y, X, cin, cout):
    """Flat (Z, Cin, Y*X) bf16-valued input, HWIO weights and a GroupNorm-like
    affine with scale in [0.5, 1.5] (never 0: keymorph_tpu's Pallas fold
    drops the shift where scale == 0, see ROADMAP Queue C)."""
    x = _bf16(rng.normal(size=(Z, cin, Y * X)).astype(np.float32))
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (rng.normal(size=cin) * 0.3).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    return x, w, scale, shift, bias


def _xla(xf, spatial, w, scale, shift, bias, relu, emit_stats):
    """keymorph_tpu's _conv_xla on a flat input; returns numpy."""
    Z, Y, X = spatial
    x4 = jnp.asarray(xf).astype(jnp.bfloat16).reshape(Z, -1, Y, X)
    r = jconv._conv_xla(x4, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
                        None if bias is None else jnp.asarray(bias), relu, emit_stats)
    out, stats = (r if emit_stats else (r, None))
    out = np.asarray(out.astype(jnp.float32)).reshape(Z, -1, Y * X)
    return out, (None if stats is None else [np.asarray(s) for s in stats])


def _port(fn, xs, spatial, w, scale, shift, bias, relu, emit_stats):
    ts = [torch.tensor(x).to(torch.bfloat16) for x in xs]
    r = fn(*ts, spatial, torch.tensor(w), torch.tensor(scale), torch.tensor(shift),
           None if bias is None else torch.tensor(bias), relu=relu, emit_stats=emit_stats)
    out, stats = (r if emit_stats else (r, None))
    assert out.dtype == torch.bfloat16
    return out.float().numpy(), (None if stats is None else [s.numpy() for s in stats])


def _ulp(v):
    """bf16 spacing at each value: 2^(e - 8) for |v| in [2^(e-1), 2^e)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def assert_within_one_ulp(got, want):
    """<= 1 bf16 ulp of each output: both sides round the same fp32 sum,
    accumulated in a different order, to bf16. The 1e-6 * max|want| floor
    covers outputs that cancel to near zero, where fp32 summation-order
    noise exceeds the tiny value's own ulp."""
    err = np.abs(got - want)
    bound = np.maximum(_ulp(want), _ulp(got)) + 1e-6 * np.abs(want).max()
    assert np.all(err <= bound), float((err - bound).max())


def assert_stats_close(got, want):
    """Per-Cout (mean, E[y^2]) within rel 1e-5 of the largest channel value:
    fp32 sums of the same bf16 outputs in another order."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


FLAT_CASES = [(cin, X) for cin in (1, 8, 16) for X in (32, 128)]


@pytest.mark.parametrize("emit_stats", [False, True])
@pytest.mark.parametrize("cin,X", FLAT_CASES)
def test_flat_plain_matches_conv_xla(rng, cin, X, emit_stats):
    Z, Y, cout = 4, 8, 16
    x, w, sc, sh, b = _operands(rng, Z, Y, X, cin, cout)
    relu = cin != 8  # one no-ReLU case per width
    got, gs = _port(tconv.conv3x3_fused_flat, [x], (Z, Y, X), w, sc, sh, b, relu,
                    emit_stats)
    want, ws = _xla(x, (Z, Y, X), w, sc, sh, b, relu, emit_stats)
    assert_within_one_ulp(got, want)
    if emit_stats:
        assert_stats_close(gs, ws)


@pytest.mark.parametrize("emit_stats", [False, True])
def test_parts_plain_matches_conv_xla(rng, emit_stats):
    Z, Y, X, ca, cb, cout = 4, 8, 32, 8, 16, 16
    xa, w, sc, sh, b = _operands(rng, Z, Y, X, ca + cb, cout)
    xa, xb = xa[:, :ca], xa[:, ca:]
    got, gs = _port(tconv.conv3x3_fused_flat_parts, [xa, xb], (Z, Y, X), w, sc, sh,
                    b, True, emit_stats)
    want, ws = _xla(np.concatenate([xa, xb], 1), (Z, Y, X), w, sc, sh, b, True,
                    emit_stats)
    assert_within_one_ulp(got, want)
    if emit_stats:
        assert_stats_close(gs, ws)


def _upsample2(xb_lo, lo):
    Zl, Yl, Xl = lo
    x4 = xb_lo.reshape(Zl, -1, Yl, Xl)
    x4 = x4.repeat(2, 0).repeat(2, 2).repeat(2, 3)
    return x4.reshape(2 * Zl, -1, 4 * Yl * Xl)


@pytest.mark.parametrize("emit_stats", [False, True])
def test_upconv_plain_matches_conv_xla(rng, emit_stats):
    """[skip, nearest_x2(low)] concat order and the channel split."""
    Z, Y, X, ca, cb, cout = 4, 8, 32, 8, 16, 16
    xa, w, sc, sh, b = _operands(rng, Z, Y, X, ca + cb, cout)
    xa = xa[:, :ca]
    xb_lo = _bf16(rng.normal(size=(Z // 2, cb, (Y // 2) * (X // 2))).astype(np.float32))
    got, gs = _port(tconv.conv3x3_fused_flat_upconv, [xa, xb_lo], (Z, Y, X), w, sc,
                    sh, b, True, emit_stats)
    xb = _upsample2(xb_lo, (Z // 2, Y // 2, X // 2))
    want, ws = _xla(np.concatenate([xa, xb], 1), (Z, Y, X), w, sc, sh, b, True,
                    emit_stats)
    assert_within_one_ulp(got, want)
    if emit_stats:
        assert_stats_close(gs, ws)


def _assert_within_pallas_noise(port, pallas, xla):
    """The Pallas kernel folds the affine into bf16 weights (a*W, x + b/a),
    so it deviates from _conv_xla by its own rounding noise; the port (which
    computes _conv_xla) may deviate from it by at most twice that noise,
    plus one bf16 ulp at the output's largest magnitude for the case where
    the Pallas path happens to be exact."""
    noise = np.abs(pallas - xla).max()
    dev = np.abs(port - pallas).max()
    assert dev <= 2.0 * noise + _ulp(np.abs(xla).max()), (dev, noise)


@pytest.mark.parametrize("mode,cin,X", [("flat", 1, 32), ("flat", 8, 128),
                                        ("flat", 16, 128), ("parts", 16, 128),
                                        ("upconv", 24, 128)])
def test_plain_within_pallas_noise(rng, monkeypatch, mode, cin, X):
    monkeypatch.setenv("KM_FORCE_FAST_CONV", "1")
    Z, Y, cout = 4, (16 if mode == "upconv" else 8), 16
    x, w, sc, sh, b = _operands(rng, Z, Y, X, cin, cout)
    sp = (Z, Y, X)
    jw, jsc, jsh, jb = (jnp.asarray(v) for v in (w, sc, sh, b))
    if mode == "flat":
        xs, xcat = [x], x
        pal = jconv.conv3x3_fused_flat(jnp.asarray(x).astype(jnp.bfloat16), sp, jw,
                                       jsc, jsh, jb, emit_stats=True)
        fn = tconv.conv3x3_fused_flat
    elif mode == "parts":
        xs, xcat = [x[:, :8], x[:, 8:]], x
        pal = jconv.conv3x3_fused_flat_parts(
            *(jnp.asarray(v).astype(jnp.bfloat16) for v in xs), sp, jw, jsc, jsh, jb,
            emit_stats=True)
        fn = tconv.conv3x3_fused_flat_parts
    else:
        xb_lo = _bf16(rng.normal(size=(Z // 2, 16, (Y // 2) * (X // 2))).astype(np.float32))
        xs = [x[:, :8], xb_lo]
        xcat = np.concatenate([x[:, :8], _upsample2(xb_lo, (Z // 2, Y // 2, X // 2))], 1)
        pal = jconv.conv3x3_fused_flat_upconv(
            *(jnp.asarray(v).astype(jnp.bfloat16) for v in xs), sp, jw, jsc, jsh, jb,
            emit_stats=True)
        fn = tconv.conv3x3_fused_flat_upconv
    pal_out = np.asarray(pal[0].astype(jnp.float32))
    pal_stats = [np.asarray(s) for s in pal[1]]
    got, gs = _port(fn, xs, sp, w, sc, sh, b, True, True)
    want, ws = _xla(xcat, sp, w, sc, sh, b, True, True)
    _assert_within_pallas_noise(got, pal_out, want)
    for g, p, x_ in zip(gs, pal_stats, ws):
        _assert_within_pallas_noise(g, p, x_)


def test_plain_on_cpu_ignores_tf32_flag():
    """The plain conv is an fp32 oracle: it refuses to run on a GPU with
    cuDNN TF32 on (checked on the card), and runs on the CPU regardless of
    the flag."""
    x = torch.zeros((2, 1, 64), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 3, 1, 2))
    out = tconv.conv3x3_fused_flat(x, (2, 8, 8), w)
    assert out.shape == (2, 2, 64) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("mode,blocks", [("flat", (8, 8, 16, 16, 32, 32, 64, 64, 64)),
                                         ("igrad", (8, 8, 16, 16, 32, 32, 64, 64, 64)),
                                         ("res", (32, 32, 32, 32, 32, 32, 64, 64, 64)),
                                         ("tconv", (32, 32, 32, 32, 32, 32, 64, 64, 64))])
def test_cout_block_per_form(mode, blocks):
    """The Cout block each mode launches its tensor-core form with: the
    forward conv (8 input channels or more) and the input gradient the
    smallest of 8, 16, 32, 64 that holds Cout, else 64; the residual and
    transposed forms 32 or 64, the only instantiations ``csrc/conv3d.cu``
    builds for them."""
    form = tconv._FORMS[mode].form
    form = tconv.FORM_PLAIN if form is None else form
    couts = (1, 8, 9, 16, 17, 32, 33, 64, 200)
    assert tuple(tconv.n_block(c, form) for c in couts) == blocks

