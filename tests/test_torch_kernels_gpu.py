"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one. This file imports neither jax nor keymorph_tpu, and defines its
own fixtures, so it runs on a machine with only PyTorch and the CUDA toolkit
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

The kernels build from ``keymorph_tpu_torch/csrc`` at first use. Shapes are
ragged against each kernel's tiles on purpose.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    import keymorph_tpu_torch

    keymorph_tpu_torch.disable_tf32()
    return torch.device("cuda")


def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _ulp(v):
    """bf16 spacing at each value: 2^(e - 8) for |v| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.parametrize("mode", ["flat", "parts", "upconv"])
def test_conv_kernel_matches_plain(rng, dev, mode):
    """<= 1 bf16 ulp per output (the same fp32 sum in another order, then
    rounded to bf16; plus 1e-6 of the range for outputs that cancel to near
    zero); stats within 1e-5 of the largest channel value."""
    from keymorph_tpu_torch.ops.cuda import conv3d

    Z, Y, X = 6, 12, 40  # ragged against the kernel's 4 x 8 x 32 tile
    ca, cb, cout = 8, (0 if mode == "flat" else 16), 24
    xa = _bf16(rng, Z, ca, Y * X).to(dev)
    if mode == "upconv":
        xs = [xa, _bf16(rng, Z // 2, cb, (Y // 2) * (X // 2)).to(dev)]
    elif mode == "parts":
        xs = [xa, _bf16(rng, Z, cb, Y * X).to(dev)]
    else:
        xs = [xa]
    cin = ca + cb
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2, device=dev)
    sc = torch.tensor(rng.uniform(0.5, 1.5, cin).astype(np.float32), device=dev)
    sh = torch.tensor(rng.normal(size=cin).astype(np.float32) * 0.3, device=dev)
    b = torch.tensor(rng.normal(size=cout).astype(np.float32) * 0.1, device=dev)
    kern, plain = {
        "flat": (conv3d.conv3x3_fused_flat, conv3d.conv3x3_fused_flat_plain),
        "parts": (conv3d.conv3x3_fused_flat_parts, conv3d.conv3x3_fused_flat_parts_plain),
        "upconv": (conv3d.conv3x3_fused_flat_upconv, conv3d.conv3x3_fused_flat_upconv_plain),
    }[mode]
    n0 = kern.launches
    k_out, k_stats = kern(*xs, (Z, Y, X), w, sc, sh, b, emit_stats=True)
    p_out, p_stats = plain(*xs, (Z, Y, X), w, sc, sh, b, emit_stats=True)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    k, p = k_out.float(), p_out.float()
    bound = torch.maximum(_ulp(p), _ulp(k)) + 1e-6 * p.abs().max()
    assert bool(((k - p).abs() <= bound).all()), (k - p).abs().max().item()
    for a, c in zip(k_stats, p_stats):
        assert bool(((a - c).abs() <= 1e-5 * c.abs().max()).all())


def test_tps_kernel_matches_plain(rng, dev):
    """fp32 sums over T = 130 control points in another order: abs 2e-5."""
    from keymorph_tpu_torch.ops.cuda import tpsflow
    from keymorph_tpu_torch.transforms import solvers

    src = torch.tensor(rng.uniform(-0.8, 0.8, (2, 130, 3)).astype(np.float32), device=dev)
    dst = src + torch.tensor(rng.normal(0, 0.08, (2, 130, 3)).astype(np.float32), device=dev)
    theta = solvers.fit_tps(src, dst, torch.tensor([0.1, 1.0], device=dev)).contiguous()
    got = tpsflow.tps_planes(theta, src, (17, 9, 33))
    want = tpsflow.tps_planes_plain(theta, src, (17, 9, 33))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_kernel_matches_plain(rng, dev, mode):
    """The kernel rounds every operation in the plain version's order:
    bit-exact, for flows far outside the volume too."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    img = torch.tensor(rng.random((2, 3, 20, 24, 28), dtype=np.float32), device=dev)
    planes = torch.tensor(rng.uniform(-1.6, 1.6, (2, 3, 18, 16, 40)).astype(np.float32),
                          device=dev)
    got = resample3d.warp_planes(img, planes, mode)
    want = resample3d.warp_planes_plain(img, planes, mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_wrappers_raise_instead_of_falling_back(dev):
    """A CUDA tensor the kernel does not take raises; it never falls back
    to the plain version."""
    from keymorph_tpu_torch.ops.cuda import conv3d, resample3d, tpsflow

    calls = conv3d.conv3x3_fused_flat_plain.calls
    with pytest.raises(TypeError):
        conv3d.conv3x3_fused_flat(torch.zeros((2, 1, 64), device=dev), (2, 8, 8),
                                  torch.zeros((3, 3, 3, 1, 2), device=dev))
    assert conv3d.conv3x3_fused_flat_plain.calls == calls
    with pytest.raises(ValueError):
        resample3d.warp_planes(torch.zeros((1, 1, 4, 4, 4), device=dev),
                               torch.zeros((1, 3, 4, 4, 4), device=dev).transpose(2, 3))
    with pytest.raises(TypeError):
        tpsflow.tps_planes(torch.zeros((1, 8, 3), device=dev, dtype=torch.float64),
                           torch.zeros((1, 4, 3), device=dev, dtype=torch.float64),
                           (4, 4, 4))
