"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one. This file imports neither jax nor keymorph_tpu, and defines its
own fixtures, so it runs on a machine with only PyTorch and the CUDA toolkit
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

The kernels build from ``keymorph_tpu_torch/csrc`` at first use. Shapes are
ragged against each kernel's tiles on purpose.
"""

import math

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


# The conv kernel sums on the tensor cores: products of bf16 values are exact
# in fp32, the fp32 sum is taken in another order than the plain version's and
# its partial sums are not each rounded to nearest. A stored bf16 output is
# therefore within one bf16 ulp of the plain version's, plus CONV_FLOOR of the
# range for outputs whose terms cancel (measured need at K = 27*384 on an
# NVIDIA H100 80GB HBM3: 3.4e-6; chip_smoke.py phase 1 prints it).
CONV_FLOOR = 1e-5


def _conv_close(k, p):
    k, p = k.float(), p.float()
    bound = torch.maximum(_ulp(p), _ulp(k)) + CONV_FLOOR * p.abs().max()
    assert bool(((k - p).abs() <= bound).all()), (k - p).abs().max().item()


def _stats_close(k_out, k_stats, p_out, p_stats):
    """The kernel's stats are the fp32 (mean, mean-square) of ITS stored
    outputs (1e-5 of the largest value: another summation order), and differ
    from the plain version's by no more than the outputs do on average."""
    from keymorph_tpu_torch.ops.cuda.conv3d import channel_stats

    own = channel_stats(k_out)
    k, p = k_out.float(), p_out.float()
    slack = ((k - p).abs().mean(dim=(0, 2)), (k * k - p * p).abs().mean(dim=(0, 2)))
    for got, mine, want, d in zip(k_stats, own, p_stats, slack):
        assert bool(((got - mine).abs() <= 1e-5 * mine.abs().max()).all())
        assert bool(((got - want).abs() <= d + 1e-5 * want.abs().max()).all())


def _forms():
    from keymorph_tpu_torch.ops.cuda import conv3d

    return {"flat": (conv3d.conv3x3_fused_flat, conv3d.conv3x3_fused_flat_plain),
            "parts": (conv3d.conv3x3_fused_flat_parts, conv3d.conv3x3_fused_flat_parts_plain),
            "upconv": (conv3d.conv3x3_fused_flat_upconv, conv3d.conv3x3_fused_flat_upconv_plain)}


def _sources(rng, dev, mode, spatial, ca, cb):
    Z, Y, X = spatial
    xs = [_bf16(rng, Z, ca, Y * X).to(dev)]
    if mode == "upconv":
        xs.append(_bf16(rng, Z // 2, cb, (Y // 2) * (X // 2)).to(dev))
    elif mode == "parts":
        xs.append(_bf16(rng, Z, cb, Y * X).to(dev))
    return xs


@pytest.mark.parametrize("mode", ["flat", "parts", "upconv"])
def test_conv_kernel_matches_plain(rng, dev, mode):
    """<= 1 bf16 ulp per output (plus CONV_FLOOR of the range for outputs
    that cancel to near zero); stats as :func:`_stats_close` says."""
    Z, Y, X = 6, 12, 40  # ragged against the kernel's 2 x 4 x 64 tile
    ca, cb, cout = 8, (0 if mode == "flat" else 16), 24
    xs = _sources(rng, dev, mode, (Z, Y, X), ca, cb)
    cin = ca + cb
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2, device=dev)
    sc = torch.tensor(rng.uniform(0.5, 1.5, cin).astype(np.float32), device=dev)
    sh = torch.tensor(rng.normal(size=cin).astype(np.float32) * 0.3, device=dev)
    b = torch.tensor(rng.normal(size=cout).astype(np.float32) * 0.1, device=dev)
    kern, plain = _forms()[mode]
    n0 = kern.launches
    k_out, k_stats = kern(*xs, (Z, Y, X), w, sc, sh, b, emit_stats=True)
    p_out, p_stats = plain(*xs, (Z, Y, X), w, sc, sh, b, emit_stats=True)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    _conv_close(k_out, p_out)
    _stats_close(k_out, k_stats, p_out, p_stats)


RAGGED = [
    # spatial, form, ca, cb, cout, affine, bias, relu, stats
    ((1, 6, 5), "flat", 1, 0, 3, True, True, True, True),        # Cin < 8: the FMA kernel
    ((1, 4, 33), "flat", 8, 0, 16, False, False, False, False),
    ((3, 5, 70), "flat", 24, 0, 72, True, False, True, True),
    ((2, 3, 5), "flat", 200, 0, 256, False, True, False, True),
    ((2, 8, 32), "flat", 24, 0, 16, True, True, True, True),     # 16-byte loads, 32-wide tile
    ((4, 6, 16), "flat", 8, 0, 3, True, True, False, True),      # 16-wide tile
    ((2, 4, 70), "parts", 24, 8, 72, True, True, True, True),
    ((1, 5, 33), "parts", 1, 8, 16, False, False, True, False),
    ((2, 4, 64), "parts", 8, 200, 3, True, False, False, True),
    ((2, 6, 70), "upconv", 24, 8, 16, True, True, True, True),
    ((4, 8, 64), "upconv", 8, 24, 72, True, True, True, True),   # 16-byte loads at half res
    ((2, 2, 6), "upconv", 1, 3, 3, True, True, True, True),      # the FMA kernel's upconv
    ((4, 16, 32), "upconv", 200, 8, 256, False, False, True, True),
]


@pytest.mark.parametrize("spatial,mode,ca,cb,cout,affine,bias,relu,stats", RAGGED)
def test_conv_kernel_ragged_shapes_and_options(rng, dev, spatial, mode, ca, cb, cout, affine,
                                               bias, relu, stats):
    """Channels not multiples of 8, 16 or 64, Z = 1, X = 5, 33, 70, all
    three forms, with and without affine, bias, ReLU and stats."""
    xs = _sources(rng, dev, mode, spatial, ca, cb)
    cin = ca + cb
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(cin),
                     device=dev)
    sc = sh = b = None
    if affine:
        sc = torch.tensor(rng.uniform(0.5, 1.5, cin).astype(np.float32), device=dev)
        sh = torch.tensor(rng.normal(size=cin).astype(np.float32) * 0.3, device=dev)
    if bias:
        b = torch.tensor(rng.normal(size=cout).astype(np.float32) * 0.1, device=dev)
    kern, plain = _forms()[mode]
    k = kern(*xs, spatial, w, sc, sh, b, relu=relu, emit_stats=stats)
    p = plain(*xs, spatial, w, sc, sh, b, relu=relu, emit_stats=stats)
    torch.cuda.synchronize()
    if stats:
        _conv_close(k[0], p[0])
        _stats_close(k[0], k[1], p[0], p[1])
    else:
        _conv_close(k, p)


def test_conv_kernel_against_float64_at_the_longest_sums(rng, dev):
    """K = 27 * 384 (the U-Net's d0c1, as an upconv): kernel and plain
    version each against a float64 conv of the same bf16 operands. A correctly
    rounded result is within half a bf16 ulp (2^-8 relative); both are given
    CONV_FLOOR of the range on top for the fp32 sums."""
    import torch.nn.functional as F

    from keymorph_tpu_torch.ops.cuda import conv3d

    Z, Y, X = 4, 8, 64
    xa = torch.relu(_bf16(rng, Z, 128, Y * X)).to(dev)
    xb = torch.relu(_bf16(rng, Z // 2, 256, (Y // 2) * (X // 2))).to(dev)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 384, 128)).astype(np.float32) / np.sqrt(27 * 384),
                     device=dev)
    sc = torch.tensor(rng.uniform(0.5, 1.5, 384).astype(np.float32), device=dev)
    sh = torch.tensor(rng.normal(size=384).astype(np.float32) * 0.3, device=dev)
    k = conv3d.conv3x3_fused_flat_upconv(xa, xb, (Z, Y, X), w, sc, sh, relu=False)
    p = conv3d.conv3x3_fused_flat_upconv_plain(xa, xb, (Z, Y, X), w, sc, sh, relu=False)
    full = torch.cat([xa, conv3d.upsample_nearest_flat(xb, (Z // 2, Y // 2, X // 2), (Z, Y, X))],
                     dim=1).float()
    u = (full * sc[None, :, None] + sh[None, :, None]).to(torch.bfloat16).double()
    ref = F.conv3d(u.reshape(Z, 384, Y, X).permute(1, 0, 2, 3)[None],
                   w.to(torch.bfloat16).double().permute(4, 3, 0, 1, 2), padding=1)[0]
    ref = ref.permute(1, 0, 2, 3).reshape(Z, 128, Y * X)
    torch.cuda.synchronize()
    for got in (k, p):
        err = (got.double() - ref).abs()
        assert bool((err <= 2.0 ** -8 * ref.abs() + CONV_FLOOR * ref.abs().max()).all()), \
            err.max().item()


def _splines(rng, dev, B, T, lmbda):
    """B different splines: control points, and a theta fitted to them (drawn
    at random below 4 control points, where the fit's system is singular)."""
    from keymorph_tpu_torch.transforms import solvers

    src = torch.tensor(rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32), device=dev)
    if T < 4:
        return torch.tensor(rng.normal(0, 0.3, (B, T + 4, 3)).astype(np.float32), device=dev), src
    dst = src + torch.tensor(rng.normal(0, 0.08, (B, T, 3)).astype(np.float32), device=dev)
    lm = torch.tensor(lmbda, device=dev) if isinstance(lmbda, list) else lmbda
    return solvers.fit_tps(src, dst, lm).contiguous(), src


# The forward kernels give a thread 8 consecutive x positions of one grid row
# (identity grid; stored four at a time where W % 4 == 0) or 4 points (points
# mode), and 256 threads a block; the backward cuts the grid into groups of
# up to 1024 points of whole rows (a row longer than 512 is cut) and deals
# them to at most 2112 blocks, a warp takes a piece of a row and a lane up to
# 4 control points. T is walked in tiles of 512 (forward) and of 32-128
# (backward, which stages its groups anew for every tile).
TPS_SHAPES = [
    # B, T, spatial, lmbda
    (2, 130, (17, 9, 33), [0.1, 1.0]),   # W not a multiple of 8 or 4; two splines
    (2, 37, (9, 10, 11), [0.5, 0.05]),
    (1, 8, (7, 1, 13), 0.5),             # a size-1 axis (step 0)
    (1, 5, (1, 5, 9), 0.5),
    (1, 16, (4, 6, 1), 0.5),             # W = 1: one live point per thread
    (1, 1, (3, 4, 3), 0.5),              # T = 1, W < 4: less than one store
    (1, 64, (8, 8, 16), 1.0),            # W % 4 == 0: 16-byte stores
    (1, 128, (6, 10, 32), 1.0),
    (2, 64, (5, 3, 12), [1.0, 0.2]),     # W % 4 == 0 but not % 8: half a thread's points
    (1, 96, (2, 2, 600), 1.0),           # W > 512: the backward cuts the row
    (1, 160, (3, 3, 40), 1.0),           # the backward takes 3 control points a lane
    (1, 512, (4, 4, 7), 1.0),
    (1, 2048, (2, 3, 6), 1.0),           # the most control points: 4 tiles of T
    (1, 5, (300, 300, 1), 0.5),          # 2813 groups of 32 rows: a backward block takes two
    (1, 130, (96, 96, 300), 1.0),        # 3072 groups and 5 tiles of T
]


@pytest.mark.parametrize("B,T,spatial,lmbda", TPS_SHAPES)
def test_tps_kernel_matches_plain(rng, dev, B, T, spatial, lmbda):
    """fp32 sums over T control points in another order, and sqrt and log
    taken as one special-function instruction each: abs 2e-5 against the plain
    version; against the float64 evaluation of the same formula, 2e-5 or 4x
    the plain version's own distance from it."""
    from keymorph_tpu_torch.ops.cuda import tpsflow

    theta, src = _splines(rng, dev, B, T, lmbda)
    n0 = tpsflow.tps_planes.launches
    got = tpsflow.tps_planes(theta, src, spatial)
    want = tpsflow.tps_planes_plain(theta, src, spatial)
    ref = tpsflow.tps_planes_plain(theta, src, spatial, dtype=torch.float64)
    torch.cuda.synchronize()
    assert tpsflow.tps_planes.launches == n0 + 1
    assert got.shape == (B, 3, *spatial) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 2e-5
    assert (got - ref).abs().max().item() <= max(2e-5, 4 * (want - ref).abs().max().item())


# The warp kernels give a thread 4 output voxels 256 apart (1024 voxels a
# tile, the ragged last tile masked) on a grid of the blocks resident at once,
# each walking a contiguous range of tiles; no access needs more than 4-byte
# alignment, so planes and cotangent at any storage offset are served as they
# are. Source sizes are powers of two so that the border and rounding ties
# below are exact.
WARP_SHAPES = [
    # B, C, source, output, storage offset of planes and cotangent (floats)
    (1, 1, (4, 4, 4), (1, 1, 1), 0),          # N = 1: one voxel of a thread
    (1, 3, (4, 8, 16), (1, 1, 3), 0),         # N = 3
    (1, 1, (8, 8, 8), (1, 1, 5), 0),          # N = 5
    (2, 3, (16, 8, 32), (3, 11, 31), 0),      # N = 1023: a tile less one voxel
    (1, 14, (16, 16, 16), (5, 5, 41), 0),     # N = 1025: a tile and one voxel; C = 14
    (2, 1, (8, 16, 32), (7, 9, 11), 0),       # N % 4 != 0
    (2, 3, (16, 32, 32), (18, 16, 40), 0),    # 12 tiles a batch item
    (2, 3, (16, 8, 32), (18, 16, 40), 1),     # planes (and cotangent) 4 bytes off 16
    (1, 14, (16, 32, 8), (16, 16, 16), 3),    # C = 14, 12 bytes off 16
    (1, 1, (64, 64, 64), (96, 96, 96), 0),    # 864 tiles: blocks walk several
]


def _warp_inputs(rng, dev, B, C, src, out, offset):
    """Source volume, planes and cotangent on the card. Planes are random in
    [-1.6, 1.6] (far outside the volume too) with exact ties laid in per
    batch item at fixed voxels: v == 0 on axis 0, v == S - 1 on axis 2
    (the top edge), v == 1.5 and 2.5 on axis 1 (nearest rounds them to 2).
    Planes and cotangent start ``offset`` floats into their storage."""
    planes = rng.uniform(-1.6, 1.6, (B, 3, *out)).astype(np.float32)
    flat = planes.reshape(B, 3, -1)
    n = flat.shape[2]

    def p_at(v, s):
        return (2.0 * v + 1.0) / s - 1.0

    for b in range(B):
        flat[b, 0, b % n::7] = p_at(0.0, src[0])
        flat[b, 2, (b + 3) % n::7] = p_at(src[2] - 1.0, src[2])
        if src[1] >= 4:
            flat[b, 1, (b + 1) % n::5] = p_at(1.5, src[1])
            flat[b, 1, (b + 2) % n::5] = p_at(2.5, src[1])

    def at_offset(a):
        t = torch.empty(a.size + offset, device=dev)[offset:].view(a.shape)
        t.copy_(torch.tensor(a))
        return t

    img = torch.tensor(rng.random((B, C, *src), dtype=np.float32), device=dev)
    g = at_offset(rng.normal(size=(B, C, *out)).astype(np.float32))
    return img, at_offset(planes), g


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("B,C,src,out,offset", WARP_SHAPES)
def test_warp_kernel_matches_plain(rng, dev, mode, B, C, src, out, offset):
    """The kernel rounds every operation in the plain version's order:
    bit-exact, at every shape and storage offset, for flows far outside the
    volume and at the border and rounding ties too."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    img, planes, _ = _warp_inputs(rng, dev, B, C, src, out, offset)
    assert planes.is_contiguous() and (planes.data_ptr() % 16 == 0) == (offset == 0)
    n0 = resample3d.warp_planes.launches
    got = resample3d.warp_planes(img, planes, mode)
    want = resample3d.warp_planes_plain(img, planes, mode)
    torch.cuda.synchronize()
    assert resample3d.warp_planes.launches == n0 + 1
    assert got.shape == (B, C, *out)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if mode == "nearest" and src[1] >= 4 and math.prod(out) > 2:
        # v == 1.5 and 2.5 on axis 1 both take source row 2
        yrow = img[0, 0, :, 2, :]
        i = 1 % math.prod(out)
        z, x = (torch.round(((planes[0, a].flatten()[i] + 1) * src[a] - 1) / 2)
                .clamp(0, src[a] - 1).long() for a in (0, 2))
        assert got[0, 0].flatten()[i] == yrow[z, x]


def test_warp_kernels_take_an_empty_batch(dev):
    """B = 0 (or no output voxels) launches nothing and returns empty."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    for img, planes in ((torch.zeros((0, 2, 4, 4, 4), device=dev),
                         torch.zeros((0, 3, 5, 6, 7), device=dev)),
                        (torch.zeros((1, 2, 4, 4, 4), device=dev),
                         torch.zeros((1, 3, 0, 6, 7), device=dev))):
        out = resample3d.warp_planes(img, planes)
        g = resample3d.warp_planes_grad(img, planes, torch.zeros_like(out))
        torch.cuda.synchronize()
        assert out.shape == (img.shape[0], 2, *planes.shape[2:])
        assert g.shape == planes.shape


@pytest.mark.parametrize("shape", [((6, 12, 40), 24, 8, 0), ((6, 12, 40), 24, 8, 16),
                                   ((5, 7, 9), 3, 3, 0), ((1, 4, 33), 16, 8, 0),
                                   ((3, 5, 70), 72, 24, 0), ((2, 3, 5), 256, 200, 0),
                                   ((2, 4, 70), 72, 24, 8), ((2, 8, 64), 16, 64, 128),
                                   ((1, 6, 5), 16, 1, 0)])
def test_conv_input_grad_kernel_matches_plain(rng, dev, shape):
    """The input-gradient kernel (one tensor, and split into the two halves
    of a two-source conv) within one bf16 ulp of its plain version, on shapes
    ragged against the tiles and the channel blocks; cotangents of 3 channels
    (padded to one 16-channel chunk) to 256, gradients of 1 channel to 200,
    Z = 1."""
    from keymorph_tpu_torch.ops.cuda import conv3d

    (Z, Y, X), cg, ca, cb = shape
    g_v = _bf16(rng, Z, cg, Y * X).to(dev)
    w = torch.tensor(rng.normal(size=(3, 3, 3, ca + cb, cg)).astype(np.float32) * 0.2, device=dev)
    n0 = conv3d.conv3x3_input_grad.launches
    got = conv3d.conv3x3_input_grad(g_v, (Z, Y, X), w, ca if cb else None)
    want = conv3d.conv3x3_input_grad_plain(g_v, (Z, Y, X), w, ca if cb else None)
    torch.cuda.synchronize()
    assert conv3d.conv3x3_input_grad.launches == n0 + 1
    assert (got[1] is None) == (cb == 0)
    for k, p in zip(got, want):
        if k is None:
            continue
        assert k.shape == p.shape and k.dtype == torch.bfloat16
        _conv_close(k, p)


@pytest.mark.parametrize("mode", ["flat", "upconv"])
def test_conv_backward_through_the_kernels_matches_plain(rng, dev, mode):
    """backward() of the fused conv on the card (forward recompute and input
    gradient on the kernels, the reductions in PyTorch) against the same
    Function on the plain versions: every gradient within 2e-2 of its
    largest value (bf16 cotangents and outputs may differ by one ulp)."""
    from keymorph_tpu_torch.ops.cuda import conv3d

    Z, Y, X, ca, cb, cout = 6, 12, 40, 8, (0 if mode == "flat" else 16), 24
    xs = [_bf16(rng, Z, ca, Y * X).to(dev)]
    if cb:
        xs.append(_bf16(rng, Z // 2, cb, (Y // 2) * (X // 2)).to(dev))
    cin = ca + cb
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2, device=dev)
    sc = torch.tensor(rng.uniform(0.5, 1.5, cin).astype(np.float32), device=dev)
    sh = torch.tensor(rng.normal(size=cin).astype(np.float32) * 0.3, device=dev)
    kern, plain = ((conv3d.conv3x3_fused_flat, conv3d.conv3x3_fused_flat_plain) if mode == "flat"
                   else (conv3d.conv3x3_fused_flat_upconv, conv3d.conv3x3_fused_flat_upconv_plain))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (*xs, w, sc, sh)]
        out, (m, m2) = fn(*leaves[:len(xs)], (Z, Y, X), *leaves[len(xs):], emit_stats=True)
        ((out.float() ** 2).sum() + 50.0 * m.sum() + 20.0 * m2.sum()).backward()
        return [t.grad.float() for t in leaves]

    n0 = conv3d.conv3x3_input_grad.launches
    got, want = grads(kern), grads(plain)
    torch.cuda.synchronize()
    assert conv3d.conv3x3_input_grad.launches == n0 + 1
    for g, p in zip(got, want):
        assert g.shape == p.shape
        assert (g - p).abs().max().item() <= 2e-2 * p.abs().max().item()


@pytest.mark.parametrize("B,T,spatial,lmbda", TPS_SHAPES)
def test_tps_backward_kernel_matches_plain_and_float64(rng, dev, B, T, spatial, lmbda):
    """T not a multiple of the kernel's 32-128 control points a warp, N not a
    multiple of its 1024-point blocks, an axis of size 1. Against the plain
    version in float64: 1e-5 of the largest value (fp32 sums over N points in
    a tree); the fp32 plain version is itself that far from float64."""
    from keymorph_tpu_torch.ops.cuda import tpsflow

    theta, src = _splines(rng, dev, B, T, lmbda)
    g = torch.tensor(rng.normal(size=(B, 3, *spatial)).astype(np.float32), device=dev)
    n0 = tpsflow.tps_planes_bwd.launches
    kt, kc = tpsflow.tps_planes_bwd(theta, src, spatial, g)
    rt, rc = tpsflow.tps_planes_bwd_plain(theta, src, spatial, g, dtype=torch.float64)
    torch.cuda.synchronize()
    assert tpsflow.tps_planes_bwd.launches == n0 + 1
    assert kt.shape == (B, T + 4, 3) and kc.shape == (B, T, 3)
    assert (kt - rt).abs().max().item() <= 1e-5 * max(rt.abs().max().item(), 1.0)
    assert (kc - rc).abs().max().item() <= 1e-5 * max(rc.abs().max().item(), 1.0)
    # and through autograd: tps_planes(...).backward launches the same kernel
    th, c = theta.clone().requires_grad_(True), src.clone().requires_grad_(True)
    tpsflow.tps_planes(th, c, spatial).backward(g)
    torch.cuda.synchronize()
    assert tpsflow.tps_planes_bwd.launches == n0 + 2
    assert torch.equal(th.grad, kt) and torch.equal(c.grad, kc)


@pytest.mark.parametrize("N,T", [(990, 37), (5049, 37), (1, 1), (1023, 5), (1025, 64),
                                  (4097, 128), (300, 512), (2000, 2048)])
def test_tps_flow_points_kernel_matches_plain(rng, dev, N, T):
    """The TPS kernel's points mode at ragged N (not a multiple of its
    1024-point block, below one block, one point), two splines: abs 2e-5
    against the plain version, as the planes mode; against float64, 2e-5 or 4x
    the plain version's own distance."""
    from keymorph_tpu_torch.ops.cuda import tpsflow
    from keymorph_tpu_torch.transforms import solvers

    theta, src = _splines(rng, dev, 2, T, [0.5, 1.0])
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (2, N, 3)).astype(np.float32), device=dev)
    n0, p0 = tpsflow.tps_flow.launches, tpsflow.tps_flow_plain.calls
    got = solvers.tps_eval_chunked(theta, src, pts)  # dispatches to the kernel
    want = tpsflow.tps_flow_plain(theta, src, pts)
    torch.cuda.synchronize()
    assert tpsflow.tps_flow.launches == n0 + 1 and tpsflow.tps_flow_plain.calls == p0 + 1
    assert got.shape == (2, N, 3)
    assert (got - want).abs().max().item() <= 2e-5
    ref = tpsflow.tps_flow_plain(theta, src, pts, dtype=torch.float64)
    assert (got - ref).abs().max().item() <= max(2e-5, 4 * (want - ref).abs().max().item())


def test_tps_kernels_against_float64_at_the_smallest_lmbda(rng, dev):
    """lmbda 1e-6, the bottom of the range training draws from: the spline's
    weights are at their largest and cancel, and neither kernel nor plain
    version is near the other any more. Each kernel is held against the
    float64 evaluation of the formula: as near as 4x its plain version's own
    distance (or the bars of the tests above)."""
    from keymorph_tpu_torch.ops.cuda import tpsflow

    spatial = (12, 10, 24)
    theta, src = _splines(rng, dev, 2, 64, 1e-6)
    f64 = torch.float64

    def held(got, plain, ref, floor):
        top = ref.abs().max().item()
        d_k, d_p = (got - ref).abs().max().item(), (plain - ref).abs().max().item()
        assert d_k <= max(floor(top), 4 * d_p), (d_k, d_p)

    held(tpsflow.tps_planes(theta, src, spatial), tpsflow.tps_planes_plain(theta, src, spatial),
         tpsflow.tps_planes_plain(theta, src, spatial, dtype=f64), lambda top: 2e-5)
    pts = torch.tensor(rng.uniform(-1.0, 1.0, (2, 3000, 3)).astype(np.float32), device=dev)
    held(tpsflow.tps_flow(theta, src, pts), tpsflow.tps_flow_plain(theta, src, pts),
         tpsflow.tps_flow_plain(theta, src, pts, dtype=f64), lambda top: 2e-5)
    g = torch.tensor(rng.normal(size=(2, 3, *spatial)).astype(np.float32), device=dev)
    for k, p, r in zip(tpsflow.tps_planes_bwd(theta, src, spatial, g),
                       tpsflow.tps_planes_bwd_plain(theta, src, spatial, g),
                       tpsflow.tps_planes_bwd_plain(theta, src, spatial, g, dtype=f64)):
        held(k, p, r, lambda top: 1e-5 * top)


@pytest.mark.parametrize("B,C,src,out,offset", WARP_SHAPES)
def test_warp_gradient_kernel_matches_plain(rng, dev, B, C, src, out, offset):
    """The gradient to the planes, at every shape and storage offset, for flows
    that leave the volume and with exact clamp ties at both ends: 1e-5 of the
    largest value (the same fp32 terms, FMA-contracted in the kernel); ties
    carry half, outside is 0, the top edge exactly 0."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    img, planes, g = _warp_inputs(rng, dev, B, C, src, out, offset)
    n0 = resample3d.warp_planes_grad.launches
    got = resample3d.warp_planes_grad(img, planes, g)
    want = resample3d.warp_planes_grad_plain(img, planes, g)
    torch.cuda.synchronize()
    assert resample3d.warp_planes_grad.launches == n0 + 1
    assert got.shape == (B, 3, *out)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    n = math.prod(out)
    outside = (planes < -1.0) | (planes > 1.0)
    assert (bool(outside.any()) or n < 8) and not bool(got[outside].any())
    for b in range(B):
        # the top edge of axis 2 (hi == lo): exactly 0
        assert not bool(got[b, 2].flatten()[(b + 3) % n::7].any())
    if n > 1:  # the tie at v == 0 on axis 0 carries half of a nonzero gradient
        assert bool(got[:, 0].flatten(1)[:, 0::7].any())
    # through autograd, with the image gradient as a plain scatter-add
    pe, im = planes.clone().requires_grad_(True), img.clone().requires_grad_(True)
    resample3d.warp_planes(im, pe).backward(g)
    torch.cuda.synchronize()
    assert resample3d.warp_planes_grad.launches == n0 + 2
    assert torch.equal(pe.grad, got) and im.grad.shape == img.shape


def test_training_step_on_the_card_dice_augment_batch(rng, dev):
    """A small training step on the kernels with what the smoke run's
    canonical step leaves out: batch 2, Dice on 3-channel one-hot labels (the
    warp and its gradient at C = 3), affine augmentation (the nearest warp),
    power keypoint weights and block checkpointing. No plain version may run;
    loss and grad_norm agree with the same step on the plain versions within
    5% (bf16 conv outputs may differ by one ulp, and the step amplifies it);
    the keypoint-consistency step runs on the kernels too."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.training.config import Config
    from keymorph_tpu_torch.training.train import (
        TrainState, make_kpconsistency_step, make_optimizer, make_train_step)

    S, K = (24, 20, 40), 8
    cfg = Config(num_keypoints=K, transform_type="tps_loguniform", loss_fn="dice", lr=1e-4,
                 max_train_keypoints=6, max_random_affine_augment_params=(0.1, 0.1, 0.2, 0.05),
                 kpconsistency_coeff=1.0)
    axes = [np.linspace(-1, 1, s) for s in S]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    blob = np.exp(-(zz ** 2 + (yy - 0.2) ** 2 + (xx + 0.1) ** 2) / 0.3)
    img = torch.tensor(np.stack([blob, blob[::-1].copy()])[:, None].astype(np.float32),
                       device=dev)
    labels = torch.tensor(rng.integers(0, 3, (2, *S)), device=dev)
    seg = torch.nn.functional.one_hot(labels, 3).movedim(-1, 1).float().contiguous()
    results = []
    for plain in (False, True):
        unet = TruncatedUNet3D(out_channels=K, f_maps=4, num_levels=3, num_truncated_layers=1,
                               dtype=torch.bfloat16, use_checkpoint=not plain)
        net = KeyMorphNet(init_weights(unet, torch.Generator().manual_seed(0)), K,
                          weight_keypoints="power").to(dev)
        state = TrainState.create(net, make_optimizer(cfg, net))
        step = make_train_step(net, cfg, plain=plain)
        kernels.reset_counters()
        state, m = step(state, torch.Generator().manual_seed(3), img, img.flip(0).contiguous(),
                        seg, seg.flip(0).contiguous(), 0.5, lmbda=torch.tensor([0.3, 2.0], device=dev),
                        keypoint_idx=np.arange(6))
        torch.cuda.synchronize()
        counts = kernels.counters()
        results.append((float(m["loss"]), float(m["grad_norm"])))
        assert all(np.isfinite(v) for v in results[-1])
        if plain:
            continue
        for name in ("conv3x3_fused_flat", "conv3x3_fused_flat_upconv", "conv3x3_input_grad",
                     "tps_planes", "tps_planes_bwd", "warp_planes", "warp_planes_grad"):
            assert counts[name]["launches"] > 0, name
        assert not any(c["plain_calls"] for c in counts.values()), counts
        kp = make_kpconsistency_step(net, cfg)
        state, km = kp(state, torch.Generator().manual_seed(4), img[:1], img[1:], 1.0)
        torch.cuda.synchronize()
        assert state.step == 2 and np.isfinite(float(km["kploss"]))
        assert not any(c["plain_calls"] for c in kernels.counters().values())
    (kl, kg), (pl, pg) = results
    assert 0.0 <= kl <= 1.0
    assert abs(kl - pl) <= 5e-2 * pl and abs(kg - pg) <= 5e-2 * pg + 1e-6, results


def test_wrappers_raise_instead_of_falling_back(dev):
    """A CUDA tensor the kernel does not take raises; it never falls back
    to the plain version."""
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.cuda import conv3d, resample3d, tpsflow

    before = {k: v["plain_calls"] for k, v in kernels.counters().items()}
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
    # the four kernels of the training slice
    with pytest.raises(TypeError):
        conv3d.conv3x3_input_grad(torch.zeros((2, 2, 64), device=dev), (2, 8, 8),
                                  torch.zeros((3, 3, 3, 1, 2), device=dev))
    theta, ctrl = torch.zeros((1, 8, 3), device=dev), torch.zeros((1, 4, 3), device=dev)
    with pytest.raises(ValueError):
        tpsflow.tps_planes_bwd(theta, ctrl, (4, 4, 4), torch.zeros((1, 3, 4, 4, 5), device=dev))
    with pytest.raises(ValueError):
        tpsflow.tps_flow(theta, ctrl, torch.zeros((1, 3, 10), device=dev).transpose(1, 2))
    with pytest.raises(ValueError):
        resample3d.warp_planes_grad(torch.zeros((1, 1, 4, 4, 4), device=dev),
                                    torch.zeros((1, 3, 4, 4, 4), device=dev),
                                    torch.zeros((1, 2, 4, 4, 4), device=dev))
    # the warp's 32-bit offsets: 2^31 voxels a channel (1291^3), source or
    # output, raise on the shapes alone (expanded views allocate nothing)
    big = torch.zeros(1, device=dev).expand(1, 1, 1291, 1291, 1291)
    small = torch.zeros((1, 3, 2, 2, 2), device=dev)
    for img, planes in ((big, small), (torch.zeros((1, 1, 2, 2, 2), device=dev),
                                       big.expand(1, 3, 1291, 1291, 1291))):
        with pytest.raises(ValueError, match="2\\^31"):
            resample3d.warp_planes(img, planes)
        with pytest.raises(ValueError, match="2\\^31"):
            resample3d.warp_planes_grad(img, planes, torch.zeros(1, device=dev).expand(
                1, 1, *planes.shape[2:]))
    assert {k: v["plain_calls"] for k, v in kernels.counters().items()} == before


def test_kernels_past_the_old_limits(rng, dev):
    """More than 2048 control points and more than 65535 batch items (the
    grid's y dimension, now walked by the kernels), each in one launch
    against the plain version: the TPS kernels at T = 4096 (the backward at
    200 x 200 x 8, where its rows of partial sums are fewer than 2112), and
    every TPS and warp wrapper at B = 70000 on 4^3, under the bars above.
    Over 4096 control points the forward kernels' and the plain versions'
    fp32 sums each lie more than 2e-5 from float64, in other orders, so there
    the forward kernels are held by the float64 rule alone: 2e-5 or 4x the
    plain version's own distance."""
    from keymorph_tpu_torch.ops.cuda import resample3d, tpsflow

    theta, src = _splines(rng, dev, 1, 4096, 1.0)
    n0 = (tpsflow.tps_planes.launches, tpsflow.tps_flow.launches,
          tpsflow.tps_planes_bwd.launches)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (1, 3000, 3)).astype(np.float32), device=dev)
    spatial = (9, 10, 12)
    for got, want, ref in (
            (tpsflow.tps_flow(theta, src, pts), tpsflow.tps_flow_plain(theta, src, pts),
             tpsflow.tps_flow_plain(theta, src, pts, dtype=torch.float64)),
            (tpsflow.tps_planes(theta, src, spatial), tpsflow.tps_planes_plain(theta, src, spatial),
             tpsflow.tps_planes_plain(theta, src, spatial, dtype=torch.float64))):
        assert (got - ref).abs().max().item() <= max(2e-5, 4 * (want - ref).abs().max().item())
    spatial = (200, 200, 8)
    g = torch.tensor(rng.normal(size=(1, 3, *spatial)).astype(np.float32), device=dev)
    for k, p in zip(tpsflow.tps_planes_bwd(theta, src, spatial, g),
                    tpsflow.tps_planes_bwd_plain(theta, src, spatial, g)):
        assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()
    torch.cuda.synchronize()
    assert (tpsflow.tps_planes.launches, tpsflow.tps_flow.launches,
            tpsflow.tps_planes_bwd.launches) == tuple(n + 1 for n in n0)
    del g

    B, spatial = 70000, (4, 4, 4)
    theta, src = _splines(rng, dev, B, 6, 1.0)
    assert (tpsflow.tps_planes(theta, src, spatial)
            - tpsflow.tps_planes_plain(theta, src, spatial)).abs().max().item() <= 2e-5
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (B, 10, 3)).astype(np.float32), device=dev)
    assert (tpsflow.tps_flow(theta, src, pts)
            - tpsflow.tps_flow_plain(theta, src, pts)).abs().max().item() <= 2e-5
    g = torch.tensor(rng.normal(size=(B, 3, *spatial)).astype(np.float32), device=dev)
    for k, p in zip(tpsflow.tps_planes_bwd(theta, src, spatial, g),
                    tpsflow.tps_planes_bwd_plain(theta, src, spatial, g)):
        assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    img, planes, g = _warp_inputs(rng, dev, B, 2, spatial, spatial, 0)
    for mode in ("bilinear", "nearest"):
        torch.testing.assert_close(resample3d.warp_planes(img, planes, mode),
                                   resample3d.warp_planes_plain(img, planes, mode),
                                   atol=0, rtol=0)
    want = resample3d.warp_planes_grad_plain(img, planes, g)
    assert (resample3d.warp_planes_grad(img, planes, g)
            - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _rw_affines(B, dev):
    """Anisotropic voxel -> world affines, the moving one rotated (B, 4, 4)."""
    c, s = math.cos(0.2), math.sin(0.2)
    aff_f = torch.eye(4)
    aff_f[:3, :3] = torch.diag(torch.tensor([1.0, 1.25, 2.0]))
    aff_f[:3, 3] = torch.tensor([-40.0, -50.0, 30.0])
    aff_m = torch.eye(4)
    aff_m[:3, :3] = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ torch.diag(
        torch.tensor([1.1, 1.2, 1.9]))
    aff_m[:3, 3] = torch.tensor([-42.0, -48.0, 28.0])
    return aff_f.repeat(B, 1, 1).to(dev), aff_m.repeat(B, 1, 1).to(dev)


@pytest.mark.parametrize("align_type", ["affine", "rigid"])
def test_affine_register_warp_on_the_kernel_matches_plain(rng, dev, align_type):
    """Affine and rigid serving: align_pair's matrices, the planes from the
    matrix and the warp kernel on them, bit-exact with the plain warp on
    the same planes; the planes equal the flip of the affine grid."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.cuda import resample3d
    from keymorph_tpu_torch.ops.planes import affine_register_warp, planes_to_grid

    B, T, S = 2, 32, (20, 24, 36)
    pf = torch.tensor(rng.uniform(-0.7, 0.7, (B, T, 3)).astype(np.float32), device=dev)
    pm = pf + torch.tensor(rng.normal(0, 0.05, (B, T, 3)).astype(np.float32), device=dev)
    img = torch.tensor(rng.random((B, 1, 18, 22, 30)).astype(np.float32), device=dev)
    out = align_pair(pf, pm, align_type, S, compute_grid=True)
    planes_out = align_pair(pf, pm, align_type, S, compute_grid="planes")["planes"]
    inverse = torch.linalg.inv(out["matrix"])
    kernels.reset_counters()
    warped, planes = affine_register_warp(inverse, img, S)
    torch.cuda.synchronize()
    counts = kernels.counters()
    assert counts["warp_planes"]["launches"] == 1 and not counts["warp_planes"]["plain_calls"]
    assert torch.equal(warped, resample3d.warp_planes_plain(img, planes))
    assert (planes - planes_out).abs().max().item() <= 1e-5
    assert (planes_to_grid(planes_out) - out["grid"]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("centers", [None, 20])
def test_real_world_and_approximate_tps_on_the_kernel_match_plain(rng, dev, centers):
    """Real-world TPS (scanner millimetres, up to ~75 from the origin) and
    approximate TPS (20 of 48 centres): the grid through the points-mode
    kernel no further from the float64 evaluation than 4x the plain version
    or 1e-5, and from the plain version within twice the plain version's
    distance from float64 plus 1e-5 (normalized units: in millimetres the
    fp32 sum of w_t U_t is itself inexact, 3e-5 to 1e-4 at these shapes on
    an NVIDIA H100 80GB HBM3); the approximate planes through the
    identity-grid kernel within 1e-5 of the plain version."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops import coords
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.cuda import tpsflow
    from keymorph_tpu_torch.transforms import solvers

    B, T, S = 2, 48, (24, 28, 40)
    pf = torch.tensor(rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32), device=dev)
    pm = pf + torch.tensor(rng.normal(0, 0.04, (B, T, 3)).astype(np.float32), device=dev)
    lm = torch.tensor([0.1, 1.0], device=dev)
    aff_f, aff_m = _rw_affines(B, dev)
    kw = dict(lmbda=lm, tps_centers=centers, aff_f=aff_f, aff_m=aff_m, compute_grid=True)
    kernels.reset_counters()
    grid = align_pair(pf, pm, "tps", S, **kw)["grid"]
    torch.cuda.synchronize()
    assert kernels.counters()["tps_flow"]["launches"] == 1
    plain = align_pair(pf, pm, "tps", S, plain=True, **kw)["grid"]
    # float64: the same spline evaluated in double on the same fp32 fit
    rf = coords.convert_points_norm2real(pf, aff_f, S)
    rm = coords.convert_points_norm2real(pm, aff_m, S)
    n = centers or T
    theta = (solvers.fit_tps_approximate(rf, rm, lm, n) if centers
             else solvers.fit_tps(rf, rm, lm)).contiguous()
    pts = coords.convert_points_norm2real(coords.flat_norm_grid(S, device=dev).expand(B, -1, 3),
                                          aff_f, S)
    moved = tpsflow.tps_flow_plain(theta, rf[:, :n].contiguous(), pts, dtype=torch.float64)
    inv = torch.linalg.inv(aff_m.double())
    vox = (torch.cat([moved, torch.ones_like(moved[..., :1])], -1) @ inv.transpose(1, 2))[..., :3]
    ref = torch.flip((2.0 * (vox + 0.5) / torch.tensor(S, device=dev).double() - 1.0)
                     .reshape(B, *S, 3), dims=(-1,))
    d_plain = (grid - plain).abs().max().item()
    dk, dp = (grid.double() - ref).abs().max().item(), (plain.double() - ref).abs().max().item()
    assert dk <= max(1e-5, 4.0 * dp), (dk, dp)
    assert d_plain <= 2.0 * dp + 1e-5, (d_plain, dp)
    if centers:
        kw.update(aff_f=None, aff_m=None, compute_grid="planes")
        kernels.reset_counters()
        planes = align_pair(pf, pm, "tps", S, **kw)["planes"]
        torch.cuda.synchronize()
        assert kernels.counters()["tps_planes"]["launches"] == 1
        assert (planes - align_pair(pf, pm, "tps", S, plain=True, **kw)["planes"]).abs().max() <= 1e-5


def test_keymorph_serves_on_the_card(rng, dev):
    """The orchestrator on the card: affine, rigid and TPS grids and aligned
    points, no plain version run, every output on the card and finite."""
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels

    K, S = 8, (24, 20, 40)
    unet = init_weights(TruncatedUNet3D(out_channels=K, f_maps=4, num_levels=3,
                                        num_truncated_layers=1, dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    model = KeyMorph(unet, K, weight_keypoints="power")
    img = rng.random((1, 1, *S)).astype(np.float32)
    kernels.reset_counters()
    res = model(img, img[:, :, ::-1].copy(), transform_type=["affine", "rigid", "tps_1"],
                return_aligned_points=True)
    counts = kernels.counters()
    assert counts["tps_flow"]["launches"] == 1 and counts["conv3x3_fused_flat"]["launches"] > 0
    assert not any(c["plain_calls"] for c in counts.values()), counts
    for r in res.values():
        assert r["grid"].shape == (1, *S, 3) and r["grid"].is_cuda
        assert bool(torch.isfinite(r["grid"]).all() and torch.isfinite(r["points_a"]).all())


def test_2d_registration_on_the_card_matches_the_cpu(rng, dev):
    """``KeyMorph(dim=2)`` (an fp32 UNet2D, TF32 off) on the card against the
    same call on the CPU, on the same weights and images: keypoints within
    1e-4 (cuDNN's fp32 convs sum in another order), every output on the card
    and finite. Then the 2D geometry from identical, spread keypoints (an
    untrained net's cluster, which makes the affine fit ill-conditioned):
    grids and aligned points within 1e-5, the bilinear warp of the card's
    grid within 1e-5 and the nearest warp exactly. The 2D route moves no
    kernel counter and no plain-version counter on either device."""
    from keymorph_tpu_torch.models.keymorph import KeyMorph, align_pair
    from keymorph_tpu_torch.models.unet import UNet2D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.resample import align_img

    K, S, types = 8, (40, 36), ["rigid", "affine", "tps_1"]
    img_f, img_m = (rng.random((2, 1, *S)).astype(np.float32) for _ in range(2))
    seg = torch.tensor(rng.integers(0, 4, (2, 1, *S)).astype(np.float32))
    kernels.reset_counters()
    out = {}
    for device in ("cpu", dev):
        net = init_weights(UNet2D(out_channels=K, f_maps=8, num_levels=3),
                           torch.Generator().manual_seed(0))
        out[str(device)] = KeyMorph(net, K, dim=2, device=device)(
            img_f, img_m, transform_type=types, return_aligned_points=True)
    cpu, card = out["cpu"], out[str(dev)]
    for t in types:
        for k in ("points_f", "points_m"):
            assert (card[t][k].cpu() - cpu[t][k]).abs().max().item() <= 1e-4, (t, k)
        for v in (card[t]["grid"], card[t]["points_a"]):
            assert v.is_cuda and bool(torch.isfinite(v).all())
    pf = torch.tensor(rng.uniform(-0.7, 0.7, (2, K, 2)).astype(np.float32))
    pm = pf + torch.tensor(rng.normal(0, 0.05, (2, K, 2)).astype(np.float32))
    for t in types:
        align_type, lm = t.split("_")[0], (1.0 if t.startswith("tps") else None)
        got = align_pair(pf.to(dev), pm.to(dev), align_type, S, lmbda=lm,
                         compute_aligned_points=True)
        want = align_pair(pf, pm, align_type, S, lmbda=lm, compute_aligned_points=True)
        for k in ("grid", "points_a"):
            assert (got[k].cpu() - want[k]).abs().max().item() <= 1e-5, (t, k)
        grid = got["grid"].cpu()
        assert (align_img(got["grid"], torch.tensor(img_m, device=dev)).cpu()
                - align_img(grid, torch.tensor(img_m))).abs().max().item() <= 1e-5, t
        assert torch.equal(align_img(got["grid"], seg.to(dev), "nearest").cpu(),
                           align_img(grid, seg, "nearest")), t
    assert not any(c["launches"] or c["plain_calls"] for c in kernels.counters().values())


def test_cuda_wrappers_refuse_2d_tensors(dev):
    """The warp and TPS-flow wrappers keep refusing a CUDA tensor that is not
    3D: the 2D route never reaches them, and nothing falls back to them."""
    from keymorph_tpu_torch.ops.cuda import resample3d, tpsflow

    with pytest.raises(ValueError):
        resample3d.warp_planes(torch.zeros((1, 1, 8, 8), device=dev),
                               torch.zeros((1, 2, 8, 8), device=dev))
    with pytest.raises(ValueError):
        tpsflow.tps_flow(torch.zeros((1, 7, 2), device=dev), torch.zeros((1, 4, 2), device=dev),
                         torch.zeros((1, 64, 2), device=dev))


def test_simple_unet_and_lc2_on_the_card_match_the_cpu(rng, dev):
    """The brain extractor's logits at 32^3 and LC2 of 3 odd cubes of 21^3
    on the card against the CPU: logits within 1e-4 of their largest value,
    LC2 within 1e-5."""
    from keymorph_tpu_torch import metrics as M
    from keymorph_tpu_torch.brain_extract import brain_logits
    from keymorph_tpu_torch.models.unet import SimpleUnet, init_weights

    x = rng.random((1, 1, 32, 32, 32)).astype(np.float32)
    model = init_weights(SimpleUnet(), torch.Generator().manual_seed(1))
    cpu = brain_logits(model, x, device="cpu")
    card = brain_logits(model, x, device=dev)
    assert (card.cpu() - cpu).abs().max().item() <= 1e-4 * cpu.abs().max().item()
    us, mr = (torch.tensor(rng.normal(size=(3, 1, 21, 21, 21)).astype(np.float32))
              for _ in range(2))
    lc2 = M.LC2()
    assert (lc2(us.to(dev), mr.to(dev)).cpu() - lc2(us, mr)).abs().max().item() <= 1e-5
