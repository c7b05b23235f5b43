"""What the tensor-core conv kernel is told, checked without a GPU: the two
weight packs (forward; flipped and channel-swapped for the input gradient),
the packed channel axis, the tile geometry and the halo linearisation of
``keymorph_tpu_torch/ops/cuda/conv3d.py``.

A small pure-PyTorch implicit GEMM below consumes exactly what the kernel
consumes: per tile a halo buffer ``[ci/8][halo voxel][8]`` of
``pad0(bf16(a*x + b))``, the packed weights ``[Cout block][chunk][ci/8][tap]
[co][ci%8]``, 64-row blocks that start at ``block_starts`` and read their tap
operands ``tap_offsets`` rows further, and the row -> output voxel map with its
mask. Its result is held against the plain versions: products of bf16 values
are exact in fp32 and only the order of the fp32 sum differs, so the stored
bf16 values agree within one bf16 ulp (plus 1e-6 of the range where a sum
cancels).
"""

import numpy as np
import pytest
import torch

from keymorph_tpu_torch.ops.cuda import conv3d


def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _ulp(v):
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 8)


def _implicit_gemm(u, spatial, packed, ca, cb, cout, nblk):
    """The kernel's walk in PyTorch. ``u``: (Z, Cin, Y*X) bf16, the conv's
    whole staged input (affined, rounded). Returns (Z, cout, Y*X) fp32 sums."""
    Z, Y, X = spatial
    geom = conv3d.tile_geometry(X)
    lin = conv3d.halo_linearisation(geom)
    tx, ty, tz, hx, hy, hz = (geom[k] for k in ("tx", "ty", "tz", "hx", "hy", "hz"))
    chan = conv3d.packed_channels(ca, cb)
    nchunks = len(chan) // 16
    assert packed.shape == (-(-cout // nblk), nchunks, 2, 27, nblk, 8)
    nvox = hz * hy * hx
    assert nvox <= conv3d.NVOX_ALLOC
    last = int(lin["block_starts"].max() + conv3d.MROWS - 1 + lin["tap_offsets"].max())
    assert last < conv3d.NVOX_ALLOC  # every operand row lies inside a stage
    u4 = u.float().reshape(Z, -1, Y, X)
    padded = torch.zeros((Z + hz, u4.shape[1] + 1, Y + hy + ty, X + hx + tx))  # + a zero channel
    padded[1:Z + 1, :-1, 1:Y + 1, 1:X + 1] = u4
    out = torch.full((Z, cout, Y, X), float("nan"))
    rows = torch.arange(conv3d.MROWS)
    for z0 in range(0, Z, tz):
        for y0 in range(0, Y, ty):
            for x0 in range(0, X, tx):
                # the stage: [ci/8][voxel][8]; rows past the tile hold junk
                halo = torch.full((len(chan) // 8, conv3d.NVOX_ALLOC, 8), 1e30)
                tile = padded[z0:z0 + hz, :, y0:y0 + hy, x0:x0 + hx][:, chan]  # -1 -> zeros
                halo[:, :nvox] = tile.permute(1, 0, 2, 3).reshape(len(chan) // 8, 8, nvox) \
                    .transpose(1, 2)
                for nbi in range(packed.shape[0]):
                    acc = torch.zeros((len(lin["block_starts"]), conv3d.MROWS, nblk))
                    for c in range(nchunks):
                        for tap, off in enumerate(lin["tap_offsets"].tolist()):
                            b = packed[nbi, c, :, tap].float()  # (2, nblk, 8)
                            b = b.permute(0, 2, 1).reshape(16, nblk)
                            for g, start in enumerate(lin["block_starts"].tolist()):
                                a = halo[2 * c:2 * c + 2, start + off + rows]  # (2, 64, 8)
                                acc[g] += a.transpose(0, 1).reshape(conv3d.MROWS, 16) @ b
                    z = z0 + lin["oz"]
                    y = y0 + lin["oy"]
                    x = x0 + lin["ox"]
                    keep = lin["valid"] & (z < Z) & (y < Y) & (x < X)
                    co = torch.arange(nbi * nblk, min((nbi + 1) * nblk, cout))
                    vals = acc[keep][:, :len(co)]  # (rows kept, co)
                    assert bool(torch.isnan(out[z[keep]][:, co][:, :, y[keep], x[keep]]
                                            .diagonal(dim1=0, dim2=2)).all())  # written once
                    out[z[keep][:, None], co[None, :], y[keep][:, None], x[keep][:, None]] = vals
    assert not bool(torch.isnan(out).any())  # every output voxel is some block's row
    return out.reshape(Z, cout, Y * X)


def _close(got_sums, want_bf16):
    k = got_sums.to(torch.bfloat16).float()
    p = want_bf16.float()
    bound = torch.maximum(_ulp(p), _ulp(k)) + 1e-6 * p.abs().max()
    assert bool(((k - p).abs() <= bound).all()), (k - p).abs().max().item()


FORWARD = [
    # spatial (odd; X below, at and above a tile), mode, ca, cb, cout
    ((3, 5, 7), "flat", 1, 0, 3),
    ((3, 5, 7), "flat", 3, 0, 16),
    ((5, 9, 19), "flat", 24, 0, 40),
    ((2, 3, 35), "flat", 24, 0, 3),
    ((3, 6, 67), "flat", 8, 0, 16),
    ((3, 5, 7), "parts", 3, 5, 40),
    ((2, 4, 6), "parts", 64, 128, 16),
    ((2, 4, 6), "upconv", 64, 128, 16),
    ((4, 6, 34), "upconv", 24, 8, 3),
    ((2, 16, 18), "upconv", 3, 24, 40),
]


@pytest.mark.parametrize("spatial,mode,ca,cb,cout", FORWARD)
def test_forward_pack_and_linearisation_match_plain(spatial, mode, ca, cb, cout):
    rng = np.random.default_rng(ca * 1000 + cb * 10 + cout)
    Z, Y, X = spatial
    xa = _bf16(rng, Z, ca, Y * X)
    xb = None
    if mode == "parts":
        xb = _bf16(rng, Z, cb, Y * X)
    elif mode == "upconv":
        xb = _bf16(rng, Z // 2, cb, (Y // 2) * (X // 2))
    cin = ca + cb
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) / np.sqrt(cin))
    sc = torch.tensor(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    sh = torch.tensor(rng.normal(size=cin).astype(np.float32) * 0.3)
    plain = {"flat": lambda: conv3d.conv3x3_fused_flat_plain(xa, spatial, w, sc, sh, relu=False),
             "parts": lambda: conv3d.conv3x3_fused_flat_parts_plain(xa, xb, spatial, w, sc, sh,
                                                                    relu=False),
             "upconv": lambda: conv3d.conv3x3_fused_flat_upconv_plain(xa, xb, spatial, w, sc, sh,
                                                                      relu=False)}[mode]()
    full = conv3d._full_input(xa, xb, mode == "upconv", spatial).float()
    u = (full * sc[None, :, None] + sh[None, :, None]).to(torch.bfloat16)
    nblk = conv3d.n_block(cout)
    got = _implicit_gemm(u, spatial, conv3d.pack_weights(w, ca, nblk), ca, cb, cout, nblk)
    _close(got, plain)


GRAD = [
    # spatial, cotangent channels (the forward Cout), forward ca, cb
    ((3, 5, 7), 16, 1, 0),
    ((3, 5, 7), 3, 3, 0),
    ((5, 9, 19), 40, 24, 0),
    ((2, 4, 6), 16, 64, 128),
    ((2, 3, 35), 40, 3, 5),
    ((3, 6, 67), 16, 8, 0),
]


@pytest.mark.parametrize("spatial,cg,ca,cb", GRAD)
def test_gradient_pack_matches_plain(spatial, cg, ca, cb):
    rng = np.random.default_rng(cg * 1000 + ca * 10 + cb)
    Z, Y, X = spatial
    cin = ca + cb
    g_v = _bf16(rng, Z, cg, Y * X)
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cg)).astype(np.float32) / np.sqrt(cg))
    want_a, want_b = conv3d.conv3x3_input_grad_plain(g_v, spatial, w, ca if cb else None)
    nblk = conv3d.n_block(cin)
    got = _implicit_gemm(g_v, spatial, conv3d.pack_weights_grad(w, nblk), cg, 0, cin, nblk)
    _close(got[:, :ca], want_a)
    if cb:
        _close(got[:, ca:], want_b)
    else:
        assert want_b is None


@pytest.mark.parametrize("ca,cb", [(1, 0), (3, 0), (8, 0), (24, 0), (3, 5), (64, 128), (24, 8)])
def test_packed_channels_keep_sources_in_their_own_groups(ca, cb):
    idx = conv3d.packed_channels(ca, cb)
    assert len(idx) % 16 == 0
    kept = idx[idx >= 0]
    assert kept.tolist() == list(range(ca + cb))  # every channel once, in order
    for g in idx.reshape(-1, 8):  # an 8-channel group reads one source only
        real = g[g >= 0]
        assert bool((real < ca).all()) or bool((real >= ca).all())
    assert int(idx[0]) == 0 and (cb == 0 or int(idx[-(-ca // 8) * 8]) == ca)


@pytest.mark.parametrize("cin,cout,nblk", [(1, 3, 8), (24, 40, 64), (192, 64, 64), (16, 200, 64)])
def test_pack_weights_places_every_weight_once(cin, cout, nblk):
    rng = np.random.default_rng(cin + cout)
    w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32))
    p = conv3d.pack_weights(w, cin, nblk)
    idx = conv3d.packed_channels(cin, 0)
    wb = w.to(torch.bfloat16).reshape(27, cin, cout)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    for tap, ci, co in [(0, 0, 0), (13, cin - 1, cout - 1), (26, cin // 2, cout // 2)]:
        kk = int((idx == ci).nonzero())
        assert p[co // nblk, kk // 16, (kk % 16) // 8, tap, co % nblk, kk % 8] == wb[tap, ci, co]
    assert float(p.float().abs().sum()) == pytest.approx(float(wb.float().abs().sum()), rel=1e-6)
    # the gradient's pack is the forward pack of the flipped, swapped weights
    g = conv3d.pack_weights_grad(w, conv3d.n_block(cin))
    assert torch.equal(g, conv3d.pack_weights(w.flip(0, 1, 2).transpose(3, 4), cout,
                                              conv3d.n_block(cin)))


@pytest.mark.parametrize("X", [1, 5, 16, 17, 32, 33, 64, 70, 256])
def test_tile_geometry_covers_its_tile_inside_one_stage(X):
    geom = conv3d.tile_geometry(X)
    lin = conv3d.halo_linearisation(geom)
    assert geom["tx"] % 16 == 0 and geom["hz"] * geom["hy"] * geom["hx"] <= conv3d.NVOX_ALLOC
    seen = torch.zeros((geom["tz"], geom["ty"], geom["tx"]), dtype=torch.long)
    v = lin["valid"]
    seen.index_put_((lin["oz"][v], lin["oy"][v], lin["ox"][v]), torch.ones(int(v.sum()),
                    dtype=torch.long), accumulate=True)
    assert bool((seen == 1).all())  # each output voxel is exactly one GEMM row
    # a row's own halo voxel, read at tap (1, 1, 1), is the output voxel's
    centre = lin["block_starts"][:, None] + torch.arange(conv3d.MROWS) + lin["tap_offsets"][13]
    want = ((lin["oz"] + 1) * geom["hy"] + lin["oy"] + 1) * geom["hx"] + lin["ox"] + 1
    assert torch.equal(centre[v], want[v])
    assert int(centre.max() + lin["tap_offsets"][26] - lin["tap_offsets"][13]) < conv3d.NVOX_ALLOC
    assert conv3d.n_tiles((3, 9, X), geom) == -(-X // geom["tx"]) * -(-9 // geom["ty"]) * 2


# the 12 convs of TruncatedUNet3D (f_maps 32, 4 levels, 1 truncated) at 128^3:
# spatial, ca, cb (the half-resolution part of a decoder's input), cout
UNET_128 = [((128,) * 3, 1, 0, 16), ((128,) * 3, 16, 0, 32), ((64,) * 3, 32, 0, 32),
            ((64,) * 3, 32, 0, 64), ((32,) * 3, 64, 0, 64), ((32,) * 3, 64, 0, 128),
            ((16,) * 3, 128, 0, 128), ((16,) * 3, 128, 0, 256), ((32,) * 3, 128, 256, 128),
            ((32,) * 3, 128, 0, 128), ((64,) * 3, 64, 128, 64), ((64,) * 3, 64, 0, 64)]
WGRAD_PLANS = UNET_128 + [((256, 256, 150), 16, 0, 32), ((128, 128, 75), 64, 64, 64),
                          ((6, 12, 40), 8, 16, 24), ((5, 9, 33), 3, 5, 130), ((1, 4, 33), 16, 0, 3),
                          ((3, 5, 7), 1, 0, 3), ((2, 3, 5), 200, 0, 3), ((4, 8, 16), 16, 0, 16)]


def weight_grad_runs(plan):
    """The runs of tile planes, (start, end) a split, as the kernel computes
    them from the plan."""
    p, n = plan["planes"], plan["nsplit"]
    return [(s * p // n, (s + 1) * p // n) for s in range(n)]


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("spatial,ca,cb,cout", WGRAD_PLANS)
def test_weight_grad_plan_splits_every_voxel_once(spatial, ca, cb, cout, n_sm):
    """The weight-gradient kernel's plan: its plane tile and every tap's
    operand inside one staged plane; the runs of tile planes cut [0, planes)
    into nsplit non-empty pieces and put every output voxel in exactly one;
    the partial sums under WG_PART_CAP (or a single run); the channel axes
    padded to the wgmma's 16 input and 64 output channels."""
    Z, Y, X = spatial
    plan = conv3d.weight_grad_plan(spatial, ca, cb, cout, n_sm)
    tx, ty, hx, hy = (plan[k] for k in ("tx", "ty", "hx", "hy"))
    assert tx % 16 == 0 and tx * ty == conv3d.WG_VOX and (hx, hy) == (tx + 2, ty + 2)
    # the last voxel a k-step reads: row ty - 1 + 2, column tx - 16 + 2 + 15
    assert hy * hx <= conv3d.WG_PLANE_ALLOC and (ty + 1) * hx + tx + 1 < conv3d.WG_PLANE_ALLOC
    runs = weight_grad_runs(plan)
    assert len(runs) == plan["nsplit"] and runs[0][0] == 0 and runs[-1][1] == plan["planes"]
    assert all(a < b for a, b in runs) and all(runs[i][1] == runs[i + 1][0]
                                               for i in range(len(runs) - 1))
    assert plan["planes"] == plan["ntx"] * plan["nty"] * Z
    seen = torch.zeros((Z, plan["nty"] * ty, plan["ntx"] * tx), dtype=torch.int32)
    for a, b in runs:
        for idx in range(a, b):
            tile, z = divmod(idx, Z)
            y0, x0 = (tile // plan["ntx"]) * ty, (tile % plan["ntx"]) * tx
            seen[z, y0:y0 + ty, x0:x0 + tx] += 1
    assert bool((seen == 1).all())
    assert plan["cip"] == len(conv3d.packed_channels(ca, cb)) == 16 * plan["nchunks"]
    assert plan["cop"] == conv3d.WG_CO_BLOCK * plan["nco"] and 0 <= plan["cop"] - cout < 64
    assert plan["part_bytes"] == plan["nsplit"] * 27 * plan["cip"] * plan["cop"] * 4
    assert plan["part_bytes"] <= conv3d.WG_PART_CAP or plan["nsplit"] == 1
    assert plan["blocks"] == plan["nco"] * plan["nchunks"] * plan["nsplit"]


def _wgrad_walk(u, g, spatial, ca, cb, plan):
    """The weight-gradient kernel's walk in float64: per run of tile planes,
    per plane, the 16-channel chunks of the three input planes staged as the
    kernel's halo planes (packed channels, pad0), a tap's operand the rows
    (ly + dy) * hx + lx + dx of the plane z - 1 + dz, the cotangent plane
    padded to ``cop`` channels; partial sums a run, then summed in order and
    unpacked. ``u``: (Z, Cin, Y*X) the staged input, ``g``: (Z, Cout, Y*X)."""
    Z, Y, X = spatial
    tx, ty, hx, hy, cop = (plan[k] for k in ("tx", "ty", "hx", "hy", "cop"))
    chan = conv3d.packed_channels(ca, cb)
    cin, cout = ca + cb, g.shape[1]
    padded = torch.zeros((Z + 2, cin + 1, Y + ty + 2, X + tx + 2), dtype=torch.float64)
    padded[1:Z + 1, :cin, 1:Y + 1, 1:X + 1] = u.double().reshape(Z, cin, Y, X)
    gp = torch.zeros((Z, cop, Y + ty, X + tx), dtype=torch.float64)
    gp[:, :cout, :Y, :X] = g.double().reshape(Z, cout, Y, X)
    v = torch.arange(ty * tx)
    ly, lx = v // tx, v % tx
    part = torch.zeros((plan["nsplit"], 27, len(chan), cop), dtype=torch.float64)
    for s, (a, b) in enumerate(weight_grad_runs(plan)):
        for idx in range(a, b):
            tile, z = divmod(idx, Z)
            y0, x0 = (tile // plan["ntx"]) * ty, (tile % plan["ntx"]) * tx
            gt = gp[z, :, y0:y0 + ty, x0:x0 + tx].reshape(cop, -1)
            for dz in range(3):
                # channel -1 (padding) reads the zero channel
                halo = padded[z + dz, :, y0:y0 + hy, x0:x0 + hx][chan].reshape(len(chan), -1)
                for dy in range(3):
                    for dx in range(3):
                        part[s, (dz * 3 + dy) * 3 + dx] += \
                            halo[:, (ly + dy) * hx + lx + dx] @ gt.T
    pos = torch.nonzero(chan >= 0).flatten()  # packed position of each real channel
    return part.sum(0)[:, pos, :cout].reshape(3, 3, 3, cin, cout)


@pytest.mark.parametrize("spatial,mode,ca,cb,cout", [
    ((3, 9, 33), "flat", 3, 0, 5), ((4, 6, 20), "upconv", 5, 11, 70),
    ((2, 17, 16), "parts", 8, 9, 3), ((2, 3, 40), "flat", 17, 0, 64)])
def test_weight_grad_walk_matches_plain(rng, spatial, mode, ca, cb, cout):
    """What the weight-gradient kernel is told (plane tiles, runs, packed and
    padded channels), walked in float64 over the staged input, against the
    plain weight gradient: within 1e-5 of the sum of the terms' magnitudes."""
    Z, Y, X = spatial
    xa = _bf16(rng, Z, ca, Y * X)
    src = {"flat": None, "parts": (Z, cb, Y * X), "upconv": (Z // 2, cb, (Y // 2) * (X // 2))}
    xb = None if src[mode] is None else _bf16(rng, *src[mode])
    g = _bf16(rng, Z, cout, Y * X)
    sc = torch.tensor(rng.uniform(0.5, 1.5, ca + cb).astype(np.float32))
    sh = torch.tensor((rng.normal(size=ca + cb) * 0.3).astype(np.float32))
    lowres = mode == "upconv"
    u = (conv3d._full_input(xa, xb, lowres, spatial).float() * sc[None, :, None]
         + sh[None, :, None]).to(torch.bfloat16)
    plan = conv3d.weight_grad_plan(spatial, ca, cb, cout, n_sm=5)
    got = _wgrad_walk(u, g, spatial, ca, cb, plan)
    want = conv3d._weight_grad_plain(xa, xb, spatial, g, sc, sh, lowres)
    mag = conv3d._weight_grad_plain(u.abs(), None, spatial, g.abs())
    assert bool(((got - want.double()).abs() <= 1e-5 * mag.double()).all())
