"""The port's warp (keymorph_tpu_torch/ops/cuda/resample3d.py and
ops/resample.py) against keymorph_tpu's.

On the CPU ``warp_planes`` runs its plain version (the gather formulation).
keymorph_tpu's gather-free Pallas warp runs in interpret mode
(KM_FORCE_FAST_WARP=1), as its own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.ops import resample as jresample
from keymorph_tpu.ops.pallas import resample3d as jwarp
from keymorph_tpu.ops.planes import grid_sample_planes as jgrid_sample_planes
from keymorph_tpu_torch.ops import resample
from keymorph_tpu_torch.ops.cuda import resample3d

S = (32, 32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(rng, B, out_spatial, kind):
    """Smooth (registration-like) or wild (random, far outside) planes."""
    axes = [np.linspace(-1, 1, s) for s in out_spatial]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    out = []
    for b in range(B):
        if kind == "smooth":
            a = 0.05 * (b + 1)
            pz = zz + a * np.sin(2.5 * yy + 1.0) - a * 0.5 * np.cos(2.0 * xx)
            py = yy + a * np.cos(3.0 * zz) + a * 0.4 * np.sin(2.0 * xx + 0.3)
            px = xx - a * np.sin(2.0 * zz + 0.7) + a * 0.6 * np.cos(2.5 * yy)
            out.append(np.stack([pz, py, px]))
        else:
            out.append(rng.uniform(-1.6, 1.6, (3, *out_spatial)))
    return np.stack(out).astype(np.float32)


def _mixed_planes(rng, B, out_spatial=S):
    """Batch element 0 smooth (registration-like), the others wild (random,
    far outside the volume); a single element is wild."""
    if B == 1:
        return _planes(rng, 1, out_spatial, "wild")
    return np.concatenate([_planes(rng, 1, out_spatial, "smooth"),
                           _planes(rng, B - 1, out_spatial, "wild")])


# C = 14: the Dice step's one-hot segmentation (utils.one_hot_subsampled_pair);
# the output grid other than the source's
DICE = (1, 14, (12, 20, 16), (10, 8, 24))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("B,C,src,out", [(2, 3, S, S), DICE])
def test_warp_planes_matches_jax_gather(rng, mode, B, C, src, out):
    """C=3, B=2 at 32^3, smooth and wild flows, and C=14 onto another grid,
    vs keymorph_tpu's gather formulation: the same arithmetic in the same
    order, so nearest is bit-exact and trilinear agrees to 1e-6 (fp32
    contraction)."""
    img = rng.random((B, C, *src), dtype=np.float32)
    planes = _mixed_planes(rng, B, out)
    got = resample3d.warp_planes(torch.tensor(img), torch.tensor(planes), mode).numpy()
    want = np.asarray(jgrid_sample_planes(jnp.asarray(img), jnp.asarray(planes), mode))
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("mode,B,C,src,out", [("bilinear", 2, 3, S, S), ("nearest", 1, 1, S, S),
                                              ("bilinear", 1, 14, (8, 8, 32), (8, 16, 64))])
def test_warp_planes_matches_jax_kernel(rng, monkeypatch, mode, B, C, src, out):
    """vs keymorph_tpu's Pallas warp (fast path forced, interpret mode),
    which contracts fp32 values as bf16 hi/lo parts (~16 mantissa bits,
    also for nearest): abs <= 1e-5 on images in [0, 1]. The wild batch
    element takes the kernel's own exactness fallback. Interpret mode costs
    ~8-12 s per batch element at 32^3, hence the small nearest case; C=14
    onto another grid is the smallest the kernel takes (8 cells of 4x8x32
    output voxels), ~20 s."""
    monkeypatch.setenv("KM_FORCE_FAST_WARP", "1")
    img = rng.random((B, C, *src), dtype=np.float32)
    planes = _mixed_planes(rng, B, out) if B > 1 else _planes(rng, 1, out, "smooth")
    got = resample3d.warp_planes(torch.tensor(img), torch.tensor(planes), mode).numpy()
    want = np.asarray(jwarp.warp_planes(jnp.asarray(img), jnp.asarray(planes), mode))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_align_img_matches_jax(rng):
    """The xy grid contract: align_img(grid) == align_planes(flip(moveaxis))."""
    img = rng.random((2, 1, *S), dtype=np.float32)
    planes = _planes(rng, 2, S, "smooth")
    grid = np.flip(np.moveaxis(planes, 1, -1), -1).copy()
    got = resample.align_img(torch.tensor(grid), torch.tensor(img)).numpy()
    want = np.asarray(jresample.align_img(jnp.asarray(grid), jnp.asarray(img),
                                          allow_pallas=False))
    np.testing.assert_allclose(got, want, atol=1e-6)
    via_planes = resample.align_planes(torch.tensor(planes), torch.tensor(img)).numpy()
    np.testing.assert_array_equal(got, via_planes)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_border_clamp_far_outside(rng, mode):
    """Coordinates far outside [-1, 1] clamp to the border voxels."""
    img = rng.random((1, 2, 6, 7, 8), dtype=np.float32)
    planes = np.full((1, 3, 2, 2, 2), 50.0, np.float32)
    planes[:, :, 0] = -50.0
    got = resample3d.warp_planes(torch.tensor(img), torch.tensor(planes), mode).numpy()
    np.testing.assert_array_equal(got[0, :, 0], np.broadcast_to(img[0, :, :1, :1, :1].reshape(2, 1, 1), (2, 2, 2)))
    np.testing.assert_array_equal(got[0, :, 1], np.broadcast_to(img[0, :, -1:, -1:, -1:].reshape(2, 1, 1), (2, 2, 2)))


def test_nearest_rounds_half_to_even():
    """Voxel coordinate 1.5 (and 2.5) rounds to 2 under round-half-even."""
    img = torch.arange(5, dtype=torch.float32).reshape(1, 1, 5, 1, 1)
    # v = ((p + 1) * 5 - 1) / 2  ->  p = (2v + 1) / 5 - 1
    p = torch.tensor([(2 * 1.5 + 1) / 5 - 1, (2 * 2.5 + 1) / 5 - 1])
    planes = torch.zeros((1, 3, 2, 1, 1))
    planes[0, 0, :, 0, 0] = p
    got = resample3d.warp_planes(img, planes, "nearest").flatten().tolist()
    assert got == [2.0, 2.0]


@pytest.mark.parametrize("which", ["img", "planes"])
def test_kernel_limit_is_held_on_shapes(which):
    """The kernels' offsets within one channel are 32-bit: the launch check
    refuses 2^31 voxels a channel, of the source or of the output, from the
    shapes alone (expanded views allocate nothing), and lets 2^31 - 1 pass
    on to the device check."""
    def views(n):
        big = torch.zeros(1).expand(1, 3, *n)
        small = torch.zeros((1, 3, 2, 2, 2))
        return (big[:, :1], small) if which == "img" else (small[:, :1], big)

    with pytest.raises(ValueError, match="2\\^31"):
        resample3d._check("warp_planes", *views((2 ** 11, 2 ** 10, 2 ** 10)))
    with pytest.raises(ValueError, match="one CUDA device"):
        resample3d._check("warp_planes", *views((2 ** 31 - 1, 1, 1)))


def test_torch_grid_sample_agrees(rng):
    """The plain warp follows torch's own grid_sample contract (border,
    align_corners=False) on the xy grid."""
    img = torch.tensor(rng.random((1, 2, 9, 10, 11), dtype=np.float32))
    planes = torch.tensor(_planes(rng, 1, (5, 6, 7), "wild"))
    ref = torch.nn.functional.grid_sample(
        img, torch.flip(torch.movedim(planes, 1, -1), dims=(-1,)), mode="bilinear",
        padding_mode="border", align_corners=False)
    got = resample3d.warp_planes(img, planes)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_coordinate_conversions_match_jax(rng):
    """norm <-> voxel (align_corners=False: -1 <-> -0.5 voxel) and the
    inclusive-linspace flow grid, against keymorph_tpu.ops.coords."""
    from keymorph_tpu.ops import coords as jcoords
    from keymorph_tpu_torch.ops import coords

    pts = rng.uniform(-1.2, 1.2, (2, 7, 3)).astype(np.float32)
    sizes = (9, 16, 33)
    vox = coords.convert_points_norm2voxel(torch.tensor(pts), sizes).numpy()
    np.testing.assert_allclose(vox, np.asarray(jcoords.convert_points_norm2voxel(
        jnp.asarray(pts), sizes)), atol=1e-5)
    back = coords.convert_points_voxel2norm(torch.tensor(vox), sizes).numpy()
    np.testing.assert_allclose(back, np.asarray(jcoords.convert_points_voxel2norm(
        jnp.asarray(vox), sizes)), atol=1e-6)
    np.testing.assert_allclose(back, pts, atol=1e-6)
    np.testing.assert_allclose(coords.flat_norm_grid(sizes).numpy(),
                               np.asarray(jcoords.flat_norm_grid(sizes)), atol=1e-6)
