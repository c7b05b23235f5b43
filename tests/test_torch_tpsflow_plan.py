"""What the port's TPS kernels rest on besides their arithmetic
(keymorph_tpu_torch/ops/cuda/tpsflow.py, csrc/tpsflow.cu), checked on the CPU:
the row-separable distance the kernels take on the identity grid, the float64
plain versions their tolerances are stated against, and the layout of the
backward kernel's row of sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.ops import coords as jcoords
from keymorph_tpu.transforms import solvers as jsolvers
from keymorph_tpu_torch.ops.cuda import tpsflow
from keymorph_tpu_torch.transforms import solvers

# ragged against the kernels' tiles: W not a multiple of 4, W < 4, a size-1
# axis, D*H*W not a multiple of a block
SHAPES = [(5, 3, 13), (7, 1, 3), (1, 5, 9), (4, 6, 1), (3, 4, 32)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spline(rng, B, T, lmbda):
    src = torch.tensor(rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32))
    dst = src + torch.tensor(rng.normal(0, 0.08, (B, T, 3)).astype(np.float32))
    return solvers.fit_tps(src, dst, lmbda).contiguous(), src


@pytest.mark.parametrize("spatial", SHAPES)
def test_row_separable_distance_is_the_plain_versions(rng, spatial):
    """On the identity grid the kernels take d0^2 + d1^2 once per (grid row,
    control point) and add d2^2 per x position. That is the plain version's
    sum of the three squared differences in its own order, so the squared
    distances are bit-identical (fp32, every operation rounded on its own)."""
    D, H, W = spatial
    ctrl = torch.tensor(rng.uniform(-0.8, 0.8, (7, 3)).astype(np.float32))
    az, ay, ax = tpsflow._axis_coords(spatial, "cpu")
    d0 = ctrl[:, 0, None] - az[None]  # (T, D)
    d1 = ctrl[:, 1, None] - ay[None]  # (T, H)
    d2 = ctrl[:, 2, None] - ax[None]  # (T, W)
    per_row = (d0 * d0)[:, :, None] + (d1 * d1)[:, None, :]  # (T, D, H): once per row
    sq = per_row[..., None] + (d2 * d2)[:, None, None, :]  # (T, D, H, W)
    pts = tpsflow._grid_points(spatial, "cpu")
    diff = ctrl[:, None, :] - pts[None]  # the plain version: tps_pairwise_dist
    want = torch.sum(diff * diff, dim=-1)
    assert torch.equal(sq.reshape(7, -1), want)
    r = solvers.tps_pairwise_dist(ctrl[None], pts[None])[0]
    assert torch.equal(torch.sqrt(sq.reshape(7, -1) + solvers.EPS_DIST), r)


@pytest.mark.parametrize("T", [16, 130])
def test_planes_plain_float64_matches_jax_tps_eval(rng, T):
    """The float64 path of the forward plain version (the reference the
    kernels' distance from the truth is stated against) vs keymorph_tpu's
    fp32 ``tps_eval`` on the flat grid: abs 2e-5, the bar the fp32 plain
    version is held to (fp32 contraction noise on the JAX side); and the fp32
    plain version is within 1e-5 of it."""
    spatial = (6, 5, 13)
    theta, src = _spline(rng, 2, T, torch.tensor([0.1, 1.0]))
    got = tpsflow.tps_planes_plain(theta, src, spatial, dtype=torch.float64)
    assert got.dtype == torch.float64 and got.shape == (2, 3, *spatial)
    n = int(np.prod(spatial))
    pts = jnp.broadcast_to(jcoords.flat_norm_grid(spatial), (2, n, 3))
    moved = jsolvers.tps_eval(jnp.asarray(theta.numpy()), jnp.asarray(src.numpy()), pts)
    want = np.asarray(jnp.moveaxis(moved, -1, 1).reshape(2, 3, *spatial))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    fp32 = tpsflow.tps_planes_plain(theta, src, spatial)
    assert (fp32.double() - got).abs().max().item() <= 1e-5


def test_flow_plain_float64_matches_fp32(rng):
    """Points mode: the float64 path is the fp32 plain version's formula
    (abs 1e-5 between them) and counts as a plain call."""
    theta, src = _spline(rng, 2, 37, 0.5)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (2, 501, 3)).astype(np.float32))
    n0 = tpsflow.tps_flow_plain.calls
    ref = tpsflow.tps_flow_plain(theta, src, pts, dtype=torch.float64)
    got = tpsflow.tps_flow_plain(theta, src, pts)
    assert tpsflow.tps_flow_plain.calls == n0 + 2
    assert ref.dtype == torch.float64 and got.dtype == torch.float32
    assert (got.double() - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("spatial", [(5, 3, 13), (7, 1, 3)])
def test_float64_forward_and_backward_are_one_function(rng, spatial):
    """Autograd through the float64 forward gives the float64 closed-form
    backward: 2e-7 of the largest value (the closed form rounds its result
    to fp32 on return; nothing else separates them)."""
    theta, src = _spline(rng, 2, 9, 0.3)
    g = torch.tensor(rng.normal(size=(2, 3, *spatial)).astype(np.float32))
    th = theta.double().requires_grad_(True)
    c = src.double().requires_grad_(True)
    tpsflow.tps_planes_plain(th, c, spatial, dtype=torch.float64).backward(g.double())
    rt, rc = tpsflow.tps_planes_bwd_plain(theta, src, spatial, g, dtype=torch.float64)
    assert (th.grad - rt).abs().max().item() <= 2e-7 * th.grad.abs().max().item()
    assert (c.grad - rc).abs().max().item() <= 2e-7 * c.grad.abs().max().item()


@pytest.mark.parametrize("B,T", [(1, 1), (2, 5), (1, 64), (2, 130)])
def test_backward_row_of_sums_layout(rng, B, T):
    """The backward kernel writes, per block, [g_theta (T+4, 3) | 2 sum m (T)
    | -2 sum m p (T, 3)]; the wrapper's second pass turns the summed row into
    g_theta and g_ctrl = 2 (ctrl * sum m - sum m p), exactly (the factors of
    two are exact in fp32)."""
    g_theta = torch.tensor(rng.normal(size=(B, T + 4, 3)).astype(np.float32))
    msum = torch.tensor(rng.normal(size=(B, T)).astype(np.float32))
    mpts = torch.tensor(rng.normal(size=(B, T, 3)).astype(np.float32))
    ctrl = torch.tensor(rng.uniform(-1, 1, (B, T, 3)).astype(np.float32))
    acc = torch.cat([g_theta.flatten(1), 2.0 * msum, (-2.0 * mpts).flatten(1)], dim=1)
    assert acc.shape == (B, 7 * T + tpsflow._BWD_AFFINE)
    gt, gc = tpsflow._bwd_from_sums(acc, ctrl)
    assert torch.equal(gt, g_theta)
    want = 2.0 * (ctrl.double() * msum.double()[..., None] - mpts.double())
    assert (gc.double() - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("spatial", [(5, 3, 13), (4, 6, 1)])
def test_affine_rows_are_the_sums_over_the_grid(rng, spatial):
    """The twelve sums the backward kernel takes while it stages the
    cotangent, [sum_n g_k; sum_n p_j g_k], are what the plain backward forms
    from g's three marginals against the separable grid: 1e-12 of the largest
    value between them in float64."""
    g = torch.tensor(rng.normal(size=(2, 3, *spatial))).double()
    pts = tpsflow._grid_points(spatial, "cpu").double()  # (N, 3)
    gf = g.reshape(2, 3, -1)
    want = torch.cat([gf.sum(-1)[:, None], torch.einsum("nj,bkn->bjk", pts, gf)], dim=1)
    got = tpsflow._affine_rows(g, spatial)
    assert got.shape == (2, 4, 3)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
