"""The port's TPS solver and flow planes (keymorph_tpu_torch/transforms/
solvers.py, ops/cuda/tpsflow.py) against keymorph_tpu's.

On the CPU ``tps_planes`` runs its plain version; keymorph_tpu's TPS-flow
Pallas kernel runs in interpret mode, as its own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.ops import coords as jcoords
from keymorph_tpu.ops.pallas import tpsflow as jtps
from keymorph_tpu.transforms import solvers as jsolvers
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.ops.cuda import tpsflow
from keymorph_tpu_torch.transforms import solvers

SPATIAL = (16, 16, 32)  # N = 8192: a multiple of keymorph_tpu's kernel tile


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keypoints(rng, B, T):
    src = rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 0.08, (B, T, 3))).astype(np.float32)
    lmbda = rng.uniform(0.05, 1.0, B).astype(np.float32)
    return src, dst, lmbda


def _jax_grid_planes(theta, ctrl, spatial):
    n = int(np.prod(spatial))
    B = theta.shape[0]
    pts = jnp.broadcast_to(jcoords.flat_norm_grid(spatial), (B, n, 3))
    moved = jsolvers.tps_eval(jnp.asarray(theta), jnp.asarray(ctrl), pts)
    return np.asarray(jnp.moveaxis(moved, -1, 1).reshape(B, 3, *spatial))


@pytest.mark.parametrize("T", [16, 130])
def test_fit_tps_matches_jax(rng, T):
    """Same system, same fp32 solve: theta agrees to fp32 solve noise,
    1e-5 of theta's largest magnitude."""
    src, dst, lmbda = _keypoints(rng, 2, T)
    got = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), torch.tensor(lmbda)).numpy()
    want = np.asarray(jsolvers.fit_tps(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(lmbda)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_fit_tps_weighted_matches_jax(rng):
    """The diag-only weighted regularizer lmbda / (w + 1e-6)."""
    src, dst, _ = _keypoints(rng, 1, 12)
    w = rng.uniform(0.1, 1.0, (1, 12)).astype(np.float32)
    got = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), 0.5,
                          torch.tensor(w)).numpy()
    want = np.asarray(jsolvers.fit_tps(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.full((1,), 0.5), jnp.asarray(w)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_fit_tps_ridge_floor_keeps_duplicates_finite(rng):
    """At lmbda = 0 two coincident keypoints make K singular; the 1e-6
    ridge floor keeps the solve finite. The system is too ill-conditioned
    for two fp32 solvers to agree on theta, so only finiteness is checked."""
    src, dst, _ = _keypoints(rng, 1, 12)
    src[0, 5] = src[0, 4]
    theta = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), 0.0)
    assert torch.all(torch.isfinite(theta))
    moved = solvers.tps_eval(theta, torch.tensor(src), torch.tensor(src))
    assert torch.all(torch.isfinite(moved))


@pytest.mark.parametrize("T", [16, 130])
def test_tps_planes_matches_jax_tps_eval(rng, T):
    """fit_tps + plain tps_planes vs JAX fit_tps + tps_eval on the grid:
    abs <= 2e-5 (fp32 solve and contraction noise)."""
    src, dst, lmbda = _keypoints(rng, 2, T)
    theta = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), torch.tensor(lmbda))
    got = tpsflow.tps_planes(theta.contiguous(), torch.tensor(src), SPATIAL).numpy()
    jtheta = jsolvers.fit_tps(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(lmbda))
    want = _jax_grid_planes(jtheta, src, SPATIAL)
    assert got.shape == (2, 3, *SPATIAL)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("T", [16, 130])
def test_tps_planes_matches_jax_kernel(rng, T):
    """vs keymorph_tpu's TPS-flow kernel (interpret mode), whose RBF
    contraction runs as a bf16 hi/lo split: abs <= 2e-4, the bar its own
    tests use (tests/test_tpsflow.py)."""
    src, dst, lmbda = _keypoints(rng, 2, T)
    jtheta = jsolvers.fit_tps(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(lmbda))
    want = np.asarray(jtps.tps_planes(jtheta, jnp.asarray(src), SPATIAL))
    got = tpsflow.tps_planes(torch.tensor(np.asarray(jtheta)), torch.tensor(src),
                             SPATIAL).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_identity_grid_matches_linspace(rng):
    """The in-kernel identity grid (idx * 2/(S-1) - 1) is the inclusive
    linspace grid: an identity spline (theta = [0; I]) returns it, within
    1 fp32 ulp of linspace's own rounding."""
    spatial = (5, 1, 7)
    T = 4
    theta = torch.zeros((1, T + 4, 3))
    theta[0, T + 1:] = torch.eye(3)
    planes = tpsflow.tps_planes(theta, torch.tensor(rng.uniform(-1, 1, (1, T, 3)),
                                                    dtype=torch.float32), spatial)
    grid = coords.uniform_norm_grid(spatial)  # (5, 1, 7, 3)
    np.testing.assert_allclose(planes[0].permute(1, 2, 3, 0).numpy(), grid.numpy(),
                               atol=2.5e-7)


def test_wrapper_counts_plain_calls_on_cpu(rng):
    src, dst, lmbda = _keypoints(rng, 1, 8)
    theta = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), 1.0)
    n0, l0 = tpsflow.tps_planes_plain.calls, tpsflow.tps_planes.launches
    tpsflow.tps_planes(theta, torch.tensor(src), (4, 4, 4))
    assert tpsflow.tps_planes_plain.calls == n0 + 1
    assert tpsflow.tps_planes.launches == l0


def test_square_matrix_matches_jax(rng):
    m = rng.normal(size=(2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(solvers.square_matrix(torch.tensor(m)).numpy(),
                                  np.asarray(jsolvers.square_matrix(jnp.asarray(m))))


def test_plain_versions_at_3000_control_points_match_jax_tps_eval(rng):
    """Past the 2048 control points the wrappers once refused: the plain
    tps_planes and tps_flow against keymorph_tpu's tps_eval (XLA) on one fit
    (the port's), within 2e-5 (the bar at T = 16 and 130) or twice
    keymorph_tpu's own distance from the float64 evaluation of the same
    formula, whichever is larger: over 3000 terms each package's fp32 sum
    can lie more than 2e-5 from float64 on its own, so a flat 2e-5 between
    the two would hold their rounding to less than either has."""
    src, dst, lmbda = _keypoints(rng, 1, 3000)
    theta = solvers.fit_tps(torch.tensor(src), torch.tensor(dst), torch.tensor(lmbda))
    theta, ctrl = theta.contiguous(), torch.tensor(src)
    jtheta, jsrc = jnp.asarray(theta.numpy()), jnp.asarray(src)
    spatial = (6, 7, 8)
    pts = rng.uniform(-1.2, 1.2, (1, 300, 3)).astype(np.float32)
    cases = [
        (tpsflow.tps_planes(theta, ctrl, spatial),
         _jax_grid_planes(jtheta, src, spatial),
         tpsflow.tps_planes_plain(theta, ctrl, spatial, dtype=torch.float64)),
        (tpsflow.tps_flow(theta, ctrl, torch.tensor(pts)),
         np.asarray(jsolvers.tps_eval(jtheta, jsrc, jnp.asarray(pts))),
         tpsflow.tps_flow_plain(theta, ctrl, torch.tensor(pts), dtype=torch.float64)),
    ]
    for got, want, ref in cases:
        got, ref = got.numpy(), ref.numpy()
        assert got.shape == want.shape
        bar = max(2e-5, 2.0 * np.abs(want - ref).max())
        assert np.abs(got - want).max() <= bar, (np.abs(got - want).max(), bar)


@pytest.mark.parametrize("B,T", [(1, 4096), (70000, 1)], ids=["T4096", "B70000"])
def test_launch_checks_take_any_T_and_B(B, T):
    """The TPS and warp launch checks no longer refuse T > 2048 or B > 65535
    (the kernels tile T and walk the batch past the grid's 65535 rows): on
    the CPU, shapes that size pass every size check and raise for the
    device alone (the TPS check's last; the warp's comes after its 2^31
    voxels, as test_torch_warp.py's 2^31 - 1 show)."""
    from keymorph_tpu_torch.ops.cuda import resample3d

    theta, ctrl = torch.zeros((B, T + 4, 3)), torch.zeros((B, T, 3))
    for name in ("tps_planes", "tps_planes_bwd", "tps_flow"):
        with pytest.raises(ValueError, match="one CUDA device"):
            tpsflow._check_spline(name, theta, ctrl)
    img, planes = torch.zeros((B, 1, 2, 2, 2)), torch.zeros((B, 3, 2, 2, 2))
    for name in ("warp_planes", "warp_planes_grad"):
        with pytest.raises(ValueError, match="one CUDA device"):
            resample3d._check(name, img, planes)
