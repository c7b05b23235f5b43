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
