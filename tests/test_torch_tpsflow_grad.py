"""Backward of the port's TPS flow planes and its points mode
(keymorph_tpu_torch/ops/cuda/tpsflow.py) against keymorph_tpu's.

``tps_planes`` is an autograd Function whose backward is, on the CPU, the
plain version of the backward kernel (a closed form over chunks of grid
points). The references are keymorph_tpu's Pallas backward kernel, which
interprets on the CPU backend by itself, and its XLA VJP (KM_NO_FAST_TPS=1).

Tolerance: 5e-5 of max(|gradient|, 1), keymorph_tpu's own bar between its two
paths (tests/test_tpsflow.py:131); against a float64 closed form the fp32
plain backward is held to 1e-5 of the largest value (fp32 sums over N grid
points).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keymorph_tpu.ops.pallas import tpsflow as jtps
from keymorph_tpu.transforms import solvers as jsolvers
from keymorph_tpu_torch.models.keymorph import align_pair
from keymorph_tpu_torch.ops.cuda import tpsflow
from keymorph_tpu_torch.transforms import solvers

SPATIAL = (16, 16, 32)  # N = 8192: a multiple of keymorph_tpu's kernel tile


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(rng, B, T):
    src = rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 0.08, (B, T, 3))).astype(np.float32)
    theta = np.asarray(jsolvers.fit_tps(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.full((B,), 0.5)))
    return theta, src, dst


def _close(got, want, tol):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("T", [24, 37])
def test_planes_backward_matches_jax(rng, monkeypatch, ref, T):
    """g_theta and g_ctrl for a random cotangent (T = 37: not a multiple of
    anything the kernels tile by)."""
    if ref == "xla":
        monkeypatch.setenv("KM_NO_FAST_TPS", "1")
    theta, ctrl, _ = _fit(rng, 2, T)
    cot = rng.normal(size=(2, 3, *SPATIAL)).astype(np.float32)
    out, vjp = jax.vjp(lambda th, c: jtps.tps_planes(th, c, SPATIAL),
                       jnp.asarray(theta), jnp.asarray(ctrl))
    jt, jc = (np.asarray(g) for g in vjp(jnp.asarray(cot)))

    th = torch.tensor(theta, requires_grad=True)
    c = torch.tensor(ctrl, requires_grad=True)
    planes = tpsflow.tps_planes(th, c, SPATIAL)
    planes.backward(torch.tensor(cot))
    np.testing.assert_allclose(planes.detach().numpy(), np.asarray(out), atol=2e-4)
    _close(th.grad.numpy(), jt, 5e-5)
    _close(c.grad.numpy(), jc, 5e-5)


def test_planes_backward_plain_against_float64(rng):
    """The fp32 closed form against itself in float64 on a ragged grid
    (one axis of size 1: its grid step is 0)."""
    spatial = (7, 1, 13)
    theta, ctrl, _ = _fit(rng, 1, 9)
    g = torch.tensor(rng.normal(size=(1, 3, *spatial)).astype(np.float32))
    args = (torch.tensor(theta), torch.tensor(ctrl), spatial, g)
    t32, c32 = tpsflow.tps_planes_bwd(*args)
    t64, c64 = tpsflow.tps_planes_bwd_plain(*args, dtype=torch.float64)
    assert t32.dtype == torch.float32 and t32.shape == (1, 13, 3) and c32.shape == (1, 9, 3)
    _close(t32.numpy(), t64.numpy(), 1e-5)
    _close(c32.numpy(), c64.numpy(), 1e-5)
    # and against autograd through the plain spline evaluation in float64
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    c = torch.tensor(ctrl, dtype=torch.float64, requires_grad=True)
    pts = tpsflow._grid_points(spatial, "cpu").double()[None]
    solvers.tps_eval(th, c, pts).transpose(1, 2).reshape(1, 3, *spatial).backward(g.double())
    _close(t32.numpy(), th.grad.numpy(), 1e-5)
    _close(c32.numpy(), c.grad.numpy(), 1e-5)


@pytest.mark.parametrize("N", [2048, 1000])
def test_tps_flow_points_mode_matches_jax(rng, N):
    """tps_flow at given points against keymorph_tpu's: its Pallas kernel for
    N a multiple of its tile (2e-4: the TPU kernel contracts in bf16 hi/lo
    parts), its plain evaluation for a ragged N (1e-5)."""
    theta, ctrl, _ = _fit(rng, 2, 24)
    pts = rng.uniform(-1, 1, (2, N, 3)).astype(np.float32)
    got = tpsflow.tps_flow(torch.tensor(theta), torch.tensor(ctrl), torch.tensor(pts)).numpy()
    if N % 2048 == 0:
        want = np.asarray(jtps.tps_flow(jnp.asarray(theta), jnp.asarray(ctrl), jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, atol=2e-4)
    want = np.asarray(jsolvers.tps_eval(jnp.asarray(theta), jnp.asarray(ctrl), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_align_pair_gradient_through_fit_and_planes_matches_jax(rng):
    """Keypoints -> fit_tps (torch.linalg.solve, fp32) -> tps_planes: the
    gradient to both keypoint sets, per-sample lambda and weights, against
    jax.grad of keymorph_tpu's align_pair. 2e-4 of the largest value: the
    fp32 solve and its adjoint run through different LAPACK paths."""
    from keymorph_tpu.models.keymorph import align_pair as jalign_pair

    B, T = 2, 12
    pf = rng.uniform(-0.7, 0.7, (B, T, 3)).astype(np.float32)
    pm = (pf + rng.normal(0, 0.05, (B, T, 3))).astype(np.float32)
    lm = np.array([0.3, 2.0], np.float32)
    wts = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    cot = rng.normal(size=(B, 3, *SPATIAL)).astype(np.float32)

    def jloss(pf_, pm_, w_):
        out = jalign_pair(pf_, pm_, "tps", SPATIAL, lmbda=jnp.asarray(lm), weights=w_,
                          num_chunks=1, compute_grid="planes")
        return jnp.sum(out["planes"] * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(pf), jnp.asarray(pm),
                                               jnp.asarray(wts))
    leaves = [torch.tensor(a, requires_grad=True) for a in (pf, pm, wts)]
    out = align_pair(leaves[0], leaves[1], "tps", SPATIAL, lmbda=torch.tensor(lm),
                     weights=leaves[2], compute_grid="planes")
    (out["planes"] * torch.tensor(cot)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad.numpy(), np.asarray(w), 2e-4)
