"""The port's geometry against keymorph_tpu's on the same numpy inputs: the
affine, rigid and approximate-TPS solvers, the aligner objects (normalized
and real-world coordinates), AffineTransform, the real-world coordinate
conversions, the displacement <-> flow converters and the affine flow as
planes.

Tolerances are stated per test and were measured at these seeds (printed
where a bar depends on conditioning). In real-world coordinates (millimetres,
tens from the origin) the affine Gram system is ill-conditioned in fp32, so
there both packages are held against a float64 solution of the same fit: the
port may be at most twice as far from it as keymorph_tpu, plus a floor.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.ops import coords as jcoords
from keymorph_tpu.ops import planes as jplanes
from keymorph_tpu.ops import resample as jresample
from keymorph_tpu.transforms import aligners as jaligners
from keymorph_tpu.transforms import solvers as jsolvers
from keymorph_tpu.transforms.affine import AffineTransform as JAffineTransform
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.ops import planes
from keymorph_tpu_torch.ops import resample
from keymorph_tpu_torch.transforms import aligners, solvers
from keymorph_tpu_torch.transforms.affine import AffineTransform, affine_flow

SPATIAL = (6, 7, 9)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot3(ax, ay, az):
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _affines(B=1):
    """The anisotropic voxel -> world affines of tests/test_keymorph_rw.py, the
    moving one also rotated."""
    aff_f = np.eye(4, dtype=np.float32)
    aff_f[:3, :3] = np.diag([1.0, 1.25, 2.0])
    aff_f[:3, 3] = [-40, -50, 30]
    aff_m = np.eye(4, dtype=np.float32)
    aff_m[:3, :3] = _rot3(0.1, -0.05, 0.2) @ np.diag([1.1, 1.2, 1.9])
    aff_m[:3, 3] = [-42, -48, 28]
    return (np.repeat(aff_f[None], B, 0).astype(np.float32),
            np.repeat(aff_m[None], B, 0).astype(np.float32))


def _pair(rng, B=2, T=16, noise=0.05):
    """Well-spread, generic (non-symmetric) keypoints and a moved copy."""
    pf = rng.uniform(-0.8, 0.8, (B, T, 3)).astype(np.float32)
    A = np.eye(3) + 0.1 * rng.normal(size=(3, 3))
    pm = pf @ A.T.astype(np.float32) + 0.05 + rng.normal(0, noise, pf.shape)
    return pf, pm.astype(np.float32)


def _weights(rng, B, T):
    w = rng.uniform(0.2, 1.0, (B, T)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol, what=""):
    """assert_allclose(atol) that prints the measured max abs difference."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    print(f"{what}: max abs diff {np.abs(got - want).max():.3g} (tol {atol:.3g})")
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_affine_matches_jax(rng, weighted):
    """(B=2, T=16) weighted least squares: 2e-5 (measured 1.8e-7)."""
    pf, pm = _pair(rng)
    w = _weights(rng, 2, 16) if weighted else None
    got = solvers.fit_affine(_t(pf), _t(pm), None if w is None else _t(w))
    want = jsolvers.fit_affine(jnp.asarray(pf), jnp.asarray(pm),
                               None if w is None else jnp.asarray(w))
    assert got.shape == (2, 3, 4) and got.dtype == torch.float32
    _close(got, want, 2e-5, f"fit_affine weighted={weighted}")


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_rigid_matches_jax(rng, weighted):
    """(B=3) rotation + translation with noise: R and T within 2e-5
    (measured 2.4e-7); R is a proper rotation."""
    B, T = 3, 20
    p1 = rng.uniform(-1, 1, (B, T, 3)).astype(np.float32)
    p2 = np.stack([p1[b] @ _rot3(*rng.uniform(-0.6, 0.6, 3)).T for b in range(B)])
    p2 = (p2 + rng.uniform(-0.2, 0.2, (B, 1, 3)) + rng.normal(0, 0.02, p1.shape)).astype(np.float32)
    w = _weights(rng, B, T) if weighted else None
    got = _np(solvers.fit_rigid(_t(p1), _t(p2), None if w is None else _t(w)))
    want = _np(jsolvers.fit_rigid(jnp.asarray(p1), jnp.asarray(p2),
                                  None if w is None else jnp.asarray(w)))
    _close(got, want, 2e-5, f"fit_rigid weighted={weighted}")
    for R in got[..., :3]:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)


def test_fit_rigid_reflection_case_matches_jax():
    """tests/test_solvers.py's near-planar reflection case: det(V U^T) = -1
    flips V's last column; the result is a proper rotation and equals
    keymorph_tpu's within 1e-5 (measured 4.7e-10)."""
    p1 = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0.01]]], np.float32)
    p2 = (p1 @ _rot3(0.0, 0.0, np.pi / 2).T).astype(np.float32)
    p2[0, -1, 2] = -0.01
    H = (p1[0] - p1[0].mean(0)).T @ (p2[0] - p2[0].mean(0))
    U, _, Vt = np.linalg.svd(H)
    assert np.linalg.det(Vt.T @ U.T) < 0  # the case the fix is for
    got = _np(solvers.fit_rigid(_t(p1), _t(p2)))
    _close(got, jsolvers.fit_rigid(jnp.asarray(p1), jnp.asarray(p2)), 1e-5, "reflection")
    assert np.linalg.det(got[0, :, :3]) == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("S", [5, 12])
def test_fit_tps_approximate_matches_jax(rng, S, weighted):
    """S < T = 16 centres, lmbda per batch row: theta within 1e-3 of its
    largest value (measured 5.2e-7 absolute; Householder QR in another
    order), the spline at 500 points within 1e-5 (measured 6.0e-7)."""
    pf, pm = _pair(rng)
    lm = np.array([0.1, 1.0], np.float32)
    w = _weights(rng, 2, 16) if weighted else None
    got = solvers.fit_tps_approximate(_t(pf), _t(pm), _t(lm), S, None if w is None else _t(w))
    want = _np(jsolvers.fit_tps_approximate(jnp.asarray(pf), jnp.asarray(pm), jnp.asarray(lm), S,
                                            None if w is None else jnp.asarray(w)))
    assert got.shape == (2, S + 4, 3)
    _close(got, want, 1e-3 * np.abs(want).max(), f"theta S={S} weighted={weighted}")
    q = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    _close(solvers.tps_eval(got, _t(pf[:, :S]), _t(q)),
           jsolvers.tps_eval(jnp.asarray(want), jnp.asarray(pf[:, :S]), jnp.asarray(q)), 1e-5,
           f"spline S={S} weighted={weighted}")


def test_fit_tps_approximate_with_every_centre_is_the_exact_fit(rng):
    """S = T: the least-squares system is square, and the spline equals
    ``fit_tps``'s within 1e-4 (measured 4.8e-7; the 1e-4 ridge rows and the
    1e-6 ridge floor of ``fit_tps`` differ)."""
    pf, pm = _pair(rng)
    q = _t(rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32))
    approx = solvers.fit_tps_approximate(_t(pf), _t(pm), 0.5, 16)
    exact = solvers.fit_tps(_t(pf), _t(pm), 0.5)
    _close(solvers.tps_eval(approx, _t(pf), q), solvers.tps_eval(exact, _t(pf), q), 1e-4,
           "S = T vs exact")
    with pytest.raises(ValueError):
        solvers.fit_tps_approximate(_t(pf), _t(pm), 0.5, 17)


def _flat(a):
    return a.reshape(a.shape[0], -1)


@pytest.mark.parametrize("kind", ["affine", "rigid", "tps", "tps_centers"])
@pytest.mark.parametrize("real_world", [False, True])
def test_aligners_match_jax(rng, kind, real_world):
    """Each aligner's flow field and its forward and inverse point transport
    against keymorph_tpu's. Normalized coordinates: 2e-5 (measured <= 7.8e-7).
    Real world: rigid and TPS within 1e-4 (measured <= 6.3e-6 and 4.0e-5 in
    normalized units), the affine forms within twice keymorph_tpu's own
    distance from a float64 fit plus 1e-4 (measured: keymorph_tpu 5.9e-4
    from float64, the port 4.7e-4 from keymorph_tpu)."""
    B, T = 1, 16
    pf, pm = _pair(rng, B, T)
    kw = {}
    jkw = {}
    if real_world:
        af, am = _affines(B)
        kw = dict(align_in_real_world_coords=True, aff_f=_t(af), aff_m=_t(am),
                  shape_f=SPATIAL, shape_m=SPATIAL)
        jkw = dict(align_in_real_world_coords=True, aff_f=jnp.asarray(af), aff_m=jnp.asarray(am),
                   shape_f=SPATIAL, shape_m=SPATIAL)
    if kind.startswith("tps"):
        extra = dict(lmbda=np.full((B,), 0.2, np.float32))
        if kind == "tps_centers":
            extra["num_centers"] = 10
        port = aligners.TPS(_t(pm), _t(pf), **extra, **kw)
        ref = jaligners.TPS(jnp.asarray(pm), jnp.asarray(pf), **extra, **jkw)
        flow_kw = dict(compute_on_subgrids=True)
    else:
        cls = {"affine": "AffineKeypointAligner", "rigid": "RigidKeypointAligner"}[kind]
        port = getattr(aligners, cls)(_t(pm), _t(pf), **kw)
        ref = getattr(jaligners, cls)(jnp.asarray(pm), jnp.asarray(pf), **jkw)
        flow_kw = {}
    q = rng.uniform(-0.9, 0.9, (B, 50, 3)).astype(np.float32)
    got = {"flow": port.get_flow_field((B, 1, *SPATIAL), **flow_kw),
           "forward": port.get_forward_transformed_points(_t(q)),
           "inverse": port.get_inverse_transformed_points(_t(q))}
    want = {"flow": ref.get_flow_field((B, 1, *SPATIAL), **flow_kw),
            "forward": ref.get_forward_transformed_points(jnp.asarray(q)),
            "inverse": ref.get_inverse_transformed_points(jnp.asarray(q))}
    assert got["flow"].shape == (B, *SPATIAL, 3)
    tol = {k: 2e-5 for k in got}
    if real_world and kind == "affine":
        truth = _affine_rw_float64(pf, pm, q, *_affines(B))
        for k in got:
            tol[k] = 2.0 * np.abs(_flat(_np(want[k])) - _flat(truth[k])).max() + 1e-4
            print(f"{kind} {k}: keymorph_tpu from float64 "
                  f"{np.abs(_flat(_np(want[k])) - _flat(truth[k])).max():.3g}, port from "
                  f"keymorph_tpu {np.abs(_np(got[k]) - _np(want[k])).max():.3g}")
    elif real_world:
        tol = {k: 1e-4 for k in got}
    for k in got:
        _close(got[k], want[k], tol[k], f"{kind} real_world={real_world} {k}")


def _affine_rw_float64(pf, pm, q, aff_f, aff_m):
    """The real-world affine aligner's outputs computed in float64 with numpy
    (least squares of the same fit)."""
    def n2r(p, a):
        v = (p + 1.0) * np.asarray(SPATIAL) / 2.0 - 0.5
        return v @ a[0, :3, :3].T + a[0, :3, 3]

    def r2n(p, a):
        v = (p - a[0, :3, 3]) @ np.linalg.inv(a[0, :3, :3]).T
        return 2.0 * (v + 0.5) / np.asarray(SPATIAL) - 1.0

    af, am = aff_f.astype(np.float64), aff_m.astype(np.float64)
    rf, rm = n2r(pf[0].astype(np.float64), af), n2r(pm[0].astype(np.float64), am)
    xh = np.concatenate([rf, np.ones((len(rf), 1))], 1)
    inv = np.eye(4)
    inv[:3] = np.linalg.lstsq(xh, rm, rcond=None)[0].T
    fwd = np.linalg.inv(inv)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in SPATIAL], indexing="ij"), -1)
    moved = r2n(n2r(grid.reshape(-1, 3), af) @ inv[:3, :3].T + inv[:3, 3], am)
    q64 = q[0].astype(np.float64)
    return {"flow": moved.reshape(1, *SPATIAL, 3)[..., ::-1],
            "forward": r2n(n2r(q64, am) @ fwd[:3, :3].T + fwd[:3, 3], af)[None],
            "inverse": r2n(n2r(q64, af) @ inv[:3, :3].T + inv[:3, 3], am)[None]}


def test_affine_transform_matches_jax(rng):
    """AffineTransform from either matrix: its inverse, grids and point
    transport against keymorph_tpu's within 1e-5 (measured 1.8e-7)."""
    M = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    M[:, :3] += 0.1 * rng.normal(size=(2, 3, 4)).astype(np.float32)
    q = rng.uniform(-1, 1, (2, 20, 3)).astype(np.float32)
    shape = (2, 1, *SPATIAL)
    for kw in ("matrix", "inverse_matrix"):
        port = AffineTransform(**{kw: _t(M)})
        ref = JAffineTransform(**{kw: jnp.asarray(M)})
        for a, b in ((port.transform_matrix, ref.transform_matrix),
                     (port.inverse_transform_matrix, ref.inverse_transform_matrix),
                     (port.get_flow_field(shape), ref.get_flow_field(shape)),
                     (port.affine_grid(shape), ref.affine_grid(shape)),
                     (port.get_forward_transformed_points(_t(q)),
                      ref.get_forward_transformed_points(jnp.asarray(q))),
                     (port.get_inverse_transformed_points(_t(q)),
                      ref.get_inverse_transformed_points(jnp.asarray(q)))):
            _close(a, b, 1e-5, kw)
    with pytest.raises(ValueError):
        AffineTransform()


def test_real_world_coordinate_conversions_match_jax(rng):
    """voxel <-> real, norm <-> real (batched anisotropic, rotated affines),
    the flow conversion, the voxel grid and the homogeneous form, against
    keymorph_tpu: within 1e-4 mm, 2e-5 voxel, 1e-5 normalized (measured
    3.8e-6, 7.6e-6, 2.6e-6: fp32 through an inverted affine at coordinates of
    tens), and norm -> real -> norm round trips within 1e-5 (measured
    1.8e-6)."""
    af, am = _affines(2)
    p = rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    v = rng.uniform(0, 8, (2, 30, 3)).astype(np.float32)
    r = np.asarray(jcoords.convert_points_voxel2real(jnp.asarray(v), jnp.asarray(am)))
    for got, want, tol in (
            (coords.convert_points_voxel2real(_t(v), _t(am)),
             jcoords.convert_points_voxel2real(jnp.asarray(v), jnp.asarray(am)), 1e-4),
            (coords.convert_points_real2voxel(_t(r), _t(am)),
             jcoords.convert_points_real2voxel(jnp.asarray(r), jnp.asarray(am)), 2e-5),
            (coords.convert_points_norm2real(_t(p), _t(af), SPATIAL),
             jcoords.convert_points_norm2real(jnp.asarray(p), jnp.asarray(af), SPATIAL), 1e-4),
            (coords.convert_points_real2norm(_t(r), _t(am), SPATIAL),
             jcoords.convert_points_real2norm(jnp.asarray(r), jnp.asarray(am), SPATIAL), 1e-5),
            (coords.convert_flow_voxel2norm(_t(v), SPATIAL),
             jcoords.convert_flow_voxel2norm(jnp.asarray(v), SPATIAL), 1e-6),
            (coords.uniform_voxel_grid(SPATIAL), jcoords.uniform_voxel_grid(SPATIAL), 0.0),
            (coords.homogeneous(_t(p)), jcoords.homogeneous(jnp.asarray(p)), 0.0)):
        _close(got, want, tol, "conversion")
    back = coords.convert_points_real2norm(coords.convert_points_norm2real(_t(p), _t(am), SPATIAL),
                                           _t(am), SPATIAL)
    _close(back, p, 1e-5, "round trip")


def test_displacement_flow_converters_match_jax(rng):
    """displacement2flow / flow2displacement and the reference aliases:
    within 1e-6 and 1e-5 of keymorph_tpu (measured 2.4e-7 and 0). (They are
    not each other's inverse: the reference normalizes by size - 1 against
    the xy-ordered sizes, and keymorph_tpu keeps that.)"""
    disp = rng.normal(0, 1.5, (2, *SPATIAL, 3)).astype(np.float32)
    flow = resample.displacement2flow(_t(disp))
    _close(flow, jresample.displacement2flow(jnp.asarray(disp)), 1e-6, "displacement2flow")
    np.testing.assert_allclose(_np(resample.displacement2pytorchflow(_t(disp))), _np(flow))
    back = resample.flow2displacement(flow)
    _close(back, jresample.flow2displacement(jnp.asarray(_np(flow))), 1e-5, "flow2displacement")
    np.testing.assert_allclose(_np(resample.pytorchflow2displacement(flow)), _np(back))
    assert back.shape == (2, 3, *SPATIAL)


def test_affine_flow_planes_match_jax_and_the_grid(rng):
    """Batched affine planes against keymorph_tpu's (vmapped) within 1e-6
    (measured 1.2e-7: the same products, contracted differently), and
    against the flip
    of ``affine_flow``'s grid; ``planes_to_grid`` inverts that flip, and
    ``affine_register_warp`` warps on those planes."""
    M = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    M[:, :3] += 0.1 * rng.normal(size=(2, 3, 4)).astype(np.float32)
    got = planes.affine_flow_planes(_t(M), SPATIAL)
    want = np.stack([_np(jplanes.affine_flow_planes(jnp.asarray(m), SPATIAL)) for m in M])
    assert got.shape == (2, 3, *SPATIAL) and got.dtype == torch.float32
    _close(got, want, 1e-6, "planes")
    grid = affine_flow(_t(M), SPATIAL)
    _close(planes.planes_to_grid(got), grid, 1e-6, "planes_to_grid vs affine_flow")
    img = _t(rng.random((2, 1, 5, 8, 6)).astype(np.float32))
    warped, pl = planes.affine_register_warp(_t(M), img, SPATIAL)
    jwarped, jpl = jplanes.affine_register_warp(jnp.asarray(M), jnp.asarray(_np(img)), SPATIAL)
    _close(pl, jpl, 1e-6, "affine_register_warp planes")
    _close(warped, jwarped, 1e-5, "affine_register_warp warped")
