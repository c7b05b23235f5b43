"""Fits, flows and the warp of a registration, in float32.

Keypoints are (B, T, 3), ``ij`` order, in [-1, 1]. A fit maps the fixed
keypoints onto the moving ones; its flow is that map at every voxel of the
fixed grid, ``ij``-ordered planes (B, 3, D, H, W) over the grid
``idx * 2 / (N - 1) - 1`` of each axis; the warp samples the moving volume
there, trilinearly, as ``grid_sample`` does with border padding and
``align_corners=False``.

  * affine: weighted least squares by the normal equations;
  * rigid: Arun's SVD method, with the sign of V's last column flipped
    where det(V U^T) < 0;
  * TPS: the interpolation system [[K + lambda I, P], [P^T, 0]] with
    U(r) = r^2 log(r + 1e-6) on r = sqrt(|a - b|^2 + 1e-6), lambda floored
    at 1e-6 (the floor keeps coincident keypoints solvable at lambda 0: the
    program under test states it, and the reference follows it).

Products run at the geometry's precision (``Precision.geometry``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kmbench.reference.precision import Precision, mm

CHUNK_ELEMENTS = 1 << 26  # points x centres held at once by the spline


def parse_transform(name: str):
    """'tps_0.1' -> ('tps', 0.1); 'affine', 'rigid' -> (name, None)."""
    if name.startswith("tps_"):
        return "tps", float(name[4:])
    if name in ("affine", "rigid"):
        return name, None
    raise ValueError(f"transform {name!r}")


def axis_coords(n: int, device):
    step = torch.tensor(2.0 / (n - 1) if n > 1 else 0.0, dtype=torch.float32).item()
    return torch.arange(n, device=device, dtype=torch.float32) * step - 1.0


def grid_points(spatial, device, start: int = 0, stop=None):
    """Fixed-grid points [start, stop) in flat order, (n, 3) ``ij``."""
    D, H, W = spatial
    z, y, x = (axis_coords(s, device) for s in spatial)
    n = torch.arange(start, D * H * W if stop is None else stop, device=device)
    return torch.stack([z[n // (H * W)], y[(n // W) % H], x[n % W]], dim=-1)


def homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def fit_affine(pf, pm, prec: Precision):
    """(B, 3, 4) least-squares map of pf onto pm."""
    xh = homogeneous(pf)
    xt = xh.transpose(-1, -2)
    return torch.linalg.solve(mm(xt, xh, prec), mm(xt, pm, prec)).transpose(-1, -2)


def fit_rigid(pf, pm, prec: Precision):
    """(B, 3, 4) rotation and translation of pf onto pm."""
    c1, c2 = pf.mean(dim=1, keepdim=True), pm.mean(dim=1, keepdim=True)
    H = mm((pf - c1).transpose(-1, -2), pm - c2, prec)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(mm(V, U.transpose(-1, -2), prec)))
    V = torch.cat([V[..., :2], V[..., 2:] * sign[:, None, None]], dim=-1)
    R = mm(V, U.transpose(-1, -2), prec)
    T = c2.transpose(1, 2) - mm(R, c1.transpose(1, 2), prec)
    return torch.cat([R, T], dim=-1)


def rbf(r2):
    r = torch.sqrt(r2 + 1e-6)
    return r * r * torch.log(r + 1e-6)


def sq_dist(a, b):
    """|a_i - b_j|^2, (B, N, 3) x (B, T, 3) -> (B, N, T), coordinate by
    coordinate."""
    return sum((a[..., k, None] - b[..., None, :, k]) ** 2 for k in range(3))


def fit_tps(pf, pm, lmbda, prec: Precision):
    """theta (B, T + 4, 3): the spline's T weights, then the affine part
    (constant row first), mapping pf onto pm."""
    B, T, _ = pf.shape
    lam = torch.clamp(torch.as_tensor(lmbda, dtype=torch.float32, device=pf.device)
                      .reshape(-1, 1).expand(B, 1), min=1e-6)
    K = rbf(sq_dist(pf, pf)) + torch.diag_embed(lam.expand(B, T))
    P = homogeneous(pf)[..., [3, 0, 1, 2]]  # [1, z, y, x]
    A = torch.cat([torch.cat([K, P], dim=-1),
                   torch.cat([P.transpose(-1, -2), torch.zeros(B, 4, 4, device=pf.device)],
                             dim=-1)], dim=-2)
    v = torch.cat([pm, torch.zeros(B, 4, 3, device=pf.device)], dim=-2)
    return torch.linalg.solve(A, v)


def tps_at(theta, ctrl, points, prec: Precision):
    """The spline at (B, n, 3) points -> (B, n, 3)."""
    T = ctrl.shape[1]
    U = rbf(sq_dist(points, ctrl))  # (B, n, T)
    return mm(U, theta[:, :T], prec) + mm(homogeneous(points)[..., [3, 0, 1, 2]],
                                          theta[:, T:], prec)


def _planes(fn, B, spatial, device, per_chunk):
    n = spatial[0] * spatial[1] * spatial[2]
    outs = [fn(grid_points(spatial, device, s, min(n, s + per_chunk)).expand(B, -1, 3))
            for s in range(0, n, per_chunk)]
    return torch.cat(outs, dim=1).transpose(1, 2).reshape(B, 3, *spatial)


def tps_planes(theta, ctrl, spatial, prec: Precision):
    per = max(1, CHUNK_ELEMENTS // ctrl.shape[1])
    return _planes(lambda p: tps_at(theta, ctrl, p, prec), theta.shape[0], tuple(spatial),
                   theta.device, per)


def affine_planes(matrix, spatial, prec: Precision):
    """Planes of a (B, 3, 4) or (B, 4, 4) fixed -> moving matrix."""
    m = matrix[:, :3].transpose(-1, -2)  # (B, 4, 3)
    return _planes(lambda p: mm(homogeneous(p), m, prec), matrix.shape[0], tuple(spatial),
                   matrix.device, CHUNK_ELEMENTS // 4)


def flow(transform: str, pf, pm, spatial, prec: Precision):
    """The planes of one named transform (``rigid``, ``affine``,
    ``tps_<lambda>``) of pf onto pm."""
    kind, lmbda = parse_transform(transform)
    if kind == "tps":
        return tps_planes(fit_tps(pf, pm, lmbda, prec), pf, spatial, prec)
    fit = fit_affine if kind == "affine" else fit_rigid
    return affine_planes(fit(pf, pm, prec), spatial, prec)


def warp(img, planes, prec: Precision):
    """Trilinear sample of (B, C, Z, Y, X) ``img`` at ``ij`` planes
    (B, 3, D, H, W), border padding, ``align_corners=False``."""
    grid = torch.flip(planes.permute(0, 2, 3, 4, 1), dims=(-1,))  # xy order
    return F.grid_sample(prec.geo_operand(img), prec.geo_operand(grid), mode="bilinear",
                         padding_mode="border", align_corners=False)


def augment_matrix(scale, offset, theta, shear):
    """(B, 4, 4) = Shear @ Scale @ Translate @ Rz @ Ry @ Rx, the rotations
    about the three axes by ``theta``'s angles in turn."""
    B, dev = scale.shape[0], scale.device

    def eye():
        return torch.eye(4, device=dev).repeat(B, 1, 1)

    S = torch.diag_embed(torch.cat([scale, torch.ones(B, 1, device=dev)], dim=1))
    Tm = eye()
    Tm[:, :3, 3] = offset
    rots = []
    for i, (a, b) in enumerate(((1, 2), (0, 2), (0, 1))):
        c, s = torch.cos(theta[:, i]), torch.sin(theta[:, i])
        R = eye()
        sign = 1.0 if i == 1 else -1.0
        R[:, a, a], R[:, b, b] = c, c
        R[:, a, b], R[:, b, a] = sign * s, -sign * s
        rots.append(R)
    Z = eye()
    for k, (r, c) in enumerate(((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))):
        Z[:, r, c] = shear[:, k]
    return Z @ (S @ (Tm @ (rots[2] @ (rots[1] @ rots[0]))))


def augment(img, scale, offset, theta, shear, prec: Precision):
    """The moving volume under the affine augmentation: sampled through
    the flow of the matrix's inverse."""
    inverse = torch.linalg.inv(augment_matrix(scale, offset, theta, shear))
    return warp(img, affine_planes(inverse, img.shape[2:], prec), prec)
