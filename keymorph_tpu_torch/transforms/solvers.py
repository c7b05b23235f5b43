"""Closed-form keypoint-alignment solvers and TPS evaluation (fp32).

Port of ``keymorph_tpu/transforms/solvers.py``: the weighted least-squares
affine fit, the Arun SVD rigid fit, the exact TPS fit and the approximate
(first-S-centres, least-squares) TPS fit. Everything upcasts to fp32
(geometry never runs in reduced precision; callers keep TF32 off, see
:func:`keymorph_tpu_torch.disable_tf32`). Linear systems go through
``solve_ex``: ``solve`` checks for a singular matrix by synchronizing the
host with the card.
"""

from __future__ import annotations

import torch

EPS_DIST = 1e-6
EPS_LOG = 1e-6


def square_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., d, d+1) -> homogeneous (..., d+1, d+1) with bottom row [0..0 1]."""
    d = m.shape[-2]
    bottom = torch.zeros((*m.shape[:-2], 1, d + 1), dtype=m.dtype, device=m.device)
    bottom[..., 0, d] = 1.0
    return torch.cat([m, bottom], dim=-2)


def fit_affine(x: torch.Tensor, y: torch.Tensor, w=None) -> torch.Tensor:
    """Weighted least-squares affine ``argmin_A ||A x~ - y||`` (x~ homogeneous):
    one solve of the (d+1)^2 Gram system, ``A^T = (x~ W x~^T)^-1 x~ W y``.

    Args:
        x, y: (B, N, d) source and target points.
        w: optional (B, N) per-point weights.
    Returns:
        (B, d, d+1) affine matrix mapping x -> y.
    """
    x, y = x.float(), y.float()
    xh = torch.cat([x, torch.ones((*x.shape[:-1], 1), device=x.device)], dim=-1)
    xw = xh * w.float()[..., None] if w is not None else xh
    gram = xw.transpose(-1, -2) @ xh  # (B, d+1, d+1)
    rhs = xw.transpose(-1, -2) @ y  # (B, d+1, d)
    return torch.linalg.solve_ex(gram, rhs)[0].transpose(-1, -2)


def fit_rigid(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """Arun/SVD rigid fit ``argmin_{R,T} sum_i ||p2_i - (R p1_i + T)||``.

    With weights (expected to sum to 1 per batch row) both centred sets are
    scaled by w before the covariance. Where det(V U^T) < 0 the sign of V's
    LAST COLUMN flips (keymorph_tpu's dim-generic correction, not the
    reference's last-row form).

    Args:
        p1, p2: (B, N, d) source and target points.
        w: optional (B, N) weights.
    Returns:
        (B, d, d+1) rigid matrix [R | T] mapping p1 -> p2.
    """
    p1, p2 = p1.float(), p2.float()
    d = p1.shape[-1]
    if w is not None:
        w = w.float()[..., None]
        c1 = torch.sum(p1 * w, dim=1, keepdim=True)
        c2 = torch.sum(p2 * w, dim=1, keepdim=True)
        q1, q2 = (p1 - c1) * w, (p2 - c2) * w
    else:
        c1, c2 = p1.mean(dim=1, keepdim=True), p2.mean(dim=1, keepdim=True)
        q1, q2 = p1 - c1, p2 - c2
    H = q1.transpose(-1, -2) @ q2  # (B, d, d)
    U, _, Vh = torch.linalg.svd(H, full_matrices=False)
    V = Vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    scale = torch.cat([torch.ones((*sign.shape, d - 1), device=sign.device),
                       sign[..., None]], dim=-1)  # (B, d)
    R = (V * scale[..., None, :]) @ U.transpose(-1, -2)
    T = c2.transpose(1, 2) - R @ c1.transpose(1, 2)  # (B, d, 1)
    return torch.cat([R, T], dim=-1)


def tps_pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(||a_i - b_j||^2 + 1e-6): (B, Na, d), (B, Nb, d) -> (B, Na, Nb).

    Difference form: the |a|^2+|b|^2-2ab expansion cancels catastrophically
    for large coordinates.
    """
    diff = a.float()[..., :, None, :] - b.float()[..., None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    return torch.sqrt(sq + EPS_DIST)


def tps_rbf(r: torch.Tensor) -> torch.Tensor:
    """U(r) = r^2 log(r + 1e-6)."""
    return r * r * torch.log(r + EPS_LOG)


def fit_tps(c_src: torch.Tensor, c_dst: torch.Tensor, lmbda, w=None) -> torch.Tensor:
    """Solve the TPS interpolation system for all output dims at once.

        [K + diag(reg)  P] [w]   [v]
        [        P^T    0] [a] = [0]

    with K = U(d(ctrl, ctrl)), P = [1 | ctrl] and reg = lmbda (or
    lmbda / (w + 1e-6) per point when weights are given, on the diagonal
    only), floored at 1e-6 so that coincident keypoints at lmbda = 0 keep
    the system solvable.

    Args:
        c_src: (B, T, d) control points.
        c_dst: (B, T, d) target points.
        lmbda: scalar or (B,) regularization.
        w: optional (B, T) weights.
    Returns:
        theta: (B, T+d+1, d) — spline weights (T rows) then the affine part
        (constant row first, then one row per input dim).
    """
    c_src = c_src.float()
    c_dst = c_dst.float()
    B, T, d = c_src.shape
    dev = c_src.device
    lmbda = torch.as_tensor(lmbda, dtype=torch.float32, device=dev).reshape(-1, 1)
    lmbda = lmbda.expand(B, 1)

    K = tps_rbf(tps_pairwise_dist(c_src, c_src))  # (B, T, T)
    if w is not None:
        reg = lmbda / (w.float() + 1e-6)
    else:
        reg = lmbda.expand(B, T)
    reg = torch.clamp(reg, min=1e-6)
    K = K + torch.diag_embed(reg)

    P = torch.cat([torch.ones((B, T, 1), device=dev), c_src], dim=-1)
    zeros = torch.zeros((B, d + 1, d + 1), device=dev)
    A = torch.cat(
        [torch.cat([K, P], dim=-1), torch.cat([P.transpose(-1, -2), zeros], dim=-1)],
        dim=-2,
    )  # (B, T+d+1, T+d+1)
    v = torch.cat([c_dst, torch.zeros((B, d + 1, d), device=dev)], dim=-2)
    return torch.linalg.solve_ex(A, v)[0]


def fit_tps_approximate(c_src: torch.Tensor, c_dst: torch.Tensor, lmbda, num_subsample: int,
                        w=None) -> torch.Tensor:
    """Approximate TPS (Donato & Belongie, method 2): only the first
    ``num_subsample`` = S control points are RBF centres, and the
    overdetermined (T+d+1) x (S+d+1) system is solved by least squares.
    Spline evaluation then costs O(S) per point instead of O(T). Callers
    choose the centres by permuting the points beforehand.

    The least squares go through a reduced QR and a triangular solve, not
    the normal equations, which square the condition number (near-duplicate
    keypoints reach cond(A^T A) ~ 4e5, where an fp32 solve loses most of the
    mantissa); the ridge rides as 1e-4 * I rows appended to A.

    Returns:
        theta: (B, S+d+1, d); evaluate with ``tps_eval(theta,
        c_src[:, :S], points)``.
    """
    c_src, c_dst = c_src.float(), c_dst.float()
    B, T, d = c_src.shape
    S = int(num_subsample)
    if not 0 < S <= T:
        raise ValueError(f"fit_tps_approximate: num_subsample={S} not in [1, {T}]")
    dev = c_src.device
    lmbda = torch.as_tensor(lmbda, dtype=torch.float32, device=dev).reshape(-1, 1)
    lmbda = lmbda.expand(B, 1)
    sub = c_src[:, :S]

    K = tps_rbf(tps_pairwise_dist(c_src, sub))  # (B, T, S)
    eye_ts = torch.eye(T, S, device=dev)[None]
    reg = lmbda / (w.float() + 1e-6) if w is not None else lmbda
    K = K + reg[..., None] * eye_ts

    P = torch.cat([torch.ones((B, T, 1), device=dev), c_src], dim=-1)
    P_sub = torch.cat([torch.ones((B, S, 1), device=dev), sub], dim=-1)
    A = torch.cat(
        [torch.cat([K, P], dim=-1),
         torch.cat([P_sub.transpose(-1, -2), torch.zeros((B, d + 1, d + 1), device=dev)],
                   dim=-1)],
        dim=-2,
    )  # (B, T+d+1, S+d+1)
    v = torch.cat([c_dst, torch.zeros((B, d + 1, d), device=dev)], dim=-2)
    n = A.shape[-1]
    ridge = (1e-4 * torch.eye(n, device=dev)).expand(B, n, n)
    A_aug = torch.cat([A, ridge], dim=-2)
    v_aug = torch.cat([v, torch.zeros((B, n, d), device=dev)], dim=-2)
    Q, R = torch.linalg.qr(A_aug, mode="reduced")  # Q (B, M, n), R (B, n, n)
    return torch.linalg.solve_triangular(R, Q.transpose(-1, -2) @ v_aug, upper=True)


def tps_eval(theta: torch.Tensor, ctrl: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """f(p) = a0 + a . p + sum_t w_t U(||p - ctrl_t||) at (B, N, d) points.

    Materializes the (B, T, N) RBF matrix; see :func:`tps_eval_chunked`
    for dense grids.
    """
    d = points.shape[-1]
    wgt, affine = theta[:, : -(d + 1), :], theta[:, -(d + 1):, :]
    U = tps_rbf(tps_pairwise_dist(ctrl, points))  # (B, T, N)
    b = torch.einsum("btn,btd->bnd", U, wgt.float())
    P = torch.cat([torch.ones((*points.shape[:-1], 1), device=points.device),
                   points.float()], dim=-1)
    z = torch.einsum("bnk,bkd->bnd", P, affine.float())
    return z + b


CHUNK_POINTS = 1 << 20  # bounds the RBF matrix at (B, T, 2^20) fp32


def tps_eval_chunked(theta, ctrl, points):
    """The spline at dense points (B, N, d). In 3D through
    ``ops.cuda.tpsflow.tps_flow``: CUDA tensors run the TPS-flow kernel in
    points mode, CPU tensors :func:`tps_eval_chunked_plain`. In 2D, on any
    device, :func:`tps_eval_chunked_plain` itself: keymorph_tpu's kernel
    takes d = 3 only and evaluates a 2D spline by its chunked XLA form."""
    if points.shape[-1] == 2:
        return tps_eval_chunked_plain(theta, ctrl, points)
    from keymorph_tpu_torch.ops.cuda import tpsflow  # it imports this module

    return tpsflow.tps_flow(theta.float().contiguous(), ctrl.float().contiguous(),
                            points.float().contiguous())


def tps_eval_chunked_plain(theta, ctrl, points):
    """:func:`tps_eval` over sequential chunks of ``CHUNK_POINTS`` points,
    so the RBF matrix never exceeds (B, T, CHUNK_POINTS)."""
    outs = [
        tps_eval(theta, ctrl, points[:, s: s + CHUNK_POINTS])
        for s in range(0, points.shape[1], CHUNK_POINTS)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
