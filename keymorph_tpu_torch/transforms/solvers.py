"""Closed-form thin-plate-spline solver and evaluation (fp32).

Port of the TPS part of ``keymorph_tpu/transforms/solvers.py``; affine,
rigid and approximate TPS are not ported yet. Everything upcasts to fp32
(geometry never runs in reduced precision; callers keep TF32 off, see
:func:`keymorph_tpu_torch.disable_tf32`).
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
    return torch.linalg.solve(A, v)


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
    """The spline at dense points (B, N, 3), through
    ``ops.cuda.tpsflow.tps_flow``: CUDA tensors run the TPS-flow kernel in
    points mode, CPU tensors :func:`tps_eval_chunked_plain`."""
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
