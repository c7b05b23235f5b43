"""Dense TPS flow: ``tps_planes`` (identity grid, plane-major, with its
backward) and ``tps_flow`` (given points).

Port of ``keymorph_tpu/ops/pallas/tpsflow.py``: kernel B4 (``tps_planes``,
identity-grid mode), B4p (``tps_flow``, points mode) and B7 (the backward of
``tps_planes``). The CUDA kernels are in ``csrc/tpsflow.cu``; the plain
PyTorch versions beside each wrapper compute the same functions in chunks of
points and are what CPU tensors run.

``tps_planes`` is a ``torch.autograd.Function``. Its backward gives the
cotangents of the spline ``theta`` (B, T+4, 3) and the control points
(B, T, 3) without ever holding the (T, N) RBF matrix: per control point the
kernel sums ``g_k U`` (the spline-weight rows), ``m`` and ``m p_j`` with
``m = (sum_k w[t, k] g_k) dU/dsq``, and beside them the affine rows of
``g_theta`` (``sum g`` and ``sum g p``), one row of partial sums per block;
the wrapper adds the rows and forms ``g_ctrl = 2 (ctrl * sum m - sum m p)``.
The plain backward takes the affine rows as reductions of the cotangent
against the separable identity grid. ``tps_flow``'s gradient is the autograd
of the plain evaluation, as keymorph_tpu's is the XLA VJP.

The plain versions take a ``dtype``: float64 evaluates the same formula, step
by step, in double precision on the same fp32 inputs and grid, which is what
the kernels' distance from the truth is stated against.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from keymorph_tpu_torch import _build
from keymorph_tpu_torch.transforms import solvers

_MAX_T = 2048  # the most control points the wrappers take (the kernels tile T)
_BWD_CHUNK = 1 << 18  # grid points per chunk of the plain backward and of _spline
_BWD_AFFINE = 12  # the backward kernel's sums for g_theta's affine rows


def _steps(spatial):
    """Per-axis identity-grid step 2/(S-1) in fp32 (0 for a size-1 axis)."""
    return [float(torch.tensor(2.0 / (s - 1) if s > 1 else 0.0,
                               dtype=torch.float32)) for s in spatial]


def _axis_coords(spatial, device):
    """The identity grid's per-axis coordinates ``idx * step - 1`` (fp32)."""
    return [torch.arange(s, device=device, dtype=torch.float32) * st - 1.0
            for s, st in zip(spatial, _steps(spatial))]


def _grid_points(spatial, device, start=0, stop=None):
    """Identity-grid points [start, stop) of the flat index, (n, 3) fp32."""
    D, H, W = spatial
    sd, sh, sw = _steps(spatial)
    n = torch.arange(start, D * H * W if stop is None else stop, device=device)
    return torch.stack([(n // (H * W)).float() * sd - 1.0,
                        ((n // W) % H).float() * sh - 1.0,
                        (n % W).float() * sw - 1.0], dim=-1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _spline(theta, ctrl, points, dtype):
    """``solvers.tps_eval``'s formula, step by step, in ``dtype`` over chunks
    of points: (B, N, 3) -> (B, N, 3) in ``dtype``."""
    T = ctrl.shape[1]
    th, c = theta.to(dtype), ctrl.to(dtype)
    outs = []
    for s in range(0, points.shape[1], _BWD_CHUNK):
        p = points[:, s: s + _BWD_CHUNK].to(dtype)
        diff = c[:, :, None, :] - p[:, None]  # (B, T, n, 3)
        r = torch.sqrt((diff * diff).sum(-1) + solvers.EPS_DIST)
        u = r * r * torch.log(r + solvers.EPS_LOG)
        outs.append(torch.einsum("btn,btk->bnk", u, th[:, :T])
                    + th[:, T: T + 1] + p @ th[:, T + 1:])
    return torch.cat(outs, dim=1)


def _planes_plain(theta, ctrl, spatial, dtype=torch.float32):
    D, H, W = spatial
    B = theta.shape[0]
    pts = _grid_points(spatial, theta.device).expand(B, -1, 3)
    if dtype == torch.float32:
        moved = solvers.tps_eval_chunked_plain(theta, ctrl, pts)
    else:
        moved = _spline(theta, ctrl, pts, dtype)
    return moved.transpose(1, 2).reshape(B, 3, D, H, W)


def tps_planes_plain(theta: torch.Tensor, ctrl: torch.Tensor, spatial: Sequence[int],
                     dtype=torch.float32):
    """Plain PyTorch ``tps_planes``: the spline (``solvers.tps_eval_chunked_plain``)
    at the identity grid ``idx * (2/(S-1)) - 1`` (ij order), returned
    plane-major (B, 3, D, H, W) fp32. Differentiable, with
    :func:`tps_planes_bwd_plain` as its backward. With ``dtype`` float64 the
    same formula runs in double precision on the same fp32 grid and the
    result stays float64 (the reference a kernel's tolerance is stated
    against; differentiable by autograd itself)."""
    spatial = tuple(int(s) for s in spatial)
    if dtype != torch.float32:
        tps_planes_plain.calls += 1
        return _planes_plain(theta, ctrl, spatial, dtype)
    return _TpsPlanes.apply(theta, ctrl, spatial, True)


def tps_planes_bwd_plain(theta, ctrl, spatial, g, dtype=torch.float32):
    """Plain PyTorch backward of ``tps_planes`` in closed form, over chunks
    of grid points: (g_theta (B, T+4, 3), g_ctrl (B, T, 3)). ``dtype`` is the
    working precision (float64 gives the reference the kernel's tolerance is
    stated against)."""
    tps_planes_bwd_plain.calls += 1
    D, H, W = spatial
    N = D * H * W
    B, T = ctrl.shape[:2]
    c = ctrl.to(dtype)
    wgt = theta[:, :T].to(dtype)
    gf = g.reshape(B, 3, N).to(dtype)
    g_wgt = torch.zeros((B, T, 3), dtype=dtype, device=g.device)
    msum = torch.zeros((B, T), dtype=dtype, device=g.device)
    mpts = torch.zeros((B, T, 3), dtype=dtype, device=g.device)
    for s in range(0, N, _BWD_CHUNK):
        e = min(N, s + _BWD_CHUNK)
        pts = _grid_points(spatial, g.device, s, e).to(dtype)  # (n, 3)
        gc = gf[:, :, s:e]  # (B, 3, n)
        diff = c[:, :, None, :] - pts[None, None]  # (B, T, n, 3)
        r = torch.sqrt((diff * diff).sum(-1) + solvers.EPS_DIST)
        lg = torch.log(r + solvers.EPS_LOG)
        g_wgt += torch.einsum("bkn,btn->btk", gc, r * r * lg)
        m = torch.einsum("btk,bkn->btn", wgt, gc) * (lg + r / (2.0 * (r + solvers.EPS_LOG)))
        msum += m.sum(-1)
        mpts += torch.einsum("btn,nj->btj", m, pts)
    g_ctrl = 2.0 * (c * msum[..., None] - mpts)
    g_theta = torch.cat([g_wgt, _affine_rows(g.to(dtype), spatial)], dim=1)
    return g_theta.to(theta.dtype), g_ctrl.to(ctrl.dtype)


def _affine_rows(g, spatial):
    """Cotangent of theta's affine rows (B, 4, 3): [sum_n g_k; sum_n p_j g_k],
    from the three marginals of ``g`` (B, 3, D, H, W) against the separable
    identity grid."""
    axes = [a.to(g.dtype) for a in _axis_coords(spatial, g.device)]
    rows = [g.sum(dim=(2, 3, 4))]
    for j, keep in enumerate((2, 3, 4)):
        marg = g.sum(dim=tuple(d for d in (2, 3, 4) if d != keep))  # (B, 3, S_j)
        rows.append(torch.einsum("bks,s->bk", marg, axes[j]))
    return torch.stack(rows, dim=1)


def tps_flow_plain(theta, ctrl, points, dtype=torch.float32):
    """Plain PyTorch ``tps_flow``: ``solvers.tps_eval`` over chunks of points
    (with ``dtype`` float64: the same formula in double precision, returned
    as float64)."""
    tps_flow_plain.calls += 1
    if dtype != torch.float32:
        return _spline(theta, ctrl, points, dtype)
    return solvers.tps_eval_chunked_plain(theta, ctrl, points)


tps_planes_plain.calls = 0
tps_planes_bwd_plain.calls = 0
tps_flow_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_spline(name, theta, ctrl):
    B, T, d = ctrl.shape
    if d != 3 or theta.shape != (B, T + 4, 3):
        raise ValueError(f"{name}: theta {tuple(theta.shape)} / ctrl "
                         f"{tuple(ctrl.shape)} are not (B, T+4, 3) / (B, T, 3)")
    if theta.device != ctrl.device or theta.device.type != "cuda":
        raise ValueError(f"{name}: theta and ctrl must be on one CUDA device")
    if theta.dtype != torch.float32 or ctrl.dtype != torch.float32:
        raise TypeError(f"{name}: theta and ctrl must be float32")
    if not (theta.is_contiguous() and ctrl.is_contiguous()):
        raise ValueError(f"{name}: theta and ctrl must be contiguous")
    if T > _MAX_T or B > 65535:
        raise ValueError(f"{name}: T={T} > {_MAX_T} or B={B} > 65535")
    return B, T


def _planes_launch(theta, ctrl, spatial):
    D, H, W = spatial
    B, T = _check_spline("tps_planes", theta, ctrl)
    out = torch.empty((B, 3, D, H, W), dtype=torch.float32, device=theta.device)
    sd, sh, sw = _steps(spatial)
    err = _fn().km_tps_planes(theta.data_ptr(), ctrl.data_ptr(), out.data_ptr(),
                              B, T, D, H, W, sd, sh, sw,
                              _build.stream_ptr(theta.device))
    _build.check(err, "km_tps_planes")
    tps_planes.launches += 1
    return out


def tps_planes_bwd(theta, ctrl, spatial, g):
    """Backward of :func:`tps_planes`: cotangent ``g`` (B, 3, D, H, W) fp32 ->
    (g_theta (B, T+4, 3), g_ctrl (B, T, 3)). CPU tensors run
    :func:`tps_planes_bwd_plain`; CUDA tensors launch the kernel, which
    writes one row of partial sums per block, ``[g_theta's T+4 rows | 2 sum m
    (T) | -2 sum m p (T, 3)]``; the rows are added here in a second pass."""
    spatial = tuple(int(s) for s in spatial)
    if g.device.type == "cpu":
        return tps_planes_bwd_plain(theta, ctrl, spatial, g)
    D, H, W = spatial
    B, T = _check_spline("tps_planes_bwd", theta, ctrl)
    if g.device != theta.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (B, 3, D, H, W) or not g.is_contiguous():
        raise ValueError(f"tps_planes_bwd: g {tuple(g.shape)} {g.dtype} is not a "
                         f"contiguous float32 (B, 3, D, H, W) tensor on {theta.device}")
    lib = _fn()
    nblk = lib.km_tps_planes_bwd_blocks(D, H, W)
    part = torch.empty((B, nblk, 7 * T + _BWD_AFFINE), dtype=torch.float32, device=g.device)
    sd, sh, sw = _steps(spatial)
    err = lib.km_tps_planes_bwd(theta.data_ptr(), ctrl.data_ptr(), g.data_ptr(),
                                part.data_ptr(), B, T, D, H, W, sd, sh, sw,
                                _build.stream_ptr(g.device))
    _build.check(err, "km_tps_planes_bwd")
    tps_planes_bwd.launches += 1
    return _bwd_from_sums(part.sum(dim=1), ctrl)


def _bwd_from_sums(acc, ctrl):
    """(g_theta, g_ctrl) from the backward kernel's row of sums (B, 7T + 12):
    ``[g_theta (T+4, 3) | 2 sum m (T) | -2 sum m p (T, 3)]``, so that
    ``g_ctrl = ctrl * (2 sum m) + (-2 sum m p)``."""
    B, T = ctrl.shape[:2]
    n_theta = 3 * T + _BWD_AFFINE
    g_theta = acc[:, :n_theta].reshape(B, T + 4, 3)
    g_ctrl = torch.addcmul(acc[:, n_theta + T:].reshape(B, T, 3), ctrl,
                           acc[:, n_theta: n_theta + T, None])
    return g_theta, g_ctrl


tps_planes_bwd.launches = 0


class _TpsPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, ctrl, spatial, plain):
        ctx.spatial, ctx.plain = spatial, plain
        ctx.save_for_backward(theta, ctrl)
        if plain or theta.device.type == "cpu":
            tps_planes_plain.calls += 1
            return _planes_plain(theta, ctrl, spatial)
        return _planes_launch(theta, ctrl, spatial)

    @staticmethod
    def backward(ctx, g):
        theta, ctrl = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain or g.device.type == "cpu":
            g_theta, g_ctrl = tps_planes_bwd_plain(theta, ctrl, ctx.spatial, g)
        else:
            g_theta, g_ctrl = tps_planes_bwd(theta, ctrl, ctx.spatial, g)
        return g_theta, g_ctrl, None, None


def tps_planes(theta: torch.Tensor, ctrl: torch.Tensor, spatial: Sequence[int]):
    """``ij``-ordered flow planes (B, 3, D, H, W) of a fitted TPS at the
    identity grid: ``moveaxis(tps_eval(theta, ctrl, flat_norm_grid), -1, 1)``
    without a points tensor. Differentiable in ``theta`` and ``ctrl``.

    Args:
        theta: (B, T+4, 3) fp32 from :func:`solvers.fit_tps`.
        ctrl: (B, T, 3) fp32 control points the spline was fitted with.
        spatial: (D, H, W).

    CPU tensors run :func:`tps_planes_plain`; CUDA tensors launch the kernel.
    """
    return _TpsPlanes.apply(theta, ctrl, tuple(int(s) for s in spatial), False)


tps_planes.launches = 0


class _TpsFlow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, ctrl, points):
        ctx.save_for_backward(theta, ctrl, points)
        B, T = _check_spline("tps_flow", theta, ctrl)
        if points.device != theta.device or points.dtype != torch.float32 \
                or points.dim() != 3 or points.shape[0] != B or points.shape[2] != 3 \
                or not points.is_contiguous():
            raise ValueError(f"tps_flow: points {tuple(points.shape)} {points.dtype} is "
                             f"not a contiguous float32 (B, N, 3) tensor on {theta.device}")
        N = int(points.shape[1])
        out = torch.empty((B, N, 3), dtype=torch.float32, device=theta.device)
        err = _fn().km_tps_flow(theta.data_ptr(), ctrl.data_ptr(), points.data_ptr(),
                                out.data_ptr(), B, T, N, _build.stream_ptr(theta.device))
        _build.check(err, "km_tps_flow")
        tps_flow.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_(n) for t, n in
                 zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = solvers.tps_eval_chunked_plain(*saved)
        wanted = [t for t in saved if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in saved)


def tps_flow(theta: torch.Tensor, ctrl: torch.Tensor, points: torch.Tensor):
    """The fitted spline at given points: the contract of
    ``solvers.tps_eval``, (B, N, 3) fp32 -> (B, N, 3) fp32, any N.

    CPU tensors run :func:`tps_flow_plain`; CUDA tensors launch the kernel.
    The gradient is the autograd of the plain evaluation.
    """
    if theta.device.type == "cpu":
        return tps_flow_plain(theta, ctrl, points)
    return _TpsFlow.apply(theta, ctrl, points)


tps_flow.launches = 0


def _fn():
    lib = _build.library()
    f = lib.km_tps_planes
    if f.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, vp, i, i, i, i, i, fl, fl, fl, vp]
        f.restype = ctypes.c_int
        lib.km_tps_flow.argtypes = [vp, vp, vp, vp, i, i, ctypes.c_longlong, vp]
        lib.km_tps_flow.restype = ctypes.c_int
        lib.km_tps_planes_bwd_blocks.argtypes = [i, i, i]
        lib.km_tps_planes_bwd_blocks.restype = ctypes.c_int
        lib.km_tps_planes_bwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, fl, fl, fl, vp]
        lib.km_tps_planes_bwd.restype = ctypes.c_int
    return lib
