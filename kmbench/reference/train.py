"""The training step: augment the moving volume, extract both keypoint
sets, keep a subset of the keypoints, fit the TPS of the fixed onto the
moving subset at the step's lambda, warp the augmented moving volume by its
flow, take the MSE against the fixed volume, and update every parameter by
Adam (betas 0.9 and 0.999, eps 1e-8, no weight decay). Gradients are taken
by autograd in float32.

A step can follow another implementation's keypoints (``forced``): the fit,
flow, warp and loss take that implementation's keypoints, and the gradient
flows back through this extractor at its own keypoints. That judges the
geometry, the loss, the backward and the update on what the other side
handed on, and leaves the extraction to be judged by the keypoints alone.
"""

from __future__ import annotations

import torch

from kmbench.reference import geometry, unet
from kmbench.reference.precision import Precision


def loss(params, img_f, img_m, draw, num_levels, num_truncated, prec: Precision, forced=None):
    """(the step's MSE, its own keypoints (points_f, points_m)) for one pair
    and one row of draws (``lmbda``, ``keypoint_idx``, ``scale``,
    ``offset``, ``theta``, ``shear``); with ``forced`` (points_f,
    points_m) the loss takes those keypoints' values."""
    with torch.no_grad():
        img_m = geometry.augment(img_m, draw["scale"][None], draw["offset"][None],
                                 draw["theta"][None], draw["shear"][None], prec)
    pf = unet.keypoints(params, img_f, num_levels, num_truncated, prec)
    pm = unet.keypoints(params, img_m, num_levels, num_truncated, prec)
    own = (pf.detach(), pm.detach())
    if forced is not None:
        pf = pf + (forced[0].to(pf) - pf).detach()
        pm = pm + (forced[1].to(pm) - pm).detach()
    idx = draw["keypoint_idx"]
    pf, pm = pf[:, idx], pm[:, idx]
    theta = geometry.fit_tps(pf, pm, draw["lmbda"].reshape(1), prec)
    planes = geometry.tps_planes(theta, pf, img_f.shape[2:], prec)
    return mse(img_f, geometry.warp(img_m, planes, prec)), own


def mse(a, b):
    return torch.mean((a - b) ** 2)


def run(weights, pairs, draws, lr, steps, num_levels, num_truncated, prec: Precision,
        forced=None):
    """``steps`` Adam steps from ``weights`` ({name: tensor}) on ``pairs``
    [(img_f, img_m)] with ``draws`` (one row a step), each following
    ``forced[t]`` where given. Returns (losses, the first step's gradient
    {name: tensor}, the parameters after the last step {name: tensor}, the
    keypoints each step extracted [(points_f, points_m)])."""
    names = list(weights)
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first, points = [], None, []
    for t in range(1, steps + 1):
        img_f, img_m = pairs[t - 1]
        draw = {k: d[t - 1] for k, d in draws.items()}
        value, own = loss(params, img_f, img_m, draw, num_levels, num_truncated, prec,
                          None if forced is None else forced[t - 1])
        grads = torch.autograd.grad(value, [params[k] for k in names])
        losses.append(float(value.detach()))
        points.append(own)
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                params[k] -= lr * m_hat / (v_hat.sqrt() + eps)
        del value, grads
    return losses, first, {k: p.detach() for k, p in params.items()}, points
