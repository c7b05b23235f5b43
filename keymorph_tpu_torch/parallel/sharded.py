"""Sharded (multi-device) training, registration and groupwise steps.

Port of ``keymorph_tpu/parallel/sharded.py`` on ``torch.distributed``, SPMD:
every rank of a :class:`~keymorph_tpu_torch.parallel.mesh.Mesh` calls the
same factory and the same function with the same full host batch, keeps
its own rows (the data-parallel axes, 'dcn' x 'data') and, where the
volume is split, its own slab of Z planes ('space'), and runs the port's
kernels on them:

  * data parallelism: each rank extracts keypoints, fits and warps its own
    rows; the training gradients are all-reduced over the whole mesh;
  * the 'space' axis: the dense flow and the warp of a rank cover its Z
    slab only (the warp kernel takes planes of any extent apart from the
    source volume, which stays whole on every rank);
  * groupwise: each iteration's mean keypoints are an all_reduce over the
    data-parallel axes.

Where a keymorph_tpu caller receives one logical array (the factories'
return values), every rank gets it whole: the port all-gathers it. The
random draws of a training step are made for the whole batch from one
``torch.Generator`` seeded alike on every rank, and each rank keeps its
rows, so the sharded step equals ``training.train.make_train_step`` on the
whole batch with the same generator state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from keymorph_tpu_torch import augment
from keymorph_tpu_torch.models.keymorph import (
    align_pair,
    parse_transform_type,
    sample_tps_lmbda,
    subsample_keypoints,
)
from keymorph_tpu_torch.ops import coords
from keymorph_tpu_torch.ops.cuda import resample3d
from keymorph_tpu_torch.ops.resample import align_img, grid_to_planes
from keymorph_tpu_torch.parallel import halo
from keymorph_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    gather_cat,
    local_rows,
    require_mesh,
    split_sizes,
)
from keymorph_tpu_torch.training.config import Config
from keymorph_tpu_torch.training.train import TrainState, _global_norm
from keymorph_tpu_torch.transforms import solvers
from keymorph_tpu_torch.transforms.affine import affine_flow


def _numeric_lmbda(align_type, lmbda_spec, what):
    if align_type == "tps" and not isinstance(lmbda_spec, (int, float)):
        raise ValueError(
            f"{what} needs a numeric TPS lambda (got tps_{lmbda_spec}); distributional "
            "lambdas are a training-time feature: pass e.g. transform_type='tps_1' for "
            "inference")


def _slab(mesh: Mesh, sizes):
    """This rank's [z0, z1) of Z slabs of ``sizes``."""
    z0 = sum(sizes[:mesh.space_index])
    return z0, z0 + sizes[mesh.space_index]


def _make_sharded_extract(net: nn.Module, mesh: Mesh, method: Optional[str] = None):
    """Keypoint extraction of this rank's rows: each rank runs the net (on
    the card the conv kernels of the executor) on its own shard, as
    keymorph_tpu's ``shard_map`` makes each device run its kernels locally.
    Returns ``fn(img_f, img_m) -> (points_f, points_m, weights or None)``,
    or with ``method`` (a name such as "get_keypoints") ``fn(img) -> the
    method's result``; inputs and outputs are this rank's rows."""
    require_mesh(mesh)
    if method is None:
        return net
    return getattr(net, method)


def _grid_slab(points_f, points_m, align_type, spatial, z0, z1, lmbda=None, weights=None):
    """The ``xy`` sampling grid (B, z1 - z0, *spatial[1:], d) of planes (or
    a 2D image's rows) [z0, z1) of the fixed volume:
    ``align_pair(compute_grid=True)``'s grid evaluated at that slab's points
    alone (in 3D the TPS flow's points mode on the card)."""
    B = points_f.shape[0]
    d, plane = len(spatial), math.prod(spatial[1:])
    pf, pm = points_f.float(), points_m.float()
    pts = coords.flat_norm_grid(spatial, device=pf.device)[:, z0 * plane: z1 * plane]
    pts = pts.expand(B, -1, d)
    if align_type in ("affine", "rigid"):
        fit = solvers.fit_affine if align_type == "affine" else solvers.fit_rigid
        moved = coords.apply_matrix(solvers.square_matrix(fit(pf, pm, weights)), pts)
    else:
        theta = solvers.fit_tps(pf, pm, lmbda, weights)
        moved = solvers.tps_eval_chunked(theta, pf, pts)
    return torch.flip(moved.reshape(B, z1 - z0, *spatial[1:], d), dims=(-1,))


class _SumOverGroup(torch.autograd.Function):
    """The sum of a tensor over a group, with the identity as its backward:
    every rank then back-propagates the same cotangent into its own part,
    and the gradient all-reduce adds the parts."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_grads(net: nn.Module, mesh: Mesh):
    """Sum every parameter's gradient over the whole mesh, in one
    collective."""
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    if not grads or mesh.size == 1:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.world_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def make_sharded_train_step(net: nn.Module, config: Config, mesh: Mesh):
    """The multi-device training step: the batch over the data-parallel
    axes, the augmentation warp and the loss warp over 'space' slabs along
    Z.

    Returned signature (every rank calls it with the same whole batch)::

        step(state, generator, img_f, img_m, seg_f, seg_m, aug_scale, *,
             lmbda=None, keypoint_idx=None, aug_params=None) -> (state, metrics)

    as ``training.train.make_train_step``'s, whose step on the whole batch
    with the same generator state it equals up to the order of fp32 sums:
    the augmentation parameters, the TPS lambdas and the keypoint subset
    are drawn for the whole batch and each rank keeps its rows. Each rank of
    a space group warps its slab of the planes from its rows' whole volume
    (the augmented volume is all-gathered over 'space' before extraction);
    TPS forms the whole planes with ``tps_planes`` and slices the slab, so
    its backward sees a zero cotangent outside it. Each rank's loss covers
    its rows and slab, normalized by the whole batch and volume (Dice: its
    sums are summed over 'space' first), so its backward is local; then the
    gradients are all-reduced over the mesh, and the replicated Adam update
    runs on every rank. ``metrics`` (``loss``, ``mse`` or
    ``softdice``/``softdiceloss``, ``grad_norm``) are the whole step's, the
    same on every rank. The Z extent must divide by 'space', and the batch
    by the data-parallel size. keymorph_tpu's sharded step has no real-world
    mode, and neither has this one.
    """
    require_mesh(mesh)
    if config.align_keypoints_in_real_world_coords:
        raise ValueError("the sharded step has no real-world mode (nor has keymorph_tpu's): "
                         "train real-world registration with training.train.make_train_step")
    align_type, lmbda_spec = parse_transform_type(config.transform_type)
    use_dice = config.loss_fn == "dice"
    max_params = tuple(config.max_random_affine_augment_params)

    def aug_warp(img, flow, z0, z1, mode):
        out = resample3d.warp_planes(img, grid_to_planes(flow[:, z0:z1]), mode)
        return gather_cat(out, mesh.space_group, dim=2)

    def loss_fn(generator, img_f, img_m, seg_f, seg_m, aug_scale, lmbda, keypoint_idx,
                aug_params):
        B = img_f.shape[0]
        C_total = B * img_f[0].numel()
        rows = local_rows(mesh, B)
        D = img_f.shape[2]
        if D % mesh.space_size:
            raise ValueError(f"the sharded step splits Z ({D}) over 'space' "
                             f"({mesh.space_size}) evenly")
        z0, z1 = _slab(mesh, [D // mesh.space_size] * mesh.space_size)
        dev = mesh.device
        img_f, img_m = img_f[rows].to(dev), img_m[rows].to(dev)
        if use_dice:
            seg_f, seg_m = seg_f[rows].to(dev), seg_m[rows].to(dev)
        if aug_params is not None or any(p > 0 for p in max_params):
            with torch.no_grad():
                if aug_params is None:
                    aug_params = augment.sample_affine_params(generator, B, 3, max_params,
                                                              aug_scale, device=dev)
                params = tuple(torch.as_tensor(p).to(dev)[rows] for p in aug_params)
                M = augment.build_affine_matrix(params, 3)
                flow = affine_flow(torch.linalg.inv(M.float()), img_m.shape[2:])
                img_m = aug_warp(img_m, flow, z0, z1, "bilinear")
                if use_dice:
                    seg_m = aug_warp(seg_m, flow, z0, z1, "nearest")

        points_f, points_m, weights = net(img_f, img_m)
        if align_type == "tps":
            if lmbda is None:
                lmbda = sample_tps_lmbda(generator, B, lmbda_spec, config.max_train_tps_lmbda,
                                         device=dev)
            lmbda = torch.as_tensor(lmbda, dtype=torch.float32).to(dev)[rows]
            if config.max_train_keypoints and config.num_keypoints > config.max_train_keypoints:
                points_f, points_m, weights = subsample_keypoints(
                    generator, points_f, points_m, weights, config.max_train_keypoints,
                    idx=keypoint_idx)
            planes = align_pair(points_f, points_m, "tps", img_f.shape[2:], lmbda=lmbda,
                                weights=weights, compute_grid="planes")["planes"]
            planes = planes[:, :, z0:z1].contiguous()
        else:
            grid = align_pair(points_f, points_m, align_type, img_f.shape[2:],
                              weights=weights, compute_grid=True)["grid"]
            planes = grid_to_planes(grid[:, z0:z1])
        fixed = (seg_f if use_dice else img_f)[:, :, z0:z1]
        warped = resample3d.warp_planes(seg_m if use_dice else img_m, planes)
        if use_dice:
            p, t = warped.flatten(2).float(), fixed.flatten(2).float()
            sums = torch.stack([(p * t).sum(2), (p * p).sum(2), (t * t).sum(2)])
            s_pt, s_pp, s_tt = _SumOverGroup.apply(sums, mesh.space_group)
            dice = 1.0 - (2.0 * s_pt + 1.0) / (s_pp + s_tt + 1.0)
            loss = dice.sum() / (B * dice.shape[1])
            # the space ranks of a row block hold the same value
            total = all_reduce(loss.detach().clone(), mesh.data_group)
            return loss, {"softdiceloss": total, "softdice": 1.0 - total, "loss": total}
        loss = ((fixed.float() - warped.float()) ** 2).sum() / C_total
        total = all_reduce(loss.detach().clone(), mesh.world_group)
        return loss, {"mse": total, "loss": total}

    def step(state: TrainState, generator, img_f, img_m, seg_f, seg_m, aug_scale, *,
             lmbda=None, keypoint_idx=None, aug_params=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(generator, img_f, img_m, seg_f, seg_m, float(aug_scale),
                                lmbda, keypoint_idx, aug_params)
        loss.backward()
        _all_reduce_grads(net, mesh)
        metrics["grad_norm"] = _global_norm(net.parameters())
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_sharded_register_fn(net: nn.Module, config: Config, mesh: Mesh,
                             transform_type: Optional[str] = None):
    """Batched pairwise registration with the pairs over the data-parallel
    axes and each grid's Z planes over 'space': the eval fan-out. Returns
    ``fn(img_f, img_m) -> (grid, points_f, points_m)``, every array whole on
    every rank (the caller passes the whole batch on every rank; the pair
    count must divide by the data-parallel size). Normalized coordinates,
    as keymorph_tpu's."""
    require_mesh(mesh)
    align_type, lmbda_spec = parse_transform_type(transform_type or config.transform_type)
    _numeric_lmbda(align_type, lmbda_spec, "sharded register")
    extract = _make_sharded_extract(net, mesh)

    @torch.no_grad()
    def fn(img_f, img_m):
        rows = local_rows(mesh, img_f.shape[0])
        img_f, img_m = img_f[rows].to(mesh.device), img_m[rows].to(mesh.device)
        points_f, points_m, weights = extract(img_f, img_m)
        spatial = tuple(img_f.shape[2:])
        sizes = split_sizes(spatial[0], mesh.space_size)
        lmbda = (torch.full((img_f.shape[0],), float(lmbda_spec), device=mesh.device)
                 if align_type == "tps" else None)
        grid = _grid_slab(points_f, points_m, align_type, spatial, *_slab(mesh, sizes),
                          lmbda=lmbda, weights=weights)
        grid = gather_cat(grid, mesh.space_group, 1, sizes)
        return (gather_cat(grid, mesh.data_group), gather_cat(points_f, mesh.data_group),
                gather_cat(points_m, mesh.data_group))

    return fn


def make_spatial_register_fn(net: nn.Module, config: Config, mesh: Mesh,
                             transform_type: Optional[str] = None):
    """ONE registration with the volumes split over 'space' along Z: the
    single-pair latency path, beside :func:`make_sharded_register_fn`'s
    pair throughput.

    * Extraction runs the backbone's and the head's module path on each
      rank's Z slab (``parallel/halo.py``), for every 3D backbone (the
      U-Nets in any block family and layer order, the ConvNet), both
      keypoint heads and both keypoint weightings: each 3^3 conv receives
      one plane from each Z neighbour (zeros at the volume's true faces),
      the norms', the squeeze-and-excitation gate's, the linear head's and
      the weightings' sums are all-reduced over 'space', and the centre of
      mass all-reduces its marginal sums, each at its global Z offset. Slab
      boundaries fall on multiples of the backbone's block (2^(num_levels
      - 1), or 16 for the ConvNet) and the far slab takes the remainder, so
      pools and crops act as in the unsplit module; a rank left without
      planes joins every collective with empty tensors. keymorph_tpu runs
      its flax path here (``fast_extract=False``) and lets GSPMD insert the
      same exchanges.
    * The fit is replicated (with the keypoint weights, as keymorph_tpu's
      ``align_pair`` takes them); the flow (the TPS flow's points mode, or
      the affine grid) and the warp run on the rank's equal D / 'space'
      slab, from the whole moving volume, as keymorph_tpu's ``shard_map``
      warp does.

    Returns ``fn(img_f, img_m) -> (img_a, grid, points_f, points_m)``, each
    whole on every rank (every rank passes the whole volumes). A 2D net's
    images (B, 1, H, W) split along H, their first spatial axis, as
    keymorph_tpu's split them. The split extent must divide by 'space'
    (keymorph_tpu's warp splits it evenly).
    """
    require_mesh(mesh)
    align_type, lmbda_spec = parse_transform_type(transform_type or config.transform_type)
    _numeric_lmbda(align_type, lmbda_spec, "spatial register")
    block = halo.block(net)

    @torch.no_grad()
    def fn(img_f, img_m):
        spatial = tuple(img_f.shape[2:])
        D = spatial[0]
        if D % mesh.space_size:
            raise ValueError(f"the spatial path splits Z ({D}) over 'space' "
                             f"({mesh.space_size}) evenly, as keymorph_tpu's warp does")
        dev = mesh.device
        group = mesh.space_group
        slabs = halo.Slabs(D, block, group)
        z0, z1 = slabs.local(0)
        points_f, points_m, weights = halo.pair(net, img_f[:, :, z0:z1].to(dev),
                                                img_m[:, :, z0:z1].to(dev), slabs)
        lmbda = (torch.full((img_f.shape[0],), float(lmbda_spec), device=dev)
                 if align_type == "tps" else None)
        w0, w1 = _slab(mesh, [D // mesh.space_size] * mesh.space_size)
        grid = _grid_slab(points_f, points_m, align_type, spatial, w0, w1, lmbda=lmbda,
                          weights=weights)
        img_a = align_img(grid, img_m.to(dev))
        return gather_cat(img_a, group, 2), gather_cat(grid, group, 1), points_f, points_m

    return fn


def make_sharded_groupwise_fn(net: nn.Module, config: Config, mesh: Mesh,
                              transform_type: str = "affine", num_iters: int = 5):
    """Groupwise mean-keypoint iteration with the subjects over the
    data-parallel axes: each rank extracts and aligns its own subjects, and
    each iteration's mean is an all_reduce over those axes. Returns
    ``fn(imgs (N, 1, *S)) -> (group_points, aligned_points)``, both whole on
    every rank (N must divide by the data-parallel size)."""
    require_mesh(mesh)
    align_type, lmbda_spec = parse_transform_type(transform_type)
    _numeric_lmbda(align_type, lmbda_spec, "sharded groupwise")
    extract = _make_sharded_extract(net, mesh, "get_keypoints")

    @torch.no_grad()
    def fn(imgs):
        n = imgs.shape[0]
        points = extract(imgs[local_rows(mesh, n)].to(mesh.device))
        lmbda = (torch.full((points.shape[0],), float(lmbda_spec), device=mesh.device)
                 if align_type == "tps" else None)
        curr = points
        for _ in range(num_iters):
            mean = all_reduce(curr.sum(dim=0, keepdim=True), mesh.data_group) / n
            curr = align_pair(mean.expand_as(curr), curr, align_type, (), lmbda=lmbda,
                              compute_grid=False, compute_aligned_points=True)["points_a"]
        return gather_cat(points, mesh.data_group), gather_cat(curr, mesh.data_group)

    return fn
