"""Entry points: one pairwise forward, and one dry run of every multi-device
path.

The port's counterpart of the repo's ``__graft_entry__.py``:

  * :func:`entry` returns ``(fn, example_args)``: ``fn(params, img_f,
    img_m) -> (warped, matrix, points_f, points_m)``, the flagship family's
    pairwise affine registration (an fp32 TruncatedUNet3D, out_channels 32,
    f_maps 16, 4 levels, 1 truncated layer, at 32^3), with ``params`` the
    net's ``state_dict`` (keymorph_tpu's flax parameters carried by
    ``tools/import_flax_params.py`` fit it);
  * :func:`dryrun_multichip` runs keymorph_tpu's dry-run sequence on
    ``n_devices`` ranks of the parallel layer at its tiny shapes: a sharded
    training step on a ('data', 'space' = 2) mesh, the sharded groupwise
    step, the fan-out warp, one registration split over 'space' = n, the
    ``KeyMorph`` TPS grids and ``groupwise_register(mesh=...)`` with the
    subjects over 'data', and, for an even n >= 4, a step on a ('dcn',
    'data', 'space') mesh. It prints keymorph_tpu's ``dryrun_multichip OK:
    ...`` line, with its labels.

    python -m keymorph_tpu_torch.entry [N]     # dryrun_multichip(N), N = 8 by default

Where the ranks run: with N cards visible, one NCCL rank per card; with
fewer, N gloo ranks dealt over the cards (one card: all on it); the CPU only
on request (``device="cpu"``, gloo), as the tests run it. The ranks are
processes of this module, started and joined by
``parallel.launch.spawn``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from keymorph_tpu_torch import disable_tf32, resolve_device

ROOT = Path(__file__).resolve().parents[1]
ENTRY_UNET = dict(out_channels=32, f_maps=16, num_levels=4, num_truncated_layers=1)
ENTRY_SIZE = (32, 32, 32)
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE = 600.0           # s, the whole world's run


def _build(device=None):
    """The flagship-representative net (fp32 ``ENTRY_UNET``, weights seeded
    0) and a zero image (1, 1, *ENTRY_SIZE)."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D, init_weights

    dev = resolve_device(device)
    backbone = init_weights(TruncatedUNet3D(**ENTRY_UNET), torch.Generator().manual_seed(0))
    net = KeyMorphNet(backbone, ENTRY_UNET["out_channels"]).to(dev).eval()
    return net, torch.zeros((1, 1, *ENTRY_SIZE), device=dev)


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(params, img_f, img_m)`` is the
    pairwise forward (keypoints -> affine fit and grid -> warp) of the net's
    module with ``params`` (a ``state_dict``) in place of its own;
    ``example_args`` are its parameters, a zero image and a ones image."""
    from keymorph_tpu_torch.models.keymorph import align_pair
    from keymorph_tpu_torch.ops.resample import align_img

    net, img = _build(device=device)
    if img.is_cuda:
        disable_tf32()  # the fp32 convs are full fp32

    def forward(params, img_f, img_m):
        points_f, points_m, _ = torch.func.functional_call(net, params, (img_f, img_m))
        out = align_pair(points_f, points_m, "affine", img_f.shape[2:], compute_grid=True)
        warped = align_img(out["grid"], img_m)
        return warped, out["matrix"], points_f, points_m

    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return forward, (params, img, torch.ones_like(img))


def _uniform(seed, shape):
    """Seeded uniform [0, 1) volumes, drawn on the CPU (alike on every rank)."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _dryrun_rank(n: int, device_type: str) -> dict:
    """One rank's dry run (every rank runs it; the collectives join them).
    Returns what rank 0 prints, and this rank's kernel launches."""
    from keymorph_tpu_torch.models.keymorph import KeyMorph, KeyMorphNet, align_pair
    from keymorph_tpu_torch.models.unet import UNet3D, init_weights
    from keymorph_tpu_torch.ops import cuda as kernels
    from keymorph_tpu_torch.ops.resample import align_img
    from keymorph_tpu_torch.parallel import (
        make_mesh,
        make_sharded_groupwise_fn,
        make_sharded_train_step,
        make_spatial_register_fn,
    )
    from keymorph_tpu_torch.parallel.mesh import gather_cat, local_rows
    from keymorph_tpu_torch.training.config import Config
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer

    kernels.reset_counters()
    space = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(space=space, device_type=device_type, timeout=GROUP_TIMEOUT)
    dev = mesh.device
    data = n // space
    config = Config(num_keypoints=16, transform_type="tps_1.0", loss_fn="mse",
                    max_train_keypoints=8, max_random_affine_augment_params=(0.1, 0.1, 0.5, 0.05),
                    batch_size=data)

    def make_net():
        backbone = UNet3D(out_channels=config.num_keypoints, f_maps=4, num_levels=2)
        return KeyMorphNet(init_weights(backbone, torch.Generator().manual_seed(0)),
                           config.num_keypoints).to(dev)

    size = (16, 16, 16)
    # random volumes: constant inputs collapse every keypoint to the center,
    # which makes the TPS system singular
    img, img_m = _uniform(42, (data, 1, *size)), _uniform(43, (data, 1, *size))
    net = make_net()
    step = make_sharded_train_step(net, config, mesh)
    state = TrainState.create(net, make_optimizer(config, net))
    state, metrics = step(state, torch.Generator().manual_seed(1), img, img_m, None, None, 1.0)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError("the sharded train step produced a non-finite loss")

    # groupwise: subjects over 'data', each iteration's mean an all_reduce
    gmesh = make_mesh(space=1, device_type=device_type, timeout=GROUP_TIMEOUT)
    group_imgs = _uniform(44, (n, 1, *size))
    _, aligned = make_sharded_groupwise_fn(net, config, gmesh, transform_type="affine")(
        group_imgs)

    # the eval fan-out warp: each rank warps its rows of the moving batch
    imgs_m = group_imgs.flip(0)
    with torch.no_grad():
        pf, pm, _ = net(group_imgs.to(dev), imgs_m.to(dev))
        grid = align_pair(pf, pm, "affine", size, compute_grid=True)["grid"]
        rows = local_rows(gmesh, n)
        warped = gather_cat(align_img(grid[rows], imgs_m[rows].to(dev)), gmesh.data_group)
    if tuple(warped.shape) != tuple(group_imgs.shape):
        raise AssertionError(f"fan-out warp {tuple(warped.shape)}, want {tuple(group_imgs.shape)}")

    # one registration split over 'space' = n
    smesh = make_mesh(data=1, space=n, device_type=device_type, timeout=GROUP_TIMEOUT)
    img_a, sgrid, _, _ = make_spatial_register_fn(net, config, smesh, transform_type="tps_1.0")(
        img[:1], img_m[:1])
    if tuple(img_a.shape) != tuple(img[:1].shape) or tuple(sgrid.shape) != (1, *size, 3):
        raise AssertionError(f"spatial register {tuple(img_a.shape)}, {tuple(sgrid.shape)}")
    if not bool(torch.isfinite(img_a).all()):
        raise FloatingPointError("the spatial register produced a non-finite image")

    # KeyMorph's TPS grids with the subjects over 'data', and groupwise under the mesh
    esize = (16, 16, 8)
    km = KeyMorph(UNet3D(out_channels=8, f_maps=4, num_levels=2), 8, num_subgrids=2,
                  device=dev)
    init_weights(km.net, torch.Generator().manual_seed(2))
    km.eval()
    eimg = _uniform(45, (n, 1, *esize))
    rows = local_rows(gmesh, n)
    res = km(eimg[rows], eimg.flip(2)[rows], transform_type="tps_1")
    egrid = gather_cat(res["tps_1"]["grid"], gmesh.data_group)
    if tuple(egrid.shape) != (n, *esize, 3) or not bool(torch.isfinite(egrid).all()):
        raise AssertionError(f"mesh TPS grids {tuple(egrid.shape)} not finite (n, {esize}, 3)")
    gw = km.groupwise_register(eimg.numpy(), transform_type="tps_1", num_iters=2, mesh=gmesh,
                               kp_batch=n, grid_batch=n)["tps_1"]
    if not bool(torch.isfinite(torch.as_tensor(gw["groupgrids"])).all()):
        raise FloatingPointError("groupwise_register under the mesh produced non-finite grids")

    # the two-level ('dcn', 'data', 'space') mesh: the gradient all-reduce
    # spans a second (simulated) host
    dcn_loss = None
    if n % 2 == 0 and n >= 4:
        dmesh = make_mesh(dcn=2, space=space, device_type=device_type, timeout=GROUP_TIMEOUT)
        dbatch = dmesh.data_size
        dnet = make_net()
        dstep = make_sharded_train_step(dnet, config, dmesh)
        dstate = TrainState.create(dnet, make_optimizer(config, dnet))
        _, dmetrics = dstep(dstate, torch.Generator().manual_seed(3),
                            _uniform(46, (dbatch, 1, *size)), _uniform(47, (dbatch, 1, *size)),
                            None, None, 1.0)
        dcn_loss = float(dmetrics["loss"])
        if not np.isfinite(dcn_loss):
            raise FloatingPointError("the dcn-mesh train step produced a non-finite loss")

    return {"data": data, "space": space, "loss": loss, "groupwise": list(aligned.shape),
            "fanout": list(warped.shape), "spatial": list(img_a.shape),
            "tps_grid": list(egrid.shape), "dcn_loss": dcn_loss,
            "launches": {k: c["launches"] for k, c in kernels.counters().items()},
            "plain_calls": {k: c["plain_calls"] for k, c in kernels.counters().items()}}


def _ok_line(n: int, r: dict) -> str:
    """keymorph_tpu's ``dryrun_multichip OK: ...`` line of rank 0's result."""
    return (f"dryrun_multichip OK: mesh=(data={r['data']}, space={r['space']}), "
            f"loss={r['loss']:.5f}, groupwise points {tuple(r['groupwise'])}, "
            f"fanout warp {tuple(r['fanout'])}, spatial register {tuple(r['spatial'])} "
            f"over space={n}, gspmd-gated TPS grid {tuple(r['tps_grid'])}, "
            f"dcn-mesh loss={r['dcn_loss']}")


def _placement(n_devices: int, device=None):
    """(backend, device type) of the ranks: NCCL with a card per rank where
    ``n_devices`` cards are visible, else gloo (the ranks dealt over the
    cards); gloo on the CPU for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", "cpu"
    if dev.type != "cuda":
        raise ValueError(f"dryrun_multichip runs on CUDA cards or the CPU, not {dev}")
    return ("nccl" if torch.cuda.device_count() >= n_devices else "gloo"), "cuda"


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the dry run on ``n_devices`` ranks (module docstring), print rank
    0's line and return every rank's result (rank order), each with its
    kernel launches. Raises when a rank fails."""
    backend, device_type = _placement(n_devices, device)
    if device_type == "cuda":
        from keymorph_tpu_torch import _build

        _build.library()  # built once here, loaded by every rank
    from keymorph_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        work = Path(tmp)
        threads = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"} if device_type == "cpu" else {}
        argvs = [[sys.executable, "-m", "keymorph_tpu_torch.entry", str(n_devices), "--rank",
                  str(r), "--dir", str(work), "--backend", backend, "--device", device_type]
                 for r in range(n_devices)]
        launch.spawn(argvs, work, DEADLINE, cwd=ROOT,
                     env=launch.rank_env(threads, pythonpath=ROOT))
        results = [json.loads((work / f"result_{r}.json").read_text()) for r in range(n_devices)]
    print(_ok_line(n_devices, results[0]))
    return results


def _rank_main(args):
    import torch.distributed as dist

    from keymorph_tpu_torch.parallel import launch

    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        disable_tf32()  # the fp32 convs are full fp32
    os.environ["LOCAL_RANK"] = str(args.rank)  # make_mesh's card: LOCAL_RANK mod the cards
    dist.init_process_group(args.backend, init_method=launch.store_url(args.dir),
                            rank=args.rank, world_size=args.n, timeout=GROUP_TIMEOUT)
    try:
        result = _dryrun_rank(args.n, args.device)
    finally:
        dist.destroy_process_group()
    (Path(args.dir) / f"result_{args.rank}.json").write_text(json.dumps(result))


def main(argv=None):
    ap = argparse.ArgumentParser(description="dryrun_multichip(N) on N ranks")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA cards (default)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
    else:
        dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
