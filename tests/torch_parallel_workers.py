"""Worker processes of the port's multi-process tests
(``tests/test_torch_parallel*.py``). Jax-free: each worker imports torch and
the port only.

``run(job, world, tmp_path, **spec)`` starts ``world`` processes of this
file (``python tests/torch_parallel_workers.py JOB RANK WORLD DIR``), each
on one thread, joined by a gloo group that meets through a ``FileStore``
under ``DIR`` (no TCP port, so parallel test workers cannot collide), with
a 60-s timeout on every group. Each runs ``JOBS[job](spec, rank)`` and saves
its result to ``DIR/result_RANK.pt``. The parent waits with a deadline
(``keymorph_tpu_torch.parallel.launch.spawn``: every survivor killed when one
fails or the deadline passes, the failures' output raised) and returns the
results in rank order.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from keymorph_tpu_torch.parallel import launch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = datetime.timedelta(seconds=60)
K = 8
UNET = dict(out_channels=K, f_maps=4, num_levels=2)  # tests/test_sharded_eval.py:19-27


def run(job: str, world: int, tmp_path, deadline: float = 120.0, **spec):
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = launch.rank_env({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}, pythonpath=ROOT)
    launch.spawn([[sys.executable, __file__, job, str(r), str(world), str(tmp)]
                  for r in range(world)], tmp, deadline, env=env, cwd=ROOT)
    return [torch.load(tmp / f"result_{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# inputs shared by the parent and the workers
# ---------------------------------------------------------------------------


def volumes(seed: int, n: int, spatial=(12, 12, 12)) -> np.ndarray:
    """n seeded normal volumes (n, 1, *spatial), fp32 (the JAX tests' inputs)."""
    return np.random.default_rng(seed).normal(size=(n, 1, *spatial)).astype(np.float32)


def blobs(seed: int, n: int, spatial) -> np.ndarray:
    """n smooth blob volumes with a little noise, (n, 1, *spatial)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in spatial], indexing="ij")
    out = []
    for _ in range(n):
        c = rng.uniform(-0.3, 0.3, 3)
        v = np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 0.3)
        out.append(v + 0.05 * rng.random(v.shape))
    return np.stack(out)[:, None].astype(np.float32)


def make_net(weights_path):
    """The tests' KeyMorphNet: UNet3D(out_channels=8, f_maps=4, num_levels=2),
    fp32, with the weights saved at ``weights_path``."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import UNet3D

    net = KeyMorphNet(UNet3D(**UNET), K)
    net.load_state_dict(torch.load(weights_path, weights_only=True))
    return net


BACKBONES = ("UNet3D", "UNet2D", "TruncatedUNet3D", "ResidualUNet3D", "ResidualUNetSE3D",
             "ConvNet")


def build_net(spec):
    """A KeyMorphNet from a JSON spec: ``backbone`` (a name of BACKBONES),
    its keyword arguments ``kw``, ``weight_keypoints``, ``keypoint_layer``,
    the keypoints' ``dim`` (3 unless given), the ``weights`` path of its
    state_dict (fp32) and ``float64`` (a float64 net, the oracle's dtype)."""
    from keymorph_tpu_torch.models import convnet, unet
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet

    assert spec["backbone"] in BACKBONES
    module = convnet if spec["backbone"] == "ConvNet" else unet
    kw = dict(spec["kw"], dtype=torch.float64) if spec.get("float64") else spec["kw"]
    backbone = getattr(module, spec["backbone"])(**kw)
    net = KeyMorphNet(backbone, K, spec.get("weight_keypoints"),
                      spec.get("keypoint_layer", "com"), spec.get("dim", 3))
    net.load_state_dict(torch.load(spec["weights"], weights_only=True))
    return (net.double() if spec.get("float64") else net).eval()


def _to_torch(x):
    return None if x is None else torch.as_tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# jobs: each returns what the parent holds against its references
# ---------------------------------------------------------------------------


def job_mesh(spec, rank):
    from keymorph_tpu_torch.parallel import mesh as pm

    out = {}
    for name, kw in spec["meshes"].items():
        m = pm.make_mesh(device_type="cpu", timeout=TIMEOUT, **kw)
        rows = pm.shard_batch(m, {"x": np.arange(8 * 2).reshape(8, 2), "none": None})
        out[name] = {
            "axis_names": m.axis_names, "shape": m.shape, "coordinate":
                m.device_mesh.get_coordinate(), "data_index": m.data_index,
            "space_index": m.space_index, "rows": rows["x"].tolist(), "none": rows["none"],
            "data_sum": float(pm.all_reduce(torch.tensor([float(rank)]), m.data_group)),
            "space_sum": float(pm.all_reduce(torch.tensor([float(rank)]), m.space_group)),
            "gather": pm.gather_cat(torch.full((1 + m.space_index, 2), float(rank)),
                                    m.space_group, 0,
                                    [1 + i for i in range(m.space_size)]).tolist(),
            "json": pm.gather_json({"rank": rank, "x": [rank / 3]}, m.world_group, m.device),
        }
    errors = {}
    for name, kw in spec["bad"].items():
        try:
            pm.make_mesh(device_type="cpu", timeout=TIMEOUT, **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _train_config(spec):
    from keymorph_tpu_torch.training.config import Config

    kw = dict(spec["config"])
    kw["max_random_affine_augment_params"] = tuple(kw["max_random_affine_augment_params"])
    return Config(**kw)


def job_train(spec, rank):
    """One sharded step per case of ``spec["cases"]``: mesh sizes, the
    injected augmentation parameters (keymorph_tpu's draws) or a generator
    seed; with ``skip_reduce`` the gradient all-reduce is taken out (the
    negative control)."""
    from keymorph_tpu_torch.parallel import make_mesh, sharded
    from keymorph_tpu_torch.training.train import TrainState, make_optimizer

    out = []
    for case in spec["cases"]:
        mesh = make_mesh(device_type="cpu", timeout=TIMEOUT, **case["mesh"])
        if case.get("skip_reduce"):
            sharded._all_reduce_grads = lambda net, mesh: None
        config = _train_config(case)
        net = make_net(spec["weights"])
        state = TrainState.create(net, make_optimizer(config, net))
        step = sharded.make_sharded_train_step(net, config, mesh)
        data = np.load(case["data"])
        seg = {k: _to_torch(data[k]) if k in data else None for k in ("seg_f", "seg_m")}
        gen = torch.Generator().manual_seed(case.get("seed", 0))
        inject = {}
        if "aug_params" in data:
            inject["aug_params"] = tuple(_to_torch(data[f"aug_params_{i}"]) for i in range(4))
        state, metrics = step(state, gen, _to_torch(data["img_f"]), _to_torch(data["img_m"]),
                              seg["seg_f"], seg["seg_m"], case.get("aug_scale", 1.0), **inject)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {k: p.grad.clone() for k, p in net.named_parameters()
                              if p.grad is not None},
                    "params": {k: p.detach().clone() for k, p in net.named_parameters()},
                    "generator": gen.get_state()})
    return out


def job_register(spec, rank):
    from keymorph_tpu_torch.parallel import (
        make_mesh,
        make_sharded_groupwise_fn,
        make_sharded_register_fn,
        make_spatial_register_fn,
    )
    from keymorph_tpu_torch.training.config import Config

    out = {}
    for case in spec["cases"]:
        mesh = make_mesh(device_type="cpu", timeout=TIMEOUT, **case["mesh"])
        net = make_net(spec["weights"]).eval()
        config = Config(num_keypoints=K, transform_type=case["transform_type"])
        data = np.load(case["data"])
        f, m = torch.as_tensor(data["img_f"]), torch.as_tensor(data["img_m"])
        if case["kind"] == "register":
            res = make_sharded_register_fn(net, config, mesh)(f, m)
        elif case["kind"] == "spatial":
            res = make_spatial_register_fn(net, config, mesh)(f, m)
        else:
            res = make_sharded_groupwise_fn(net, config, mesh, case["transform_type"],
                                            case["num_iters"])(f)
        out[case["name"]] = [r.clone() for r in res]
    return out


def job_spatial(spec, rank):
    """``make_spatial_register_fn`` per case of ``spec["cases"]``: a net
    (``build_net``), a mesh, a transform and the pair of an .npz. Returns
    per case (img_a, grid, points_f, points_m, the keypoint weights or
    None)."""
    from keymorph_tpu_torch.parallel import make_mesh, make_spatial_register_fn
    from keymorph_tpu_torch.training.config import Config

    from keymorph_tpu_torch.parallel import halo

    out = {}
    for case in spec["cases"]:
        mesh = make_mesh(device_type="cpu", timeout=TIMEOUT, **case["mesh"])
        data = np.load(case["data"])
        net = build_net(case["net"])
        fn = make_spatial_register_fn(net, Config(num_keypoints=K,
                                                  transform_type=case["transform_type"]), mesh)
        f, m = torch.as_tensor(data["img_f"]), torch.as_tensor(data["img_m"])
        res = [r.clone() for r in fn(f, m)]
        # the keypoint weights the fit took (the same computation again)
        slabs = halo.Slabs(f.shape[2], halo.block(net), mesh.space_group)
        z0, z1 = slabs.local(0)
        with torch.no_grad():
            weights = halo.pair(net, f[:, :, z0:z1], m[:, :, z0:z1], slabs)[2]
        out[case["name"]] = res + [weights]
    return out


def job_groupwise_register(spec, rank):
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.models.unet import UNet3D
    from keymorph_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type="cpu", timeout=TIMEOUT, **spec["mesh"])
    model = KeyMorph(UNet3D(**UNET), K, device="cpu")
    model.net.load_state_dict(torch.load(spec["weights"], weights_only=True))
    model.eval()
    imgs = np.load(spec["data"])["imgs"]
    model.seed_rng(0)
    res = model.groupwise_register(imgs, transform_type=spec["types"], num_iters=3, mesh=mesh,
                                   **spec.get("kw", {}))
    return {name: {k: v for k, v in r.items() if k != "time"} for name, r in res.items()}


def job_eval(spec, rank):
    """``run_eval(mesh=...)`` over ``spec["runs"]`` (each a model_eval_dir
    and a skip_if_completed flag, in order), on the pairs of
    ``spec["data"]``."""
    from types import SimpleNamespace

    from keymorph_tpu_torch.cli.eval_pairwise import run_eval
    from keymorph_tpu_torch.models.keymorph import KeyMorph
    from keymorph_tpu_torch.models.unet import UNet3D
    from keymorph_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type="cpu", timeout=TIMEOUT, **spec["mesh"])
    model = KeyMorph(UNet3D(**UNET), K, device="cpu")
    model.net.load_state_dict(torch.load(spec["weights"], weights_only=True))
    model.eval()
    items = pairs(spec["data"])
    out = []
    for run_spec in spec["runs"]:
        if run_spec.get("remove") and rank == 0:
            os.remove(run_spec["remove"])
        mesh.barrier()
        args = SimpleNamespace(early_stop_eval_subjects=None, seg_available=spec["seg"], dim=3,
                               skip_if_completed=run_spec["skip"],
                               model_eval_dir=run_spec["dir"])
        model.seed_rng(0)
        out.append(run_eval(items, model, spec["metrics"], [("T1", "T1")], ["rot0"],
                            spec["aligns"], args, mesh=mesh))
    return out


def pairs(path):
    """The (fixed, moving) items of run_eval's loader from an .npz of
    stacked volumes (and segmentations)."""
    data = np.load(path)
    items = []
    for i in range(len(data["img_f"])):
        side = []
        for s in ("f", "m"):
            d = {"img": data[f"img_{s}"][i: i + 1], "affine": np.eye(4, dtype=np.float32)[None],
                 "modality": ["T1"]}
            if f"seg_{s}" in data:
                d["seg"] = data[f"seg_{s}"][i: i + 1]
            side.append(d)
        items.append(tuple(side))
    return items


def job_cli(spec, rank):
    from keymorph_tpu_torch.cli import register

    return register.main(spec["argv"])


def job_tasks(spec, rank):
    """Several jobs in one set of processes: ``spec["tasks"]`` is a list of
    (job, spec); returns their results in order."""
    return [JOBS[job](sub, rank) for job, sub in spec["tasks"]]


JOBS = {"mesh": job_mesh, "train": job_train, "register": job_register, "spatial": job_spatial,
        "groupwise_register": job_groupwise_register, "eval": job_eval, "cli": job_cli,
        "tasks": job_tasks}


def main():
    import torch.distributed as dist

    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=launch.store_url(tmp), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    spec = json.loads((tmp / "spec.json").read_text())
    result = JOBS[job](spec, rank)
    torch.save(result, tmp / f"result_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
