"""The device mesh, batch sharding and the collectives of the parallel layer.

Port of ``keymorph_tpu/parallel/mesh.py``. keymorph_tpu is single-controller:
one process drives a ``jax.sharding.Mesh`` and XLA places the shards. The
port is SPMD: one process per GPU, launched with ``torchrun``; each process
builds the same mesh (``torch.distributed.device_mesh.init_device_mesh``
under keymorph_tpu's axis names ``("data", "space")``, or ``("dcn", "data",
"space")`` with ``dcn > 1``), holds its own shard and runs the port's
kernels on it. Rank ``r`` sits at the mesh coordinate of ``r`` in the
row-major layout, so 'dcn' varies slowest, as in keymorph_tpu.

Every process group of a mesh has a timeout, and the layer calls only
``all_reduce`` and ``all_gather``, on tensors of the mesh's device: NCCL
takes both, and so does gloo, on CPU tensors and (torch 2.11) on CUDA
tensors, which it stages through the host itself. Gloo refuses an
all_gather of unequal blocks, so :func:`gather_cat` pads them. Two ranks on
one card must use gloo: NCCL refuses a GPU twice in one communicator.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``("data", "space")`` or ``("dcn", "data", "space")`` mesh over every
    process of the world.

    ``shape`` maps each axis name to its size, as a ``jax.sharding.Mesh``'s
    does. ``data_group`` spans this process's ranks along ('dcn', 'data'),
    the data-parallel axes, jointly; ``space_group`` spans its ranks along
    'space'; ``world_group`` every rank. ``data_index`` is this process's
    position along the data-parallel axes ('dcn' major), ``space_index``
    along 'space'. ``device`` holds its shards.
    """

    device_mesh: object
    shape: dict
    device: torch.device
    rank: int
    data_index: int
    space_index: int
    data_group: object
    space_group: object
    world_group: object

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def data_size(self) -> int:
        """The data-parallel size: 'dcn' x 'data'."""
        return self.shape.get("dcn", 1) * self.shape["data"]

    @property
    def space_size(self) -> int:
        return self.shape["space"]

    @property
    def size(self) -> int:
        return self.data_size * self.space_size

    @property
    def is_main(self) -> bool:
        """Rank 0: the one process that prints and writes summaries."""
        return self.rank == 0

    def barrier(self):
        """Wait for every rank (an all_reduce of one number)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.world_group)


def world_size() -> int:
    """The number of processes a launcher started (``WORLD_SIZE``, 1 when
    unset), or the initialized default group's size."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def launch_mesh(device: Optional[str] = None) -> Optional[Mesh]:
    """The CLIs' mesh: a ('data', 'space') mesh with 'space' 1 over every
    process when a launcher started more than one (keymorph_tpu's CLIs build
    it when more than one device is visible), else None. ``device`` is the
    CLI's ``--device`` (None: the card)."""
    if world_size() <= 1:
        return None
    return make_mesh(space=1, device_type=torch.device(device).type if device else "cuda")


def make_mesh(num_devices: Optional[int] = None, data: Optional[int] = None, space: int = 1,
              dcn: int = 1, device_type: str = "cuda",
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Build a ('data', 'space') mesh, or with ``dcn > 1`` a two-level
    ('dcn', 'data', 'space') mesh, over every process of the world.

    Args:
        num_devices: total devices (default and only value: the world size;
            one process drives one device).
        data: data-parallel axis size (default ``num_devices // (space * dcn)``).
        space: spatial-sharding axis size.
        dcn: the slowest-varying axis, for meshes over several hosts: batch
            and subject axes shard over ('dcn', 'data') jointly.
        device_type: "cuda" (each process on its ``LOCAL_RANK``'s card,
            NCCL unless the caller initialized another backend) or "cpu"
            (gloo).
        timeout: of the default group (when this call initializes it) and
            of every group the mesh creates.

    Initializes the default process group from the launcher's environment
    (``torchrun``) when it is not initialized. Raises ``ValueError`` where
    keymorph_tpu asserts: sizes that do not multiply to the device count.
    """
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", timeout=timeout)
    n_world = dist.get_world_size()
    n = num_devices or n_world
    if n != n_world:
        raise ValueError(f"num_devices={n}: the mesh spans every process, {n_world} here "
                         "(one process drives one device)")
    inner = space * dcn
    if data is None:
        if n % inner:
            raise ValueError(f"{n} devices not divisible by space*dcn={inner}")
        data = n // inner
    if data * space * dcn != n:
        raise ValueError(f"dcn*data*space must equal device count ({n}), got "
                         f"{dcn}*{data}*{space}")
    from torch.distributed.device_mesh import init_device_mesh

    names = ("dcn", "data", "space") if dcn > 1 else ("data", "space")
    sizes = (dcn, data, space) if dcn > 1 else (data, space)
    device_mesh = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(dcn * data, space)
    # every rank creates every group, in the same order
    space_groups = [dist.new_group(row.tolist(), timeout=timeout) for row in grid]
    data_groups = [dist.new_group(col.tolist(), timeout=timeout) for col in grid.T]
    world_group = dist.new_group(list(range(n)), timeout=timeout)
    data_index, space_index = divmod(rank, space)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    return Mesh(device_mesh=device_mesh, shape=dict(zip(names, sizes)), device=device,
                rank=rank, data_index=data_index, space_index=space_index,
                data_group=data_groups[space_index], space_group=space_groups[data_index],
                world_group=world_group)


def require_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a ``TypeError`` for anything that is not a
    :class:`Mesh` (build one with :func:`make_mesh`)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a keymorph_tpu_torch.parallel.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` rows sharded over the
    data-parallel axes: the block ``P(("dcn", "data"))`` places here."""
    if n % mesh.data_size:
        raise ValueError(f"{n} rows do not divide over the data-parallel size {mesh.data_size}")
    b = n // mesh.data_size
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a host batch (a tensor or array, or a dict, list
    or tuple of them; None passes), on the mesh's device."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    t = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
    return t[local_rows(mesh, t.shape[0])].to(mesh.device)


def split_sizes(n: int, parts: int, block: int = 1, empty_ok: bool = False) -> List[int]:
    """Sizes of ``parts`` contiguous slabs of ``n`` items whose boundaries
    fall on multiples of ``block``: the blocks are dealt as evenly as they
    go, the earlier slabs taking one more, and the last slab takes any
    remainder below ``block``. Raises ``ValueError`` when there are fewer
    blocks than parts, unless ``empty_ok`` (the slabs after the blocks run
    out are then empty, but for the remainder of the last)."""
    blocks = n // block
    if blocks < parts and not empty_ok:
        raise ValueError(f"{n} planes hold {blocks} blocks of {block}, fewer than the "
                         f"{parts} slabs asked for")
    sizes = [(blocks // parts + (i < blocks % parts)) * block for i in range(parts)]
    sizes[-1] += n - blocks * block
    return sizes


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (in place; returned)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def gather_cat(t: torch.Tensor, group, dim: int = 0,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's block of ``group`` concatenated along ``dim``, on every
    rank. ``sizes``: each rank's extent along ``dim`` where they differ (by
    default all equal to this rank's)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    if sizes is None or len(set(sizes)) == 1:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)
    pad = [0] * (2 * (t.dim() - dim))
    pad[-1] = max(sizes) - t.shape[dim]
    parts = [torch.empty_like(torch.nn.functional.pad(t, pad)) for _ in range(n)]
    dist.all_gather(parts, torch.nn.functional.pad(t, pad).contiguous(), group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


def gather_json(obj, group, device) -> list:
    """Every rank's JSON-serializable ``obj``, in rank order, on every rank
    of ``group`` (the bytes travel as a uint8 tensor on ``device``)."""
    n = group_size(group)
    if n == 1:
        return [obj]
    data = torch.tensor(list(json.dumps(obj).encode()), dtype=torch.uint8, device=device)
    sizes = torch.zeros(n, dtype=torch.int64, device=device)
    sizes[group_rank(group)] = data.numel()
    all_reduce(sizes, group)
    sizes = sizes.tolist()
    out = gather_cat(data, group, 0, sizes)
    offsets = np.cumsum([0] + sizes)
    raw = bytes(out.cpu().tolist())
    return [json.loads(raw[offsets[i]: offsets[i + 1]].decode()) for i in range(n)]
