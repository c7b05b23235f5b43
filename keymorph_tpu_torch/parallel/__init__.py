"""Multi-device registration and training on ``torch.distributed``: the
device mesh (``mesh.py``), the sharded steps and factories (``sharded.py``)
and the Z-split module path of the spatial registration (``halo.py``).
Port of ``keymorph_tpu/parallel/``; launch one process per GPU with
``torchrun``, or start a world's processes from a parent with
``launch.spawn``."""

from keymorph_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch  # noqa: F401
from keymorph_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_groupwise_fn,
    make_sharded_register_fn,
    make_sharded_train_step,
    make_spatial_register_fn,
)
