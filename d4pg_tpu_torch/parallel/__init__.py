"""Distributed compute: the rank mesh and the data-parallel learner.

Counterpart of ``d4pg_tpu/parallel/``. The reference's parallelism is
synchronous data parallelism over a device mesh (params and optimizer
state replicated, the batch split over a ``data`` axis, the gradient
all-reduce inserted by XLA). The port's mesh is the ranks of one
``torch.distributed`` group, one process and one device per rank
(``mesh.py``, ``multihost.py``); each rank updates on its own rows and
the gradients are averaged between backward and the Adam step
(``data_parallel.py``). A mesh with ``model_parallel > 1`` splits the
pixel encoder's convolutions over its ``model`` axis by the partition
rules (``partition.py``, ``model_axis.py``). ``replica_mesh`` places
mesh-native learner replicas (``learner/mesh_replicas.py``).
``multihost_check.py`` is the scripted two-rank check.
"""

from d4pg_tpu_torch.parallel import partition
from d4pg_tpu_torch.parallel.data_parallel import (
    check_mesh_compatible,
    grad_reducer,
    make_sharded_multi_update,
    make_sharded_update,
    replicate_state,
    shard_batch,
    shard_stacked,
)
from d4pg_tpu_torch.parallel.mesh import MeshSpec, RankMesh, replica_mesh
from d4pg_tpu_torch.parallel.multihost import global_mesh, spawn_local

__all__ = [
    "MeshSpec",
    "RankMesh",
    "check_mesh_compatible",
    "global_mesh",
    "grad_reducer",
    "make_sharded_multi_update",
    "make_sharded_update",
    "partition",
    "replica_mesh",
    "replicate_state",
    "shard_batch",
    "shard_stacked",
    "spawn_local",
]
