"""Multi-device / multi-host parallelism: meshes, sharded ops, halo exchange."""

from .bucket import sparse_spectrum_sharded
from .distributed import host_shard, maybe_initialize_distributed
from .mesh import DP_AXIS, TP_AXIS, batch_sharding, make_mesh, table_sharding
from .seqpar import SP_AXIS, count_perread_seqpar, make_seq_mesh, spectrum_seqpar
from .sharded import (
    count_perread_sharded,
    count_perread_sparse_sharded,
    shard_batch,
    spectrum_sharded,
)

__all__ = [
    "sparse_spectrum_sharded",
    "count_perread_sparse_sharded",
    "host_shard",
    "maybe_initialize_distributed",
    "DP_AXIS",
    "TP_AXIS",
    "SP_AXIS",
    "make_mesh",
    "make_seq_mesh",
    "batch_sharding",
    "table_sharding",
    "shard_batch",
    "count_perread_sharded",
    "spectrum_sharded",
    "count_perread_seqpar",
    "spectrum_seqpar",
]
