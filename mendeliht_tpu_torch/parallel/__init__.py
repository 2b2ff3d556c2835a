"""Several devices on ``torch.distributed``, one process a device: the
(task, snp) mesh and its sharding (``mesh``), the SNP-sharded genotype
operator (``sharded_ops``), and multi-process ingest and start-up
(``multihost``); the JAX package's ``parallel/``."""

from .mesh import (gather_state, geno_sharding, make_mesh,
                   mv_state_sharding, pad_geno_rows, shard_data,
                   shard_geno_op, shard_mv_data, shard_mv_state, shard_state,
                   state_sharding)
from .sharded_ops import ShardedPackedOp
from . import multihost
from .dryrun import dryrun_multichip

__all__ = ["make_mesh", "geno_sharding", "state_sharding", "shard_state",
           "shard_geno_op", "shard_data", "ShardedPackedOp", "multihost",
           "pad_geno_rows", "mv_state_sharding", "shard_mv_state",
           "shard_mv_data", "gather_state", "dryrun_multichip"]
