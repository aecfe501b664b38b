"""Distribution over ``torch.distributed`` process groups (counterpart of
``lrs_pnp_dip_tpu/parallel``): a named device mesh, placement rules, the
collective SVT and sparse proxes, the sharded solver engine and channel
tensor parallelism of the DIP nets.  ``python -m
lrs_pnp_dip_tpu_torch.parallel.launch`` starts the ranks of one machine."""

from .mesh import make_mesh, mesh_axis_sizes
from .sharding import consts_sharding, replicate, state_sharding
from .collectives import (
    distributed_gram,
    distributed_svt,
    distributed_svt_2d,
    make_distributed_svt,
    make_distributed_svt_2d,
    make_sharded_sparse_prox,
    make_sharded_sparse_prox_2d,
)
from .engine import ShardedSolver
from .tensor import (
    channel_sharding_report,
    channel_sharding_specs,
    make_channel_constraint,
    make_tp_dip_step,
    shard_channelwise,
)

__all__ = [
    "channel_sharding_report",
    "channel_sharding_specs",
    "make_channel_constraint",
    "make_tp_dip_step",
    "shard_channelwise",
    "make_mesh",
    "mesh_axis_sizes",
    "state_sharding",
    "consts_sharding",
    "replicate",
    "distributed_gram",
    "distributed_svt",
    "distributed_svt_2d",
    "make_distributed_svt",
    "make_distributed_svt_2d",
    "make_sharded_sparse_prox",
    "make_sharded_sparse_prox_2d",
    "ShardedSolver",
]
