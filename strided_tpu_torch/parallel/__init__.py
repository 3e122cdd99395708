"""The multi-GPU layer over ``torch.distributed`` (counterpart of
``strided_tpu/parallel``): meshes of ranks, scenario-split MPC steps and
the consensus all-reduce (captured on the card, NCCL's collectives in the
graph), tensor-parallel matmuls, the mesh-split engine
ops (K2 and K3 per rank), and the multi-process check."""

from .mesh import (  # noqa: F401
    make_mesh,
    shard,
    gather,
    axis_size,
    axis_index,
    collective,
    COLLECTIVES,
)
from .sharded import (  # noqa: F401
    shard_batch,
    mesh_capture,
    sharded_rollout,
    sharded_mpc_step,
    scenario_consensus_control,
)
from .tp import matmul_nsplit, matmul_msplit, matmul_ksplit  # noqa: F401
from .engine import (  # noqa: F401
    choose_split_dim,
    sharded_smap,
    sharded_reduce,
    sharded_batched_pair,
    sharded_stream_sum,
)
from .dist import init_distributed  # noqa: F401
