"""strided_tpu_torch: the PyTorch / CUDA port of strided_tpu.

Four slices are ported. The scenario-batched quadrotor MPC step: the
models, the condensed-QP solver with its fused-ADMM CUDA kernel, and the
closed-loop controller. The rest of the MPC stack, in plain PyTorch: the
pendulum, cartpole and vehicle models, batched rollouts, the Riccati
recursion and batched iLQR (``models``, ``mpc``). The whole strided
engine: lazy strided views, lazy expressions, the fused
map/broadcast/reduce engine with its tile-pair (K2), stream-reduction (K3)
and tile-executor (K4) CUDA kernels, and the linalg layer (``mul``, ``@``,
``axpby``, ``contract``). And the multi-GPU layer over
``torch.distributed`` (``parallel``: meshes of ranks, the scenario-split
MPC step and its consensus all-reduce, split matmuls, K2 and K3 per rank),
with checkpoints and profiling in ``utils``; as in the reference, neither
is imported here. The TPU round's probe scripts are in ``benchmarks/``.
``capture`` is the counterpart of ``jax.jit``: on the card
``closed_loop``, the rollouts, ``ilqr`` and ``entry()``'s step each run as
one CUDA-graph replay (``from strided_tpu_torch.capture import capture,
disable_capture``).
"""

from . import config  # noqa: F401
from .config import Config, get_config, set_config  # noqa: F401
from .models import Model, rk4_step, linearize, quadrotor, hover_state, hover_input  # noqa: F401
from .mpc import (  # noqa: F401
    CondensedQP,
    LinearMPC,
    build_condensed,
    closed_loop,
    make_hover_mpc,
    qp_solve,
    qp_solve_unconstrained,
)
from .core.view import (  # noqa: F401
    StridedView,
    StridedLayoutError,
    strided,
    as_view,
    isstrided,
    permutedims,
    transpose,
    adjoint,
    conj,
    sreshape,
    sview,
    set_view,
    flip,
    broadcast_to,
)
from .core.regularize import materialize  # noqa: F401
from .core.mapreduce import (  # noqa: F401
    smap,
    map_into,
    copy_into,
    permutedims_into,
    adjoint_into,
    conj_into,
    sreduce,
    sreduce_dims,
    mapreducedim_into,
    fused_mapreduce,
    ssum,
    sprod,
    smax,
    smin,
    smean,
)
from .core.broadcast import sbroadcast, sbroadcast_into, StridedExpr  # noqa: F401
from .api import strided_jit, maybe_strided, maybe_unstrided, to_array  # noqa: F401
from .core.kernels_special import symmetrize, pair_axpby  # noqa: F401
from .linalg import mul, matmul, axpy, axpby, lmul, rmul, scale_into, contract  # noqa: F401
from . import ops  # noqa: F401
