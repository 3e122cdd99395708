"""strided_tpu_torch: the PyTorch / CUDA port of strided_tpu.

This slice covers the scenario-batched quadrotor MPC step: the models, the
condensed-QP solver with its fused-ADMM CUDA kernel, and the closed-loop
controller. The strided engine is not ported yet.
"""

from . import config  # noqa: F401
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
