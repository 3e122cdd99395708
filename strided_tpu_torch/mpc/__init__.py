from .rollout import rollout, rollout_final  # noqa: F401
from .ilqr import QuadCost, ilqr, ilqr_batched, ILQRResult, ILQRMPC  # noqa: F401
from .qp import (  # noqa: F401
    CondensedQP,
    build_condensed,
    qp_solve,
    qp_solve_unconstrained,
)
from .mpc import LinearMPC, make_hover_mpc, closed_loop  # noqa: F401
from .riccati import lqr_gains, lqr_apply, riccati_converge  # noqa: F401
