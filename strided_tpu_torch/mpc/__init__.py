from .qp import (  # noqa: F401
    CondensedQP,
    build_condensed,
    qp_solve,
    qp_solve_unconstrained,
)
from .mpc import LinearMPC, make_hover_mpc, closed_loop  # noqa: F401
