"""Carry a controller's state or a cost across from the JAX package.

``linear_mpc_from_numpy`` builds this package's :class:`LinearMPC` from the
arrays of a ``strided_tpu`` controller, and ``quad_cost_from_numpy`` its
:class:`QuadCost` from those of an iLQR cost, given as numpy arrays and
Python scalars, so both packages can be run on the very same problem. The
models carry only Python floats and need no converter.
"""

from __future__ import annotations

import numpy as np
import torch

from .mpc.ilqr import QuadCost
from .mpc.mpc import LinearMPC
from .mpc.qp import CondensedQP

__all__ = ["linear_mpc_from_numpy", "quad_cost_from_numpy", "QP_ARRAYS", "MPC_ARRAYS",
           "COST_ARRAYS"]

QP_ARRAYS = ("A", "B", "Su", "Sx", "H", "M", "K_lqr", "solver")
MPC_ARRAYS = ("x_eq", "u_eq", "u_min", "u_max")
COST_ARRAYS = ("Q", "R", "Qf", "x_goal")


def linear_mpc_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> LinearMPC:
    """``d`` maps the names in ``QP_ARRAYS`` and ``MPC_ARRAYS`` to arrays,
    and ``rho``, ``N``, ``n``, ``m``, ``use_chol``, ``admm_iters`` (and
    optionally ``constrained``, default True, and ``admm_coarse_iters``,
    default 0) to scalars. Arrays are copied into
    contiguous tensors of ``dtype`` on ``device``."""
    to = lambda k: torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)
    qp = CondensedQP(
        **{k: to(k) for k in QP_ARRAYS},
        rho=float(d["rho"]), N=int(d["N"]), n=int(d["n"]), m=int(d["m"]),
        use_chol=bool(d["use_chol"]),
    )
    return LinearMPC(
        qp=qp,
        **{k: to(k) for k in MPC_ARRAYS},
        admm_iters=int(d["admm_iters"]),
        constrained=bool(d.get("constrained", True)),
        admm_coarse_iters=int(d.get("admm_coarse_iters", 0)),
    )


def quad_cost_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> QuadCost:
    """``d`` maps the names in ``COST_ARRAYS`` to arrays; each is copied into
    a contiguous tensor of ``dtype`` on ``device``."""
    return QuadCost(**{k: torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)
                       for k in COST_ARRAYS})
