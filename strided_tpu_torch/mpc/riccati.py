"""Finite-horizon Riccati recursion: time-varying LQR gains and their fixpoint.

Counterpart of ``strided_tpu/mpc/riccati.py``. The reference's backward
``lax.scan`` becomes a Python loop over fixed shapes: the gains are collected
from ``t = N-1`` down to 0, then reversed into time order. It is an oracle
for the condensed QP independent of it (the same optimal control by another
factorization). Products run in IEEE FP32 (``matmul_precision_scope``), and
the solves use ``solve_ex`` without its host-side check, so nothing here
reads a value back from the card. It stays eager: it runs once per
controller build, where a capture would cost more than it saves.
"""

from __future__ import annotations

import torch

from ..config import matmul_precision_scope

__all__ = ["lqr_gains", "lqr_apply", "riccati_converge"]


@matmul_precision_scope
def lqr_gains(A, B, Q, R, QN, N: int):
    """Time-varying finite-horizon LQR gains K_t (t = 0..N-1) for
    x_{t+1} = A x_t + B u_t, cost sum x'Qx + u'Ru + terminal x'QN x.

    Returns (Ks, Ps): Ks (N, m, n) with u_t = -K_t x_t; Ps (N+1, n, n)
    cost-to-go matrices in time order, P_N last."""
    P = QN
    Ks, Ps = [], []
    for _ in range(N):
        BtP = B.mT @ P
        S = R + BtP @ B
        K = torch.linalg.solve_ex(S, BtP @ A, check_errors=False)[0]
        P = Q + A.mT @ P @ (A - B @ K)
        P = 0.5 * (P + P.mT)
        Ks.append(K)
        Ps.append(P)
    return torch.stack(Ks[::-1]), torch.stack([*Ps[::-1], QN])


@matmul_precision_scope
def lqr_apply(Ks, x0, A, B):
    """Roll the time-varying LQR policy forward from x0 (n,). Returns
    (xs, us): xs (N, n) the state before each step, us (N, m)."""
    x, xs, us = x0, [], []
    for K in Ks:
        u = -(K @ x)
        xs.append(x)
        us.append(u)
        x = A @ x + B @ u
    return torch.stack(xs), torch.stack(us)


def riccati_converge(A, B, Q, R, iters: int = 200):
    """Infinite-horizon gain and cost-to-go by iterating the Riccati map to
    its fixpoint."""
    Ks, Ps = lqr_gains(A, B, Q, R, Q, iters)
    return Ks[0], Ps[0]
