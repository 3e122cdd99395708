"""Condensed-QP linear MPC: setup on the host, batched ADMM solves.

Counterpart of ``strided_tpu/mpc/qp.py``. With discrete LTI dynamics
``x_{k+1} = A x_k + B u_k`` the stacked prediction is ``X = Sx x0 + Su U``;
substituting it into the quadratic cost gives the dense input-space QP

    min_U  0.5 U' H U + x0' M' U,   H = Su' Qbar Su + Rbar,  M = Su' Qbar Sx

``build_condensed`` forms every static matrix once, in f64 numpy.
``qp_solve`` handles box input constraints with over-relaxed ADMM at a fixed
iteration count, batched over scenarios; on f32 CUDA tensors its iterations
run in the fused-ADMM kernel (``fused_admm.py``), unless the first
``coarse_iters`` of them are asked to run at "default" (single-pass bf16
products, ``config.matmul``), which the kernel does not do.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import get_config, matmul, matmul_precision_scope
from ..utils.profiling import annotated
from . import fused_admm as _fa

__all__ = ["CondensedQP", "build_condensed", "qp_solve", "qp_solve_unconstrained"]


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Static condensed-QP data, stored as tensors in the working dtype."""

    A: torch.Tensor       # (n, n)
    B: torch.Tensor       # (n, m)
    Su: torch.Tensor      # (N*n, N*m)
    Sx: torch.Tensor      # (N*n, n)
    H: torch.Tensor       # (N*m, N*m)
    M: torch.Tensor       # (N*m, n)   g = M @ x0
    K_lqr: torch.Tensor   # (N*m, n)   U* = -K_lqr @ x0 (unconstrained)
    solver: torch.Tensor  # (H + rho I)^{-1} (use_chol=False) or
                          # cholesky(H + rho I) (use_chol=True), formed in f64
    rho: float
    N: int
    n: int
    m: int
    use_chol: bool = False


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def build_condensed(A, B, Q, R, QN, N: int, rho: float = 1.0) -> CondensedQP:
    """One-time setup: prediction matrices, H, its factors. Runs in f64 on
    the host (numpy) and stores tensors in the dtype and device of ``A``."""
    dtype, device = A.dtype, A.device
    A_, B_ = _f64(A), _f64(B)
    Q_, R_, QN_ = _f64(Q), _f64(R), _f64(QN)
    n, m = B_.shape
    # Powers of A: Apow[i] = A^i
    Apow = [np.eye(n)]
    for _ in range(N):
        Apow.append(A_ @ Apow[-1])
    Sx = np.concatenate([Apow[i + 1] for i in range(N)], axis=0)  # (N*n, n)
    Su = np.zeros((N * n, N * m))
    for i in range(N):  # block row i predicts x_{i+1}
        for j in range(i + 1):
            Su[i * n : (i + 1) * n, j * m : (j + 1) * m] = Apow[i - j] @ B_
    Qbar = np.kron(np.eye(N), Q_)
    Qbar[-n:, -n:] = QN_
    Rbar = np.kron(np.eye(N), R_)
    H = Su.T @ Qbar @ Su + Rbar
    H = 0.5 * (H + H.T)
    M = Su.T @ Qbar @ Sx
    K_lqr = np.linalg.solve(H, M)
    H_admm = H + rho * np.eye(N * m)
    # The explicit inverse turns each ADMM iteration into one dense batched
    # matmul. If the rho ridge did not tame the conditioning (tiny rho, huge
    # N*m), fall back to the Cholesky triangular-solve pair, which stays
    # accurate.
    cond = float(np.linalg.cond(H_admm))
    use_chol = cond > 1e7
    if use_chol:
        warnings.warn(
            f"cond(H + rho I) = {cond:.2e}: ADMM uses Cholesky triangular "
            "solves instead of the explicit inverse (slower, accurate); "
            "consider a larger rho",
            stacklevel=2,
        )
        solver = np.linalg.cholesky(H_admm)
    else:
        solver = np.linalg.inv(H_admm)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return CondensedQP(
        A=to(A_), B=to(B_), Su=to(Su), Sx=to(Sx), H=to(H), M=to(M),
        K_lqr=to(K_lqr), solver=to(solver),
        rho=rho, N=N, n=n, m=m, use_chol=use_chol,
    )


@matmul_precision_scope
def qp_solve_unconstrained(qp: CondensedQP, x0: torch.Tensor) -> torch.Tensor:
    """U* = -H^{-1} M x0 via the precomputed gain. x0 ``(*batch, n)`` ->
    U ``(*batch, N, m)``."""
    U = matmul(-x0, qp.K_lqr.T)
    return U.reshape(*x0.shape[:-1], qp.N, qp.m)


def _chol_solve(L, b):
    """Solve (L L') z = b for a batch of right-hand sides (b: (*batch, k)),
    folding the batch into the columns of one triangular solve pair."""
    bshape = b.shape
    bt = b.reshape(-1, bshape[-1]).T  # (k, B)
    y = torch.linalg.solve_triangular(L, bt, upper=False)
    z = torch.linalg.solve_triangular(L.T, y, upper=True)
    return z.T.reshape(bshape)


def _fused_admm_fits(qp: CondensedQP, z2: torch.Tensor) -> bool:
    """The kernel's own limits, device aside: the explicit-inverse solver,
    (B, D) f32 iterates and D <= MAX_D. A wider QP takes the loop path, as
    the JAX package's scan does for every D."""
    return (
        not qp.use_chol
        and z2.ndim == 2
        and z2.dtype == torch.float32
        and z2.shape[-1] <= _fa.MAX_D
    )


def _fused_admm_eligible(qp: CondensedQP, z2: torch.Tensor) -> bool:
    return get_config().fused_admm and z2.is_cuda and _fused_admm_fits(qp, z2)


@matmul_precision_scope
@annotated("qp.solve")
def qp_solve(
    qp: CondensedQP,
    x0: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    iters: int = 20,
    alpha: float = 1.6,
    coarse_iters: int = 0,
) -> torch.Tensor:
    """Box-constrained condensed QP via over-relaxed ADMM, fixed ``iters``.

    x0 ``(*batch, n)``; u_min/u_max ``(m,)`` bounds (applied per stage).
    Returns U ``(*batch, N, m)``. ``g``, the warm start and every iteration's
    product run at the configured precision (:func:`matmul_precision_scope`,
    ``config.matmul``): ADMM converges to the fixed point of the *computed*
    g, so a reduced-precision ``g = M x0`` biases every iterate.

    ``coarse_iters`` (clipped to ``[0, iters]``): the first ``coarse_iters``
    iterations take their product at "default" (single-pass bf16 on the
    card; IEEE FP32 on the CPU) and the rest at the configured precision.
    An opt-in trade of accuracy for fewer product passes, as in the
    reference: the accurate tail does not absorb the coarse phase's bias,
    so the 1e-4 first-input gate fails for any useful split. The fused
    kernel runs only when ``coarse_iters`` is 0. The Cholesky fallback's
    triangular solves run in IEEE FP32 in either phase."""
    g = matmul(x0, qp.M.T)  # (*batch, N*m)
    lo = u_min.repeat(qp.N)
    hi = u_max.repeat(qp.N)
    z = torch.minimum(torch.maximum(matmul(-x0, qp.K_lqr.T), lo), hi)
    D = z.shape[-1]
    g2 = g.reshape(-1, D)
    z2 = z.reshape(-1, D)
    coarse = max(0, min(int(coarse_iters), int(iters)))
    if coarse == 0 and _fused_admm_eligible(qp, z2):
        zf = _fa.fused_admm(
            g2.contiguous(), z2.contiguous(), qp.solver.contiguous(),
            lo.contiguous(), hi.contiguous(),
            rho=float(qp.rho), alpha=float(alpha), iters=int(iters),
        )
        return zf.reshape(*x0.shape[:-1], qp.N, qp.m)
    y = torch.zeros_like(z)
    for k in range(iters):
        rhs = qp.rho * (z - y) - g
        if qp.use_chol:
            u = _chol_solve(qp.solver, rhs)
        else:
            u = matmul(rhs, qp.solver, "default" if k < coarse else None)
        u_rel = alpha * u + (1 - alpha) * z
        z_new = torch.minimum(torch.maximum(u_rel + y, lo), hi)
        y = y + u_rel - z_new
        z = z_new
    return z.reshape(*x0.shape[:-1], qp.N, qp.m)
