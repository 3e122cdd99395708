"""The Jacobians of the quadrotor's RK4 step as one kernel
(``csrc/quadrotor_jac.cu``).

:func:`jacobians` computes what ``base.linearize(quadrotor(m, g, Jx, Jy,
Jz), xs, us, dt)`` computes by ``vmap(jacfwd)`` of the eager step: ``A =
dx+/dx`` ``(*batch, 12, 12)`` and ``B = dx+/du`` ``(*batch, 12, 4)``, in one
launch, with the forward mode's rule for each operation of the eager step
(the source's header says how), in float32 and float64. ``vmap(jacfwd)``
runs the eager step on dual tensors as about 1,300 elementwise kernels; it
stays the plain version.

On a CUDA tensor it launches the kernel or raises, as the plant kernel
(``quadrotor_rk4``) does, and declines (returns ``None``, and
``base.linearize`` then runs ``vmap(jacfwd)``) in the plant kernel's two
cases alone: on CPU tensors and on a tensor autodiff can see
(``quadrotor_rk4.decline_reason``). ``DECLINES`` counts the declines by
reason ("autodiff", "cpu") and ``LAUNCHES`` the launches (a CUDA-graph replay
adds none).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import quadrotor_rk4

__all__ = ["jacobians", "operands", "ARGTYPES", "LAUNCHES", "DECLINES"]

LAUNCHES: int = 0
DECLINES: collections.Counter = collections.Counter()


def _argtypes(scalar):
    # strided_quadrotor_jac_<f32|f64>(x, x_outer, x_row, x_col, u, u_outer,
    # u_row, u_col, A, B, outer, inner, inv_m, Jx, Jy, Jz, half_dt, dt,
    # sixth_dt, stream)
    strided = [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    return (strided * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [scalar] * 7
            + [ctypes.c_void_p])


ARGTYPES = {torch.float32: _argtypes(ctypes.c_float), torch.float64: _argtypes(ctypes.c_double)}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _kernel_fn(dtype):
    from .._build import load_library

    fn = getattr(load_library(), f"strided_quadrotor_jac_{_SUFFIX[dtype]}")
    fn.argtypes = ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def operands(xs, us, dt):
    """``xs`` and ``us`` as ``(outer, inner, 12)`` and ``(outer, inner, 4)``
    views, ``inner`` the last batch dim (the horizon of a trajectory), as the
    kernel reads them: through their strides, so a slice ``xs[..., :-1, :]``
    of a trajectory is read where it lies (``reshape`` copies only leading
    dims it cannot merge); ``us`` is broadcast to ``xs``'s batch dims. Raises
    on what the kernel does not compute (``quadrotor_rk4.check_operands``).
    """
    quadrotor_rk4.check_operands(xs, us, dt)
    outer, inner = math.prod(xs.shape[:-2]), (xs.shape[-2] if xs.dim() > 1 else 1)
    return (xs.reshape(outer, inner, 12),
            us.expand(*xs.shape[:-1], 4).reshape(outer, inner, 4))


def jacobians(xs, us, dt, *, m: float,
              J: tuple) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(A, B)``, the Jacobians of one RK4 step of the quadrotor with mass
    ``m`` and inertia ``J = (Jx, Jy, Jz)`` (gravity drops out of every
    derivative) at each point of ``xs`` ``(*batch, 12)`` and ``us`` ``(*batch,
    4)``: new contiguous tensors ``(*batch, 12, 12)`` and ``(*batch, 12,
    4)``, or ``None`` when it declines. Raises on operands the kernel does
    not take (:func:`operands`, or not both on one CUDA device) and if the
    launch fails."""
    global LAUNCHES
    reason = quadrotor_rk4.decline_reason(xs, us)
    if reason is not None:
        DECLINES[reason] += 1
        return None
    if xs.device.type != "cuda" or us.device != xs.device:
        raise ValueError(f"quadrotor_jac: xs and us must be on one CUDA device, got "
                         f"{xs.device}, {us.device}")
    x3, u3 = operands(xs, us, dt)
    batch = xs.shape[:-1]
    A = torch.empty((*batch, 12, 12), dtype=xs.dtype, device=xs.device)
    B = torch.empty((*batch, 12, 4), dtype=xs.dtype, device=xs.device)
    if xs.numel() == 0:
        return A, B
    Jx, Jy, Jz = J
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        # 1 / m, 0.5 dt and dt / 6 in double, as the eager step's Python does
        err = _kernel_fn(xs.dtype)(x3.data_ptr(), *x3.stride(), u3.data_ptr(), *u3.stride(),
                                   A.data_ptr(), B.data_ptr(), x3.shape[0], x3.shape[1],
                                   1.0 / m, Jx, Jy, Jz, 0.5 * dt, dt, dt / 6.0, stream)
    if err != 0:
        raise RuntimeError(f"quadrotor_jac: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    return A, B
