"""The quadrotor's RK4 step as one kernel (``csrc/quadrotor_rk4.cu``).

:func:`rk4` computes ``base.rk4_step(quadrotor(m, g, Jx, Jy, Jz).dynamics,
x, u, dt)`` in one launch, one thread a quadrotor, with the eager step's
arithmetic term for term (the source's header says how), in float32 and
float64. Eager PyTorch runs that step as about 130 elementwise kernels; the
eager step stays the plain version.

On a CUDA tensor it launches the kernel or raises, as ``fused_admm`` does.
It declines (returns ``None``, and ``quadrotor()``'s ``Model.step`` then
runs the eager step) in two cases alone: on CPU tensors, where the eager
step is the CPU's version, and on a tensor autodiff can see
(``Model.linearize``'s ``jacfwd`` and ``vmap``, forward-mode duals,
``requires_grad`` under grad mode), since the kernel has no derivative: the
Jacobians are the eager step's by choice. ``DECLINES`` counts the declines
by reason ("autodiff", "cpu") and ``LAUNCHES`` the launches (a CUDA-graph
replay adds none).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["rk4", "decline_reason", "check_operands", "operands", "ARGTYPES", "LAUNCHES",
           "DECLINES", "stress_inputs", "TOLERANCE", "within"]

LAUNCHES: int = 0
DECLINES: collections.Counter = collections.Counter()


def _argtypes(scalar):
    # strided_quadrotor_rk4_<f32|f64>(x, x_row, x_col, u, u_row, u_col, out,
    # rows, inv_m, g, Jx, Jy, Jz, half_dt, dt, sixth_dt, stream)
    strided = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    return (strided * 2 + [ctypes.c_void_p, ctypes.c_longlong] + [scalar] * 8
            + [ctypes.c_void_p])


ARGTYPES = {torch.float32: _argtypes(ctypes.c_float), torch.float64: _argtypes(ctypes.c_double)}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _kernel_fn(dtype):
    from .._build import load_library

    fn = getattr(load_library(), f"strided_quadrotor_rk4_{_SUFFIX[dtype]}")
    fn.argtypes = ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def _seen_by_autodiff(t: torch.Tensor) -> bool:
    return ((t.requires_grad and torch.is_grad_enabled())
            or torch._C._functorch.is_functorch_wrapped_tensor(t)
            or fwAD.unpack_dual(t).tangent is not None)


def decline_reason(x, u) -> Optional[str]:
    """Why :func:`rk4` leaves the step to the eager one: "autodiff" (either
    operand a tensor autodiff can see; asked first, since a wrapped tensor
    has no storage to read), "cpu" (``x`` on the CPU), or ``None`` when it
    takes the step."""
    if _seen_by_autodiff(x) or _seen_by_autodiff(u):
        return "autodiff"
    if x.device.type == "cpu":
        return "cpu"
    return None


def check_operands(x, u, dt):
    """Raises on what the quadrotor's kernels (this one and
    ``quadrotor_jac``'s) do not compute: a ``dt`` that is not a Python
    number, dtypes other than one of float32 and float64 for both, last dims
    other than 12 and 4."""
    if isinstance(dt, bool) or not isinstance(dt, (int, float)):
        raise TypeError(f"quadrotor_rk4: dt must be a Python number, got {type(dt).__name__}")
    if x.dtype not in ARGTYPES or u.dtype != x.dtype:
        raise TypeError(f"quadrotor_rk4: kernel takes float32 or float64, x and u alike, got "
                        f"{x.dtype}, {u.dtype}")
    if x.shape[-1:] != (12,) or u.shape[-1:] != (4,):
        raise ValueError(f"quadrotor_rk4: x must be (..., 12) and u (..., 4), got "
                         f"{tuple(x.shape)}, {tuple(u.shape)}")


def operands(x, u, dt):
    """``x`` and ``u`` as ``(rows, 12)`` and ``(rows, 4)`` views, as the
    kernel reads them (through their strides; ``reshape`` copies only a
    batch it cannot view as evenly spaced rows); ``u`` is broadcast to
    ``x``'s batch dims, as the eager step broadcasts it. Raises on what the
    kernel does not compute (:func:`check_operands`)."""
    check_operands(x, u, dt)
    return x.reshape(-1, 12), u.expand(*x.shape[:-1], 4).reshape(-1, 4)


def rk4(x, u, dt, *, m: float, g: float, J: tuple) -> Optional[torch.Tensor]:
    """One RK4 step of the quadrotor with mass ``m``, gravity ``g`` and
    inertia ``J = (Jx, Jy, Jz)``: ``x`` ``(*batch, 12)``, ``u`` ``(*batch,
    4)``. Returns the next states, a new contiguous tensor, or ``None`` when
    it declines (:func:`decline_reason`). Raises on operands the kernel does
    not take (:func:`operands`, or not both on one CUDA device) and if the
    launch fails."""
    global LAUNCHES
    reason = decline_reason(x, u)
    if reason is not None:
        DECLINES[reason] += 1
        return None
    if x.device.type != "cuda" or u.device != x.device:
        raise ValueError(f"quadrotor_rk4: x and u must be on one CUDA device, got {x.device}, "
                         f"{u.device}")
    xr, ur = operands(x, u, dt)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    Jx, Jy, Jz = J
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # 1 / m, 0.5 dt and dt / 6 in double, as the eager step's Python does
        err = _kernel_fn(x.dtype)(xr.data_ptr(), *xr.stride(), ur.data_ptr(), *ur.stride(),
                                  out.data_ptr(), xr.shape[0], 1.0 / m, g, Jx, Jy, Jz,
                                  0.5 * dt, dt, dt / 6.0, stream)
    if err != 0:
        raise RuntimeError(f"quadrotor_rk4: kernel launch failed, cudaError_t {err}")
    LAUNCHES += 1
    return out


def stress_inputs(batch, device, seed, dtype=torch.float32):
    """States and inputs that test the kernel against the eager step:
    uniform random states with large angles (roll and yaw +-4 rad, pitch
    +-1.5), rates +-5 rad/s, thrust 0-20 N, torques +-0.5 N m; every eighth
    row's pitch within 1e-7 of +-pi/2, where the dynamics clamp cos(theta)
    to 1e-6. Returns ``(x (*batch, 12), u (*batch, 4), rows at the
    clamp)``."""
    rng = np.random.default_rng(seed)
    n = math.prod(batch)
    x = rng.uniform(-1.0, 1.0, (n, 12)) * [10, 10, 10, 5, 5, 5, 4, 1.5, 4, 5, 5, 5]
    near = np.arange(0, n, 8)
    x[near, 7] = rng.choice([-1, 1], near.size) * math.pi / 2 + rng.uniform(-1e-7, 1e-7,
                                                                               near.size)
    u = rng.uniform(-1.0, 1.0, (n, 4)) * [10, 0.5, 0.5, 0.5] + [10, 0, 0, 0]

    def tensor(a, width):
        return torch.as_tensor(a, dtype=dtype, device=device).reshape(*batch, width)

    return tensor(x, 12), tensor(u, 4), torch.as_tensor(near, device=device)


# the kernel's limit against the eager step, relative to |eager| + 1
TOLERANCE = {torch.float32: 1e-6, torch.float64: 1e-13}


def within(got, want):
    """Elementwise: ``|got - want| <= TOLERANCE (|want| + 1)``, or equal
    (infinities), or NaN in both."""
    gap = (got.double() - want.double()).abs()
    return ((gap <= TOLERANCE[want.dtype] * (want.double().abs() + 1)) | (got == want)
            | (got.isnan() & want.isnan()))
