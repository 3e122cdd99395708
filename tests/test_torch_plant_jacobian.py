"""The Jacobians of the quadrotor's RK4 step as one kernel
(``models/quadrotor_jac.py``, ``csrc/quadrotor_jac.cu``) and
``base.linearize``'s choice between it and ``vmap(jacfwd)``.

On the CPU: the two cases the wrapper declines (CPU tensors and everything
autodiff can see), ``base.linearize`` equal to ``vmap(jacfwd)`` of the
eager step bit for bit on those calls, the points the kernel reads (through
their strides) and what it refuses, the models without a fused
linearization, the one-point ``Model.linearize`` kept on ``jacfwd``, and
the ctypes signatures against the CUDA source. On the card only (the
``card`` fixture skips elsewhere): the kernel against ``jacfwd`` in f64 and
f32 on random states with large angles and pitches at the clamp, on the
iteration's trajectory slice (at the main path's 4096 x 50 too), on a
broadcast input and on another body, f32 element by element within
``quadrotor_rk4.TOLERANCE`` of f32 ``jacfwd``; and the captured iLQR step
launching it at warm-up and capture alone. This file
imports no JAX, so on the card it runs as ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_plant_jacobian.py``.
"""

import collections
import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import jacfwd, vmap  # noqa: E402

import strided_tpu_torch.models as tm  # noqa: E402
from strided_tpu_torch import capture as cap  # noqa: E402
from strided_tpu_torch.entry import make_controller  # noqa: E402
from strided_tpu_torch.entry import make_ilqr_controller, make_ilqr_step  # noqa: E402
from strided_tpu_torch.models import quadrotor_jac as qj  # noqa: E402
from strided_tpu_torch.models import quadrotor_rk4 as qr  # noqa: E402

DT = 0.02
OTHER = dict(m=1.7, g=9.7, Jx=0.013, Jy=0.011, Jz=0.023)


def _inputs(batch=(5,), dtype=torch.float64, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1.0, 1.0, (*batch, 12)), dtype=dtype, device=device)
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (*batch, 4)) + [9.81, 0.0, 0.0, 0.0],
                        dtype=dtype, device=device)
    return x, u


def _case(name, device="cpu"):
    """``(xs, us)`` of the call ``name``."""
    if name == "points":
        return _inputs(device=device)
    if name == "float32":
        return _inputs(dtype=torch.float32, device=device)
    if name == "trajectory slice":  # the iteration's xs[..., :-1, :] of (batch, T + 1, 12)
        xs, _ = _inputs((3, 5), device=device)
        us = _inputs((3, 4), seed=1, device=device)[1]
        return xs[:, :-1], us
    if name == "u broadcast":
        xs, us = _inputs((6,), device=device)
        return xs, us[0].expand(6, 4)
    if name == "leading dims":
        return _inputs((2, 3, 4), device=device)
    if name == "one point":
        xs, us = _inputs((1,), device=device)
        return xs[0], us[0]
    raise KeyError(name)


CASES = ["points", "float32", "trajectory slice", "u broadcast", "leading dims", "one point"]


def _eager(model, xs, us, dt=DT):
    """``vmap(jacfwd)`` of the eager step: ``base.linearize`` on the model
    without its kernels (``us`` materialized: on the card ``jacfwd`` refuses
    a dual of a broadcast tensor)."""
    plain = dataclasses.replace(model, fused_step=None, fused_linearize=None)
    return tm.linearize(plain, xs, us.contiguous(), dt)


def _counted(call):
    """``(result, DECLINES gained, LAUNCHES gained)`` of ``call()``."""
    before, launches = collections.Counter(qj.DECLINES), qj.LAUNCHES
    out = call()
    return out, qj.DECLINES - before, qj.LAUNCHES - launches


@pytest.mark.parametrize("name", CASES)
def test_linearize_declines_on_the_cpu_and_is_vmap_jacfwd(name):
    model = tm.quadrotor()
    xs, us = _case(name)
    assert qr.decline_reason(xs, us) == "cpu"
    (A, B), gained, launched = _counted(lambda: tm.linearize(model, xs, us, DT))
    assert gained == {"cpu": 1} and launched == 0
    want_A, want_B = _eager(model, xs, us)
    assert torch.equal(A, want_A) and torch.equal(B, want_B)
    assert A.dtype == B.dtype == xs.dtype
    assert A.shape == (*xs.shape[:-1], 12, 12) and B.shape == (*xs.shape[:-1], 12, 4)


def test_linearize_declines_under_autodiff_and_is_vmap_jacfwd():
    model = tm.quadrotor(**OTHER)
    xs, us = _inputs((4, 3))
    want = _eager(model, xs, us)

    (A, B), gained, launched = _counted(
        lambda: vmap(lambda x, u: tm.linearize(model, x, u, DT))(xs, us))
    assert gained == {"autodiff": 1} and launched == 0
    assert torch.equal(A, want[0]) and torch.equal(B, want[1])

    xg = xs.clone().requires_grad_()
    (A, B), gained, launched = _counted(lambda: tm.linearize(model, xg, us, DT))
    assert gained == {"autodiff": 1} and launched == 0
    assert torch.equal(A.detach(), want[0]) and torch.equal(B.detach(), want[1])


def test_the_iteration_declines_on_the_cpu_once_an_iteration():
    """``ILQRMPC.control`` (two iterations a period) asks the kernel once an
    iteration, through ``base.linearize``; the CPU's plain version runs."""
    model, ctrl = make_ilqr_controller(6, DT, "cpu", iters=2)
    x = torch.as_tensor(np.random.default_rng(3).uniform(-0.3, 0.3, (5, 12)),
                        dtype=torch.float32)
    _, gained, launched = _counted(lambda: ctrl.control(x, ctrl.initial_plan((5,))))
    assert gained == {"cpu": 2} and launched == 0


def test_the_controllers_one_point_linearisation_stays_on_jacfwd():
    """``make_controller`` linearizes once at hover through
    ``Model.linearize``: ``jacfwd`` of the step, which never asks the
    Jacobian kernel (and declines the plant kernel, as before)."""
    plant = collections.Counter(qr.DECLINES)
    _, gained, launched = _counted(lambda: make_controller(horizon=4, dt=DT, device="cpu"))
    assert gained == {} and launched == 0
    assert qr.DECLINES - plant == {"autodiff": 1}
    model = tm.quadrotor()
    x, u = tm.hover_state(torch.float64, "cpu"), tm.hover_input(dtype=torch.float64,
                                                                 device="cpu")
    (A, B), gained, _ = _counted(lambda: model.linearize(x, u, DT))
    want_A, want_B = jacfwd(lambda a, b: tm.rk4_step(model.dynamics, a, b, DT),
                            argnums=(0, 1))(x, u)
    assert gained == {} and torch.equal(A, want_A) and torch.equal(B, want_B)


def test_only_the_quadrotor_has_a_fused_linearization():
    others = (tm.simple_pendulum(), tm.double_pendulum(), tm.cartpole(), tm.unicycle(),
              tm.bicycle(), tm.Model("drift", 2, 1, lambda x, u: u))
    assert all(m.fused_linearize is None for m in others)
    fused = tm.quadrotor(**OTHER).fused_linearize
    assert fused.func is qj.jacobians
    assert fused.keywords == dict(m=1.7, J=(0.013, 0.011, 0.023))
    assert tm.quadrotor().fused_linearize.keywords == dict(m=1.0, J=(0.01, 0.01, 0.02))


def test_models_without_it_never_reach_the_kernel():
    cart = tm.cartpole()
    xs = torch.zeros(8, 10, 4, dtype=torch.float64)
    us = torch.zeros(8, 10, 1, dtype=torch.float64)
    (A, B), gained, launched = _counted(lambda: tm.linearize(cart, xs, us, DT))
    assert gained == {} and launched == 0
    assert A.shape == (8, 10, 4, 4) and B.shape == (8, 10, 4, 1)


@pytest.mark.parametrize("name", CASES)
def test_operands_are_the_points_the_kernel_reads(name):
    """``operands`` gives the ``(outer, inner, 12)`` and ``(outer, inner,
    4)`` views whose strides the kernel reads: the points of the batched
    linearization, in the caller's storage wherever the last batch dim
    stays a dim of its own (no copy)."""
    xs, us = _case(name)
    x3, u3 = qj.operands(xs, us, DT)
    want_u = us.expand(*xs.shape[:-1], 4)
    assert torch.equal(x3.reshape(-1, 12), xs.reshape(-1, 12))
    assert torch.equal(u3.reshape(-1, 4), want_u.reshape(-1, 4))
    assert x3.shape[:2] == u3.shape[:2] and x3.shape[0] * x3.shape[1] == xs.numel() // 12
    if name == "trajectory slice":
        assert x3.data_ptr() == xs.data_ptr() and x3.stride() == (60, 12, 1)
    if name == "u broadcast":
        assert u3.data_ptr() == us.data_ptr() and u3.stride()[1:] == (0, 1)
    if name == "leading dims":
        assert x3.shape == (6, 4, 12) and x3.data_ptr() == xs.data_ptr()


@pytest.mark.parametrize("shape", [(0, 12), (3, 0, 12), (0, 5, 12)])
def test_operands_of_no_points(shape):
    xs = torch.zeros(shape)
    x3, u3 = qj.operands(xs, torch.zeros(4), DT)
    assert x3.numel() == u3.numel() == 0 and x3.shape[-1] == 12 and u3.shape[-1] == 4


@pytest.mark.parametrize("name,error", [("u float32", TypeError), ("float16", TypeError),
                                        ("x width 13", ValueError), ("u width 3", ValueError),
                                        ("tensor dt", TypeError)])
def test_operands_refuses_what_the_kernel_does_not_compute(name, error):
    xs, us = _inputs()
    dt = DT
    if name == "u float32":
        us = us.float()
    elif name == "float16":
        xs, us = xs.half(), us.half()
    elif name == "x width 13":
        xs = torch.cat([xs, xs[:, :1]], -1)
    elif name == "u width 3":
        us = us[:, :3]
    else:
        dt = torch.tensor(DT)
    with pytest.raises(error, match="quadrotor_rk4"):
        qj.operands(xs, us, dt)


def test_the_wrapper_raises_off_the_cpu_and_the_card():
    xs, us = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="one CUDA device"):
        qj.jacobians(xs, us, DT, m=1.0, J=(0.01, 0.01, 0.02))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_argtypes_match_the_cuda_source(dtype):
    """``ARGTYPES`` against the parameters of ``strided_quadrotor_jac_f32``
    and ``_f64`` as ``csrc/quadrotor_jac.cu`` declares them: a pointer for
    each tensor and the stream, 64-bit strides and counts, scalars of the
    element type."""
    suffix, scalar = {torch.float32: ("f32", "float"), torch.float64: ("f64", "double")}[dtype]
    src = (Path(qj.__file__).parents[1] / "csrc" / "quadrotor_jac.cu").read_text()
    params = re.search(rf'extern "C" int strided_quadrotor_jac_{suffix}\((.*?)\)\s*\{{', src,
                       re.S).group(1)
    params = [" ".join(p.split()).rsplit(" ", 1) for p in params.split(",")]
    ctype = {f"const {scalar}*": ctypes.c_void_p, f"{scalar}*": ctypes.c_void_p,
             "void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             scalar: {"float": ctypes.c_float, "double": ctypes.c_double}[scalar]}
    assert [ctype[t] for t, _ in params] == qj.ARGTYPES[dtype]
    assert [n for _, n in params] == ["x", "x_outer", "x_row", "x_col", "u", "u_outer", "u_row",
                                      "u_col", "A", "B", "outer", "inner", "inv_m", "Jx", "Jy",
                                      "Jz", "half_dt", "dt", "sixth_dt", "stream"]


# ---- on the card only ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU version (chip_smoke.py "
                    "phase 19 runs these checks on the card)")
    return torch.device("cuda")


def _gap(got, want):
    """Widest ``|got - want| / (|want| + 1)``: equal values (infinities) and
    NaN in both count as no gap, a NaN in one alone as an infinite one."""
    gap = (got.double() - want.double()).abs() / (want.double().abs() + 1)
    same = (got == want) | (got.isnan() & want.isnan())
    return gap.masked_fill(same, 0).nan_to_num(torch.inf).max().item()


def _at_clamp(shape, near):
    """``quadrotor_rk4.stress_inputs``'s rows at the clamp (flat indices
    ``near``) as a mask of the batch ``shape``."""
    mask = torch.zeros(int(np.prod(shape)), dtype=torch.bool, device=near.device)
    mask[near] = True
    return mask.reshape(shape)


def _rows(name, card, dtype):
    """``(model, xs, us, dt, at_clamp)`` of the card's case ``name`` on
    ``quadrotor_rk4.stress_inputs`` rows (every eighth pitch within 1e-7 of
    +-pi/2, where the clamp engages), ``at_clamp`` the mask of those rows
    over ``xs``'s batch."""
    model, dt = tm.quadrotor(), DT
    if name in ("trajectory slice", "main path"):
        # the iteration's xs[:, :-1] of a (batch, T + 1, 12) trajectory; on
        # the main path (4096 x 50) us is its own contiguous (batch, T, 4)
        batch = 4096 if name == "main path" else 64
        xs, us, near = qr.stress_inputs((batch, 51), card, seed=51 + batch, dtype=dtype)
        at_clamp = _at_clamp((batch, 51), near)[:, :-1]
        us = us[:, :-1].contiguous() if name == "main path" else us[:, 1:]
        return model, xs[:, :-1], us, dt, at_clamp
    xs, us, near = qr.stress_inputs((4096,), card, seed=27, dtype=dtype)
    at_clamp = _at_clamp((4096,), near)
    if name == "u broadcast":
        return model, xs, us[3].expand(4096, 4), dt, at_clamp
    if name == "another body":
        return tm.quadrotor(**OTHER), xs, us, 0.01, at_clamp
    return model, xs, us, dt, at_clamp


CARD_CASES = ["points", "trajectory slice", "main path", "u broadcast", "another body"]


@pytest.mark.parametrize("name", CARD_CASES)
def test_f64_kernel_matches_jacfwd_on_the_card(card, name):
    model, xs, us, dt, _ = _rows(name, card, torch.float64)
    launches = qj.LAUNCHES
    A, B = tm.linearize(model, xs, us, dt)
    want_A, want_B = _eager(model, xs, us, dt)
    assert qj.LAUNCHES == launches + 1
    assert A.shape == want_A.shape and B.shape == want_B.shape
    assert A.is_contiguous() and B.is_contiguous() and A.dtype == B.dtype == torch.float64
    assert _gap(A, want_A) <= 1e-12 and _gap(B, want_B) <= 1e-12


@pytest.mark.parametrize("name", CARD_CASES)
def test_f32_kernel_is_as_accurate_as_jacfwd_on_the_card(card, name):
    """Every element within ``quadrotor_rk4.TOLERANCE`` (|want| + 1) of f32
    ``jacfwd`` on the same rows; and on the rows at the clamp, where f32
    rounding is amplified a millionfold, no less accurate than the path it
    replaces: the kernel's widest gap to f64 ``jacfwd`` there at most twice
    f32 ``jacfwd``'s."""
    model, xs, us, dt, at_clamp = _rows(name, card, torch.float32)
    launches = qj.LAUNCHES
    A, B = tm.linearize(model, xs, us, dt)
    assert qj.LAUNCHES == launches + 1 and A.dtype == B.dtype == torch.float32
    plain_A, plain_B = _eager(model, xs, us, dt)
    want_A, want_B = _eager(model, xs.double(), us.double(), dt)
    assert at_clamp.any() and not at_clamp.all()
    for got, plain, want in ((A, plain_A, want_A), (B, plain_B, want_B)):
        assert got.shape == plain.shape and bool(qr.within(got, plain).all())
        assert _gap(got[at_clamp], want[at_clamp]) <= 2 * _gap(plain[at_clamp], want[at_clamp])


def test_the_captured_ilqr_step_launches_it_at_warm_up_and_capture_alone(card):
    model, ctrl = make_ilqr_controller(50, DT, card)
    step = make_ilqr_step(model, ctrl, DT)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3, (256, 12)),
                        dtype=torch.float32, device=card)
    plan = ctrl.initial_plan((256,))
    launches = qj.LAUNCHES
    first = step(x, plan)
    at_capture = qj.LAUNCHES - launches
    for _ in range(3):
        step(x, plan)
    torch.cuda.synchronize()
    assert at_capture == 2 and qj.LAUNCHES == launches + 2
    with cap.disable_capture():
        eager = step(x, plan)
    assert qj.LAUNCHES == launches + 3
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
