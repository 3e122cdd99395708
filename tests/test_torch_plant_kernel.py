"""The quadrotor's RK4 plant kernel (``models/quadrotor_rk4.py``,
``csrc/quadrotor_rk4.cu``) and ``Model.step``'s choice between it and the
eager step.

On the CPU: the two cases the wrapper declines (CPU tensors, whatever they
hold, and everything autodiff can see: ``requires_grad`` under grad mode,
``jacfwd``, ``vmap``, forward-mode duals), ``Model.step`` equal to
``rk4_step(model.dynamics, ...)`` bit for bit on those calls, the rows the
kernel reads (through their strides) and what it refuses, the other models
without a fused step, and the ctypes signatures against the CUDA source. On
the card only (the ``card`` fixture skips elsewhere): the kernel against the
eager step in f32 and f64, on random states with large angles and pitches
at the clamp, on strided and broadcast operands and through ``rollout``,
and the errors it raises there. This file imports no JAX, so on the card it
runs as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_plant_kernel.py``.
"""

import collections
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.forward_ad as fwAD  # noqa: E402
from torch.func import jacfwd, vmap  # noqa: E402

import strided_tpu_torch.models as tm  # noqa: E402
from strided_tpu_torch import capture as cap  # noqa: E402
from strided_tpu_torch.entry import make_controller  # noqa: E402
from strided_tpu_torch.models import quadrotor_rk4 as qr  # noqa: E402
from strided_tpu_torch.mpc.rollout import rollout  # noqa: E402

DT = 0.02
BODY = dict(m=1.0, g=9.81, J=(0.01, 0.01, 0.02))  # quadrotor()'s defaults


def _inputs(batch=(5,), dtype=torch.float32, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1.0, 1.0, (*batch, 12)), dtype=dtype, device=device)
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (*batch, 4)) + [9.81, 0.0, 0.0, 0.0],
                        dtype=dtype, device=device)
    return x, u


def _case(name, device="cpu"):
    """``(x, u, dt)`` of the call ``name``."""
    x, u = _inputs(device=device)
    if name in ("cpu", "contiguous"):
        return x, u, DT
    if name in ("leading dims", "leading dims on the cpu"):
        return (*_inputs((3, 2), device=device), DT)
    if name == "float64":
        return (*_inputs(dtype=torch.float64, device=device), DT)
    if name == "u float64":
        return x, u.double(), DT
    if name == "float16":
        return x.half(), u.half(), DT
    if name == "x width 13":
        return torch.cat([x, x[:, :1]], -1), u, DT
    if name == "u width 3":
        return x, u[:, :3].contiguous(), DT
    if name == "u broadcast":
        return x, u[0], DT
    if name == "x broadcast":  # iLQR's line search starts from x0.expand(A, ...)
        return x[0].expand(3, 5, 12), u.expand(3, 5, 4).contiguous(), DT
    if name == "trajectory slice":  # rollout's us[..., t, :]
        return x, torch.cat([u, u, u], -1).reshape(5, 3, 4)[..., 1, :], DT
    if name == "no rows":
        return x[:0], u[:0], DT
    if name == "non-contiguous u":
        return x, torch.cat([u, u], -1)[:, ::2], DT
    if name == "non-contiguous x":
        return x.T.contiguous().T, u, DT
    if name in ("tensor dt", "bool dt"):
        return x, u, torch.tensor(DT) if name == "tensor dt" else True
    if name == "requires_grad":
        return x.requires_grad_(), u, DT
    raise KeyError(name)


# CPU calls: the wrapper declines each ("cpu", or "autodiff" for the last)
# and Model.step runs the eager step
DECLINED = ["cpu", "leading dims on the cpu", "float64", "non-contiguous u", "non-contiguous x",
            "tensor dt", "requires_grad"]
# calls the kernel takes on the card, each read where it lies where reshape can view it
TAKEN = ["contiguous", "leading dims", "float64", "non-contiguous u", "non-contiguous x",
         "u broadcast", "x broadcast", "trajectory slice", "no rows"]
# calls it refuses on the card
REFUSED = {"u float64": TypeError, "float16": TypeError, "x width 13": ValueError,
           "u width 3": ValueError, "tensor dt": TypeError, "bool dt": TypeError}


def _declines(call):
    """``(result, DECLINES gained, LAUNCHES gained)`` of ``call()``."""
    before, launches = collections.Counter(qr.DECLINES), qr.LAUNCHES
    out = call()
    return out, qr.DECLINES - before, qr.LAUNCHES - launches


@pytest.mark.parametrize("name", DECLINED)
def test_the_wrapper_declines_with_its_reason(name):
    x, u, dt = _case(name)
    reason = "autodiff" if name == "requires_grad" else "cpu"
    assert qr.decline_reason(x, u) == reason
    out, gained, launched = _declines(lambda: qr.rk4(x, u, dt, **BODY))
    assert out is None and gained == {reason: 1} and launched == 0


@pytest.mark.parametrize("name", DECLINED)
def test_model_step_is_the_eager_step_where_the_kernel_declines(name):
    model = tm.quadrotor()
    x, u, dt = _case(name)
    got, gained, launched = _declines(lambda: model.step(x, u, dt))
    assert sum(gained.values()) == 1 and launched == 0
    want = tm.rk4_step(model.dynamics, x, u, dt)
    assert torch.equal(got, want) and got.dtype == want.dtype
    assert got.requires_grad == want.requires_grad


def test_requires_grad_without_grad_mode_is_not_autodiff():
    x, u = _inputs()
    x.requires_grad_()
    with torch.no_grad():
        assert qr.decline_reason(x, u) == "cpu"
    assert qr.decline_reason(x, u) == "autodiff"
    assert qr.decline_reason(u, x) == "autodiff"  # either operand


@pytest.mark.parametrize("name", TAKEN)
def test_operands_are_the_rows_the_kernel_reads(name):
    """``operands`` gives the ``(rows, 12)`` and ``(rows, 4)`` views whose
    strides the kernel reads: the rows of the eager step's operands, in the
    caller's storage where they are evenly spaced (no copy)."""
    x, u, dt = _case(name)
    xr, ur = qr.operands(x, u, dt)
    want_u = u.expand(*x.shape[:-1], 4)
    assert torch.equal(xr, x.reshape(-1, 12)) and torch.equal(ur, want_u.reshape(-1, 4))
    assert xr.shape[0] == ur.shape[0] == x.numel() // 12
    if name in ("non-contiguous u", "trajectory slice"):
        assert ur.data_ptr() == u.data_ptr() and ur.stride() == (u.stride(0), u.stride(1))
    if name == "non-contiguous x":
        assert xr.data_ptr() == x.data_ptr() and xr.stride() == (1, 5)
    if name == "u broadcast":
        assert ur.data_ptr() == u.data_ptr() and ur.stride() == (0, 1)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_operands_refuses_what_the_kernel_does_not_compute(name):
    x, u, dt = _case(name)
    with pytest.raises(REFUSED[name], match="quadrotor_rk4"):
        qr.operands(x, u, dt)


def test_the_wrapper_raises_off_the_cpu_and_the_card():
    x, u = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="one CUDA device"):
        _declines(lambda: qr.rk4(x, u, DT, **BODY))
    assert qr.decline_reason(x, u) is None


def test_jacfwd_and_vmap_decline_and_match_the_eager_step():
    model = tm.quadrotor()
    x, u = _inputs((6,))
    eager = lambda a, b: tm.rk4_step(model.dynamics, a, b, DT)  # noqa: E731
    reasons = []

    def probe(a, b):
        reasons.append(qr.decline_reason(a, b))
        return model.step(a, b, DT)

    (A, B), gained, launched = _declines(lambda: model.linearize(x[0], u[0], DT))
    want_A, want_B = jacfwd(eager, argnums=(0, 1))(x[0], u[0])
    assert gained == {"autodiff": 1} and launched == 0
    assert torch.equal(A, want_A) and torch.equal(B, want_B)

    got, gained, launched = _declines(lambda: vmap(probe)(x, u))
    assert gained == {"autodiff": 1} and launched == 0 and reasons == ["autodiff"]
    assert torch.equal(got, vmap(eager)(x, u))

    reasons.clear()
    jacfwd(probe)(x[0], u[0])
    assert reasons == ["autodiff"]


def test_forward_mode_duals_decline_and_carry_their_tangent():
    model = tm.quadrotor()
    x, u = _inputs((4,))
    t = torch.ones_like(x)
    eager = lambda a: tm.rk4_step(model.dynamics, a, u, DT)  # noqa: E731
    with fwAD.dual_level():
        dual = fwAD.make_dual(x, t)
        assert qr.decline_reason(dual, u) == "autodiff"
        assert qr.decline_reason(x, u) == "cpu"  # a plain tensor inside the level
        got, gained, _ = _declines(lambda: model.step(dual, u, DT))
        got_primal, got_tangent = fwAD.unpack_dual(got)
        want_primal, want_tangent = fwAD.unpack_dual(eager(fwAD.make_dual(x, t)))
    assert gained == {"autodiff": 1}
    assert torch.equal(got_primal, want_primal) and torch.equal(got_tangent, want_tangent)


def test_the_controllers_linearisation_declines_once():
    _, gained, launched = _declines(lambda: make_controller(horizon=4, dt=DT, device="cpu"))
    assert gained == {"autodiff": 1} and launched == 0


def test_only_the_quadrotor_has_a_fused_step():
    others = (tm.simple_pendulum(), tm.double_pendulum(), tm.cartpole(), tm.unicycle(),
              tm.bicycle(), tm.Model("drift", 2, 1, lambda x, u: u))
    assert all(m.fused_step is None for m in others)
    fused = tm.quadrotor(m=2.0, g=9.5, Jx=0.02, Jy=0.03, Jz=0.04).fused_step
    assert fused.func is qr.rk4
    assert fused.keywords == dict(m=2.0, g=9.5, J=(0.02, 0.03, 0.04))
    assert tm.quadrotor().fused_step.keywords == BODY


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_argtypes_match_the_cuda_source(dtype):
    """``ARGTYPES`` against the parameters of ``strided_quadrotor_rk4_f32``
    and ``_f64`` as ``csrc/quadrotor_rk4.cu`` declares them: a pointer for
    each tensor and the stream (a plain int would cut it to 32 bits),
    64-bit strides and row count, scalars of the element type."""
    suffix, scalar = {torch.float32: ("f32", "float"), torch.float64: ("f64", "double")}[dtype]
    src = (Path(qr.__file__).parents[1] / "csrc" / "quadrotor_rk4.cu").read_text()
    params = re.search(rf'extern "C" int strided_quadrotor_rk4_{suffix}\((.*?)\)\s*\{{', src,
                       re.S).group(1)
    params = [" ".join(p.split()).rsplit(" ", 1) for p in params.split(",")]
    ctype = {f"const {scalar}*": ctypes.c_void_p, f"{scalar}*": ctypes.c_void_p,
             "void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             scalar: {"float": ctypes.c_float, "double": ctypes.c_double}[scalar]}
    assert [ctype[t] for t, _ in params] == qr.ARGTYPES[dtype]
    assert [n for _, n in params] == ["x", "x_row", "x_col", "u", "u_row", "u_col", "out",
                                      "rows", "inv_m", "g", "Jx", "Jy", "Jz", "half_dt", "dt",
                                      "sixth_dt", "stream"]


# ---- on the card only ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU version (chip_smoke.py "
                    "phase 18 runs these checks on the card)")
    return torch.device("cuda")


def _assert_close(got, want):
    ok = qr.within(got, want)
    gap = (got.double() - want.double()).abs()
    assert bool(ok.all()), f"{int((~ok).sum())} elements off, widest gap {gap[~ok].max()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [(1,), (257,), (16384,), (4, 64)])
def test_kernel_matches_the_eager_step_on_the_card(card, batch, dtype):
    model = tm.quadrotor()
    x, u, _ = qr.stress_inputs(batch, card, seed=sum(batch), dtype=dtype)
    launches = qr.LAUNCHES
    got = model.step(x, u, DT)
    want = tm.rk4_step(model.dynamics, x, u, DT)
    torch.cuda.synchronize()
    assert qr.LAUNCHES == launches + 1
    assert got.shape == want.shape and got.is_contiguous() and got.dtype == dtype
    _assert_close(got, want)


def test_kernel_takes_another_body_on_the_card(card):
    model = tm.quadrotor(m=1.7, g=9.7, Jx=0.013, Jy=0.011, Jz=0.023)
    x, u, _ = qr.stress_inputs((513,), card, seed=5)
    launches = qr.LAUNCHES
    got = model.step(x, u, 0.01)
    assert qr.LAUNCHES == launches + 1
    _assert_close(got, tm.rk4_step(model.dynamics, x, u, 0.01))


@pytest.mark.parametrize("name", TAKEN)
def test_kernel_reads_strided_and_broadcast_operands_on_the_card(card, name):
    model = tm.quadrotor()
    x, u, dt = _case(name, device=card)
    launches = qr.LAUNCHES
    got = model.step(x, u, dt)
    want = tm.rk4_step(model.dynamics, x, u, dt)
    assert qr.LAUNCHES == launches + (x.numel() > 0)
    assert got.shape == want.shape and got.is_contiguous()
    _assert_close(got, want)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_the_card_raises_on_what_the_kernel_does_not_take(card, name):
    x, u, dt = _case(name, device=card)
    with pytest.raises(REFUSED[name], match="quadrotor_rk4"):
        tm.quadrotor().step(x, u, dt)


def test_rollout_takes_the_kernel_each_step_on_the_card(card):
    model = tm.quadrotor()
    x, u, _ = qr.stress_inputs((64,), card, seed=7)
    us = (u[:, None, :] * torch.linspace(0.9, 1.1, 6, device=card)[:, None]).contiguous()
    x = x * 0.1
    launches = qr.LAUNCHES
    with cap.disable_capture():
        got = rollout(model, x, us, DT)
        want = rollout(tm.Model("eager", 12, 4, model.dynamics), x, us, DT)
    assert qr.LAUNCHES == launches + 6
    _assert_close(got, want)
