"""The plain reference against the port on the CPU, in f64: the plant, its
linearisation at hover, the condensed QP the reference forms itself, the
ADMM plan and the README's expressions."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.generators import engine_mix
from portbench.reference import strided_readme
from portbench.reference.quadrotor_mpc import QuadrotorMPC

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def port_controller(cfg):
    from strided_tpu_torch.entry import make_controller

    return make_controller(cfg["controller"]["horizon"], cfg["dt"], "cpu", torch.float64)


def test_condensed_qp_formed_alike():
    cfg = config("quadrotor_mpc")
    model, ctrl = port_controller(cfg)
    ref = QuadrotorMPC(cfg)
    assert ctrl.qp.rho == cfg["controller"]["rho"] and ctrl.admm_iters == ref.iters
    for mine, port in ((ref.M, ctrl.qp.M), (ref.K, ctrl.qp.K_lqr), (ref.S, ctrl.qp.solver)):
        np.testing.assert_allclose(mine.numpy(), port.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ref.lo.numpy()[:4], ctrl.u_min.numpy())
    np.testing.assert_allclose(ref.hi.numpy()[:4], ctrl.u_max.numpy())


def test_plant_step_alike():
    cfg = config("quadrotor_mpc")
    model, _ = port_controller(cfg)
    ref = QuadrotorMPC(cfg)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.5, 0.5, (32, 12)))
    u = torch.as_tensor(rng.uniform(-1, 12, (32, 4)))
    np.testing.assert_allclose(ref.step(x, u).numpy(), model.step(x, u, cfg["dt"]).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_first_input_alike():
    cfg = config("quadrotor_mpc")
    _, ctrl = port_controller(cfg)
    ref = QuadrotorMPC(cfg)
    x = torch.as_tensor(np.random.default_rng(1).uniform(-0.3, 0.3, (64, 12)))
    u, U = ctrl.control(x)
    np.testing.assert_allclose(ref.first_input(x).numpy(), u.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ref.plan(x).numpy(), U.reshape(64, -1).numpy(),
                               rtol=1e-9, atol=1e-9)
    assert ((ref.plan(x) == ref.lo) | (ref.plan(x) == ref.hi)).any()  # the bounds bite


@pytest.mark.parametrize("name", list(strided_readme.EXPRESSIONS))
def test_engine_spelling_against_reference(name):
    shape = (37, 37) if name in ("symmetrize", "scale_transpose", "broadcast") else (5, 6, 7, 8)
    if name == "permute_sum":
        shape = (6, 6, 6, 6)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    out = engine_mix.spellings()[name](x)
    g = strided_readme.gap(name, x, out)
    assert out.dtype == torch.float32
    assert g <= 1e-6
    if name in ("symmetrize", "scale_transpose", "permutedims"):
        assert g == 0.0
