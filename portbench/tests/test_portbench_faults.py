"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the look
for a card is the command's, and is skipped), with the port's timed path
replaced by one with a fault: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced (a
next state; the thrust, seen only through a velocity; an engine output; the broadcast without its sine term, or with
``sin(A)`` for ``sin(A*A)``, on inputs as wide as the card cell's). A
sound run of the same size is judged correct."""

import pytest
import torch

import strided_tpu_torch.entry as entry
from portbench.generators import engine_mix, mpc_loop
from portbench.run import judge
from portbench.tests.helpers import tiny

SEED = 2 ** 31 + 17


def _fleet(monkeypatch, fault):
    real = entry.make_step

    def make_step(model, ctrl, dt):
        step = real(model, ctrl, dt)
        if fault is None:
            return step
        return lambda x: fault(x, step(x))

    monkeypatch.setattr(entry, "make_step", make_step)
    cell = tiny("quadrotor_mpc.fleet16k")
    return judge(cell, mpc_loop.run(cell, SEED, 0.4, False, device="cpu"))[0]


def _altered(x, xn):
    xn = xn.clone()
    xn[3, 9] += 0.05
    return xn


def _half(x, xn):
    xn = xn.clone()
    xn[x.shape[0] // 2:] = x[x.shape[0] // 2:]
    return xn


def _thrust(x, xn):
    """A thrust 0.01 N off on one quadrotor, as the step shows it: its
    vertical velocity off by 0.01 dt / m (hover is level)."""
    xn = xn.clone()
    xn[5, 5] += 0.01 * 0.02 / 1.0
    return xn


FLEET_FAULTS = {"state unchanged": lambda x, xn: x.clone(), "half the batch": _half,
                "answer altered": _altered, "thrust altered": _thrust}


def test_fleet_sound_run_is_correct(monkeypatch):
    assert _fleet(monkeypatch, None)


@pytest.mark.parametrize("fault", list(FLEET_FAULTS))
def test_fleet_fault_is_caught(monkeypatch, fault):
    assert not _fleet(monkeypatch, FLEET_FAULTS[fault])


# the widest inputs of the card cell: randn at 8192^2 reaches about 5.6
WIDEST = 5.6


def _engine(monkeypatch, which, fault):
    real, real_operands = engine_mix.spellings, engine_mix.operands

    def spellings():
        fns = real()
        if fault is not None:
            f = fns[which]
            fns[which] = lambda x: fault(x, f(x))
        return fns

    def operands(*args, **kw):
        ops = real_operands(*args, **kw)
        for x in ops["broadcast"]:  # A exp(-2A) reaches 4e5 here
            x.view(-1)[:2] = torch.tensor([-WIDEST, WIDEST])
        return ops

    monkeypatch.setattr(engine_mix, "spellings", spellings)
    monkeypatch.setattr(engine_mix, "operands", operands)
    cell = tiny("strided_readme.card_scale")
    return judge(cell, engine_mix.run(cell, SEED, 0.3, False, device="cpu"))[0]


def _engine_half(x, y):
    y = y.clone()
    y[y.shape[0] // 2:] = 0
    return y


def _engine_altered(x, y):
    """One output element off by a thousandth of its size (plus one)."""
    y = y.clone()
    y.view(-1)[7] += 1e-3 * (y.view(-1)[7].abs() + 1)
    return y


ENGINE_FAULTS = {"state unchanged": lambda x, y: x.clone(), "half the batch": _engine_half,
                 "answer altered": _engine_altered}
BROADCAST_FAULTS = {"sine dropped": lambda x, y: x * torch.exp(-2 * x),
                    "sin(A) for sin(A*A)": lambda x, y: x * torch.exp(-2 * x) + torch.sin(x)}


def test_engine_sound_run_is_correct(monkeypatch):
    assert _engine(monkeypatch, None, None)


@pytest.mark.parametrize("which", ["symmetrize", "broadcast", "permute_sum"])
@pytest.mark.parametrize("fault", list(ENGINE_FAULTS))
def test_engine_fault_is_caught(monkeypatch, which, fault):
    assert not _engine(monkeypatch, which, ENGINE_FAULTS[fault])


@pytest.mark.parametrize("fault", list(BROADCAST_FAULTS))
def test_broadcast_term_fault_is_caught(monkeypatch, fault):
    assert not _engine(monkeypatch, "broadcast", BROADCAST_FAULTS[fault])
