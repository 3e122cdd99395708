"""The iLQR configuration's cell and ``quadrotor_mpc.fleet256`` on the CPU at
tiny size: both run correct; the iLQR reference loads nothing of the port;
a run whose timed iLQR step is broken comes out not correct (the state
returned unchanged, the warm start not shifted, the feedback gains dropped,
the plan not updated);
the readers of the iLQR spans on a trace made by hand, and on a port
without them."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import strided_tpu_torch.utils as port_utils
from portbench.common import Trace
from portbench.generators import ilqr_loop, mpc_loop
from portbench.run import judge, reader
from portbench.tests.helpers import tiny
from strided_tpu_torch.mpc import ILQRMPC

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 29
ilqr_mod = importlib.import_module("strided_tpu_torch.mpc.ilqr")


def _ilqr(monkeypatch, fault=None):
    real = ilqr_loop.make_ilqr_step

    def make_step(model, ctrl, dt):
        step = real(model, ctrl, dt)
        if fault is None:
            return step
        return lambda x, plan: fault(x, plan, step(x, plan))

    monkeypatch.setattr(ilqr_loop, "make_ilqr_step", make_step)
    cell = tiny("quadrotor_ilqr.fleet4k")
    return judge(cell, ilqr_loop.run(cell, SEED, 0.4, False, device="cpu"))[0]


def test_ilqr_cell_sound_run_is_correct(monkeypatch):
    assert _ilqr(monkeypatch)


def test_fleet256_sound_run_is_correct():
    cell = tiny("quadrotor_mpc.fleet256")
    assert judge(cell, mpc_loop.run(cell, SEED, 0.4, False, device="cpu"))[0]


def test_state_unchanged_is_caught(monkeypatch):
    assert not _ilqr(monkeypatch, lambda x, plan, out: (x.clone(), out[1]))


def test_warm_start_not_shifted_is_caught(monkeypatch):
    monkeypatch.setattr(ILQRMPC, "shift", staticmethod(lambda plan: plan))
    assert not _ilqr(monkeypatch)


def test_feedback_gains_dropped_is_caught(monkeypatch):
    real = ilqr_mod._forward

    def feedforward_only(model, x0, xs, us, ks, Ks, *args):
        return real(model, x0, xs, us, ks, torch.zeros_like(Ks), *args)

    monkeypatch.setattr(ilqr_mod, "_forward", feedforward_only)
    assert not _ilqr(monkeypatch)


@pytest.mark.parametrize("handed_back", [
    lambda plan, out: plan,  # the plan it was handed
    lambda plan, out: ILQRMPC.shift(plan),  # the warm start it began from
    # only the applied stage written into the warm start
    lambda plan, out: torch.cat([out[1][:, :1], ILQRMPC.shift(plan)[:, 1:]], dim=1),
], ids=["plan handed in", "warm start", "first stage only"])
def test_plan_not_updated_is_caught(monkeypatch, handed_back):
    """The next states are right, the plan carried to the next period is
    not: the reference starts from that plan too, so only ``plan_gap``
    sees it."""
    assert not _ilqr(monkeypatch, lambda x, plan, out: (out[0], handed_back(plan, out)))


def test_ilqr_reference_loads_nothing_of_the_port():
    code = ("import sys, portbench.reference.quadrotor_ilqr\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'strided_tpu_torch', 'strided_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout.strip()
    assert out == "[]"


SECTIONS = {0: "ilqr.linearize", 1: "ilqr.backward", 2: "ilqr.forward", 3: "model.step"}


@pytest.fixture
def _tracing_off():
    """Loading a reader turns the port's tracing on; each test leaves it off."""
    yield
    port_utils.profiling.disable()
    port_utils.profiling.reset()


def _marker(section, end, s):
    return (f"void strided_section_marker<{section}, {end}>()", s, s + 1.0)


def _period(t):
    """One period at ``t`` us: linearize 2-10, the sweep 14-17, the line
    search 20-30 with a plant step nested in it (its markers no work)."""
    return [_marker(0, 0, t), ("vectorized_elementwise", t + 2, t + 10), _marker(0, 1, t + 11),
            _marker(1, 0, t + 12), ("gemm", t + 14, t + 17), _marker(1, 1, t + 18),
            _marker(2, 0, t + 19), ("add", t + 20, t + 22), _marker(3, 0, t + 22),
            ("quadrotor_rk4_kernel", t + 23, t + 30), _marker(3, 1, t + 30),
            _marker(2, 1, t + 31)]


class _Port:
    def totals(self):
        return {}

    def sections(self):
        return SECTIONS


@pytest.mark.usefixtures("_tracing_off")
@pytest.mark.parametrize("name,want", [("linearize_ms.ilqr", 0.008), ("backward_ms.ilqr", 0.003),
                                       ("forward_ms.ilqr", 0.009)])
def test_each_ilqr_reader_on_a_port_with_spans(monkeypatch, name, want):
    read = reader(name)
    assert port_utils.profiling.enabled()
    monkeypatch.setitem(read.__globals__, "PORT", _Port())
    trace = Trace(_period(0.0) + _period(100.0), [], (0.0, 1000.0), 2)
    assert read(trace) == pytest.approx(want)


@pytest.mark.usefixtures("_tracing_off")
@pytest.mark.parametrize("name", ["linearize_ms.ilqr", "backward_ms.ilqr", "forward_ms.ilqr"])
def test_each_ilqr_reader_gives_none_where_the_port_has_no_such_span(monkeypatch, name):
    read = reader(name)
    monkeypatch.setitem(read.__globals__, "PORT", None)
    assert read(Trace(_period(0.0), [], (0.0, 1000.0), 1)) is None
    # a port with markers but none of these spans, as the parent's
    monkeypatch.setitem(read.__globals__, "PORT", type("P", (), {
        "sections": staticmethod(lambda: {0: "qp.solve", 1: "model.step"})})())
    assert read(Trace(_period(0.0), [], (0.0, 1000.0), 1)) is None
