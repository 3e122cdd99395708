"""The readers of the port's own spans (``port_spans.py`` and the four
metrics that use it): section times on a trace made by hand, host times
on given totals, and nothing on a port without the tracing switch."""

import types

import pytest

import strided_tpu_torch.utils as port_utils
from portbench import port_spans
from portbench.common import Trace
from portbench.run import reader

SECTIONS = {0: "qp.solve", 1: "model.step"}


@pytest.fixture(autouse=True)
def _tracing_off():
    """Loading a reader turns the port's tracing on; each test leaves it off."""
    yield
    port_utils.profiling.disable()
    port_utils.profiling.reset()


def _marker(section, end, s):
    return (f"void strided_section_marker<{section}, {end}>()", s, s + 1.0)


def _period(t):
    """One period at ``t`` us: the QP's work 2-12 within its markers, the
    plant's 16-22 (two overlapping kernels), a copy after both."""
    return [_marker(0, 0, t), ("fused_admm_kernel", t + 2, t + 10), ("gemm", t + 10, t + 12),
            _marker(0, 1, t + 13), _marker(1, 0, t + 14), ("add", t + 16, t + 20),
            ("mul", t + 18, t + 22), _marker(1, 1, t + 23), ("Memcpy DtoH", t + 25, t + 30)]


def _trace(ops, units=2):
    return Trace(ops, [], (0.0, 1000.0), units)


def test_section_time_is_the_union_between_the_markers_over_the_units():
    tr = _trace(_period(0.0) + _period(100.0))
    assert port_spans.section_ms(tr, "qp.solve", SECTIONS) == pytest.approx(0.010)
    assert port_spans.section_ms(tr, "model.step", SECTIONS) == pytest.approx(0.006)
    # the markers count in the busy time, not in a section's
    assert 0.010 + 0.006 < tr.busy_s() / tr.units * 1e3


def test_a_section_without_both_markers_reads_nothing():
    ops = [op for op in _period(0.0) if "<0, 1>" not in op[0]]
    assert port_spans.section_ms(_trace(ops), "qp.solve", SECTIONS) is None
    assert port_spans.section_ms(_trace(_period(0.0)), "engine.plan", SECTIONS) is None
    assert port_spans.section_ms(_trace(_period(0.0), units=0), "qp.solve", SECTIONS) is None


def test_host_time_is_the_mean_over_the_calls():
    totals = {"capture.replay": {"count": 4, "total_ns": 200_000, "self_ns": 50_000,
                                 "parents": {None: 4}}}
    assert port_spans.host_us(totals, "capture.replay") == pytest.approx(50.0)
    assert port_spans.host_us(totals, "engine.plan") is None


class _Port:
    def __init__(self, totals):
        self._totals = totals

    def totals(self):
        return self._totals

    def sections(self):
        return SECTIONS


@pytest.mark.parametrize("name,want", [("qp_step_ms.mpc", 0.010), ("plant_step_ms.mpc", 0.006),
                                       ("replay_host_us.mpc", 30.0),
                                       ("plan_host_us.engine", 150.0)])
def test_each_reader_on_a_port_with_spans(monkeypatch, name, want):
    read = reader(name)
    assert port_utils.profiling.enabled()  # switched on when the reader was loaded
    totals = {"capture.replay": {"count": 2, "total_ns": 60_000, "self_ns": 0, "parents": {}},
              "engine.plan": {"count": 3, "total_ns": 450_000, "self_ns": 0, "parents": {}}}
    monkeypatch.setitem(read.__globals__, "PORT", _Port(totals))
    assert read(_trace(_period(0.0) + _period(100.0))) == pytest.approx(want)


@pytest.mark.parametrize("name", ["qp_step_ms.mpc", "plant_step_ms.mpc", "replay_host_us.mpc",
                                  "plan_host_us.engine"])
def test_each_reader_gives_none_on_a_port_without_the_switch(monkeypatch, name):
    old = types.SimpleNamespace(annotate=port_utils.profiling.annotate,
                                trace=port_utils.profiling.trace)
    monkeypatch.setattr(port_utils, "profiling", old)
    read = reader(name)
    assert read.__globals__["PORT"] is None
    assert read(_trace(_period(0.0))) is None
