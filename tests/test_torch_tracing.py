"""The port's spans (``strided_tpu_torch/utils/profiling.py``) on the CPU:
the null span with tracing off, the totals with it on, the profiler's
timeline, the section markers that only ``capture.py``'s own capture gets,
the tracing switch in the capture key, and the spans at the layer
boundaries the benchmark reads."""

import json
import os
import re
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

import strided_tpu_torch as stt
from strided_tpu_torch import capture as cap
from strided_tpu_torch import entry as tentry
from strided_tpu_torch.core import executor_cuda
from strided_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Each test starts with tracing off, no totals and no marker ids, and
    leaves them so."""
    saved = dict(profiling._section_ids)
    profiling.disable()
    profiling.reset()
    profiling._section_ids.clear()
    yield
    profiling.disable()
    profiling.reset()
    profiling._section_ids.clear()
    profiling._section_ids.update(saved)


def _boom(*_a, **_k):
    raise AssertionError("called with tracing off")


def _clock(monkeypatch, ticks):
    """Replace the spans' clock by one that returns ``ticks`` in turn."""
    it = iter(ticks)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(it)))


def _markers(monkeypatch, capturing=True):
    """Record the markers instead of launching them; the stream 'captures'
    when ``capturing``."""
    marks = []
    monkeypatch.setattr(profiling, "_mark", lambda sid, end: marks.append((sid, end)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    return marks


# ---- the span ----

def test_off_is_the_shared_null_context_with_no_clock_and_no_torch_op(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", _boom)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=_boom))
    a, b = profiling.annotate("a"), profiling.annotate("b")
    assert a is b is profiling._NULL
    with profiling.annotate("capture.replay"):
        with profiling.annotate("capture.launch"):
            pass
    with pytest.raises(ValueError, match="passes on"):
        with profiling.annotate("capture.launch"):
            raise ValueError("passes on")
    assert profiling.totals() == {}


def test_on_gives_count_total_self_and_parent(monkeypatch):
    profiling.enable()
    # outer 0..100 holds inner 10..40 and inner 50..60; then outer alone 200..205
    _clock(monkeypatch, [0, 10, 40, 50, 60, 100, 200, 205])
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            pass
        with profiling.annotate("inner"):
            pass
    with profiling.annotate("outer"):
        pass
    t = profiling.totals()
    assert t["outer"] == {"count": 2, "total_ns": 105, "self_ns": 65, "parents": {None: 2}}
    assert t["inner"] == {"count": 2, "total_ns": 40, "self_ns": 40, "parents": {"outer": 2}}
    profiling.reset()
    assert profiling.totals() == {}


@pytest.mark.parametrize("on", [False, True])
def test_torchs_profiler_flag_picks_the_profiler_range(monkeypatch, on):
    """The span asks torch's Python-level flag, not a call into torch,
    whether a profiler runs; under one it is a ``record_function`` range
    (with tracing on, inside the span that keeps it out of the totals)."""
    ranges = []

    class _Range:
        def __init__(self, name):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", _boom)
    monkeypatch.setattr(profiling._torch_profiler, "_is_profiler_enabled", True)
    if on:
        profiling.enable()
    with profiling.annotate("engine.plan"):
        pass
    assert ranges == ["engine.plan"]
    assert profiling.totals() == {}


def test_annotated_makes_each_call_a_span(monkeypatch):
    @profiling.annotated("engine.launch")
    def launch(a, *, b=1):
        """doc"""
        with profiling.annotate("inner"):
            return a + b

    assert launch.__name__ == "launch" and launch.__doc__ == "doc"
    assert launch(1, b=2) == 3
    profiling.enable()
    _clock(monkeypatch, [0, 2, 5, 10])
    assert launch(2) == 3
    t = profiling.totals()
    assert t["engine.launch"] == {"count": 1, "total_ns": 10, "self_ns": 7, "parents": {None: 1}}
    assert t["inner"]["parents"] == {"engine.launch": 1}


def test_rename_counts_the_span_under_its_new_name(monkeypatch):
    """A capture's miss: the span opened as ``capture.replay`` is counted as
    ``capture.miss``; a null span takes no name."""
    profiling.rename(profiling.annotate("capture.replay"), "capture.miss")
    profiling.enable()
    _clock(monkeypatch, [0, 1, 3, 4])
    with profiling.annotate("capture.replay") as span:
        with profiling.annotate("capture.signature"):
            pass
        profiling.rename(span, "capture.miss")
    t = profiling.totals()
    assert "capture.replay" not in t
    assert t["capture.miss"] == {"count": 1, "total_ns": 4, "self_ns": 2, "parents": {None: 1}}
    assert t["capture.signature"]["count"] == 1


def test_switch_and_totals_kept_after_disable(monkeypatch):
    assert not profiling.enabled()
    profiling.enable()
    assert profiling.enabled()
    _clock(monkeypatch, [0, 7])
    with profiling.annotate("a"):
        pass
    profiling.disable()
    assert profiling.annotate("a") is profiling._NULL
    assert profiling.totals()["a"]["total_ns"] == 7


@pytest.mark.parametrize("on", [False, True])
def test_under_the_profiler_spans_reach_the_chrome_trace_and_not_the_totals(tmp_path, on):
    if on:
        profiling.enable()
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("engine.plan"):
            with profiling.annotate("engine.launch"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"engine.plan", "engine.launch"} <= names
    assert profiling.totals() == {}


def test_threads_lose_no_count():
    """Spans closed on many threads at once, with the interpreter switching
    threads as often as it can: every call is counted, each under its own
    thread's parent."""
    profiling.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with profiling.annotate("outer"):
                    with profiling.annotate("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    t = profiling.totals()
    assert t["outer"]["count"] == t["inner"]["count"] == 32 * 500
    assert t["inner"]["parents"] == {"outer": 32 * 500}


# ---- the section markers ----

def test_markers_inside_the_ports_own_capture(monkeypatch):
    profiling.enable()
    marks = _markers(monkeypatch)
    with profiling.own_capture():
        with profiling.annotate("qp.solve"):
            pass
        with profiling.annotate("model.step"):
            with profiling.annotate("qp.solve"):
                pass
    assert marks == [(0, 0), (0, 1), (1, 0), (0, 0), (0, 1), (1, 1)]
    assert profiling.sections() == {0: "qp.solve", 1: "model.step"}
    assert profiling.totals()["qp.solve"]["parents"] == {None: 1, "model.step": 1}


@pytest.mark.parametrize("case", ["callers_graph", "warm_up", "tracing_off"])
def test_no_marker_outside_the_ports_own_capture(monkeypatch, case):
    """A caller's own graph (capturing, not ``capture.py``'s), the eager
    warm-up (``capture.py``'s, not capturing) and a capture with tracing
    off get no marker."""
    if case != "tracing_off":
        profiling.enable()
    marks = _markers(monkeypatch, capturing=case != "warm_up")
    own = profiling.own_capture() if case != "callers_graph" else profiling._Null()
    with own:
        with profiling.annotate("qp.solve"):
            pass
    assert marks == [] and profiling.sections() == {}


def test_the_ports_capture_on_another_thread_marks_nothing_here(monkeypatch):
    """``capture.py`` capturing on one thread leaves a graph another thread
    captures itself without markers: captures are thread-local."""
    profiling.enable()
    marks = _markers(monkeypatch)
    held, done = threading.Event(), threading.Event()

    def port_capture():
        with profiling.own_capture():
            held.set()
            done.wait(timeout=30)

    t = threading.Thread(target=port_capture)
    t.start()
    try:
        assert held.wait(timeout=30)
        with profiling.annotate("qp.solve"):
            pass
    finally:
        done.set()
        t.join(timeout=30)
    assert marks == [] and profiling.sections() == {}


def test_marker_ids_run_out_quietly(monkeypatch):
    profiling.enable()
    marks = _markers(monkeypatch)
    with profiling.own_capture():
        for k in range(profiling.MAX_SECTIONS + 2):
            with profiling.annotate(f"s{k}"):
                pass
    assert len(profiling.sections()) == profiling.MAX_SECTIONS
    assert len(marks) == 2 * profiling.MAX_SECTIONS
    assert profiling.totals()[f"s{profiling.MAX_SECTIONS + 1}"]["count"] == 1


def test_marker_table_matches_the_cuda_source():
    """``MAX_SECTIONS`` ids are instantiated in ``csrc/section_marker.cu``,
    whose launcher refuses any other id or end."""
    src = (ROOT / "strided_tpu_torch" / "csrc" / "section_marker.cu").read_text()
    assert int(re.search(r"kSections = (\d+);", src).group(1)) == profiling.MAX_SECTIONS
    assert "strided_section_marker<I, 0>" in src and "strided_section_marker<I, 1>" in src
    assert 'extern "C" int strided_section_mark(int section, int end, void* stream)' in src


class _FakeGraph:
    def pool(self):
        return None

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, _other):
        pass


def _fake_cuda(monkeypatch):
    """Enough of ``torch.cuda`` for ``capture._record`` on CPU tensors: the
    stream 'captures' inside ``torch.cuda.graph`` only."""
    state = {"capturing": False}

    class _Graph:
        def __init__(self, graph, **_kw):
            pass

        def __enter__(self):
            state["capturing"] = True

        def __exit__(self, *exc):
            state["capturing"] = False
            return False

    monkeypatch.setattr(torch.cuda, "Stream", lambda *_a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda _s: profiling._Null())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state["capturing"])
    monkeypatch.setattr(cap, "_graphs", {})


@pytest.mark.parametrize("on", [False, True])
def test_record_marks_its_capture_and_not_its_warm_up(monkeypatch, on):
    """``capture._record`` runs the function twice: the warm-up gets no
    marker, the capture two a span, and only with tracing on."""
    _fake_cuda(monkeypatch)
    marks = []
    monkeypatch.setattr(profiling, "_mark", lambda sid, end: marks.append((sid, end)))
    if on:
        profiling.enable()
    seen = []

    def fn(x):
        seen.append(torch.cuda.is_current_stream_capturing())
        with profiling.annotate("model.step"):
            return x * 2

    graph, inputs, outputs = cap._record(fn, (torch.ones(3),), {}, torch.device("cpu"))
    assert seen == [False, True]
    assert marks == ([(0, 0), (0, 1)] if on else [])
    assert getattr(profiling._local, "own", 0) == 0
    assert torch.equal(outputs, torch.full((3,), 2.0))


def test_the_tracing_switch_is_in_the_capture_key():
    args = (torch.zeros(4, 12),)
    key0, _ = cap.signature(args, {})
    profiling.enable()
    key1, _ = cap.signature(args, {})
    profiling.disable()
    assert key1 != key0
    assert cap.signature(args, {})[0] == key0


# ---- the spans at the layer boundaries ----

def test_the_captured_step_on_the_cpu_shows_qp_and_plant_and_no_capture_span():
    """On CPU tensors the decorated step runs as it is: ``qp.solve`` and
    ``model.step`` once a call, no ``capture.*`` span."""
    model, ctrl = tentry.make_controller(horizon=4, dt=0.05, device="cpu")
    step = tentry.make_step(model, ctrl, 0.05)
    x = torch.zeros(8, 12)
    profiling.enable()
    for _ in range(3):
        step(x)
    t = profiling.totals()
    assert t["qp.solve"]["count"] == 3 and t["model.step"]["count"] == 3
    assert t["qp.solve"]["parents"] == {None: 3}
    assert not [n for n in t if n.startswith("capture.")]


def test_engine_plan_counts_the_planners_calls(monkeypatch):
    """``engine.plan`` is the planner's call counter; a call the planner
    declines runs under ``engine.plain``."""
    calls = []
    real = executor_cuda.make_plan
    monkeypatch.setattr(executor_cuda, "make_plan", lambda *a: calls.append(1) or real(*a))
    profiling.enable()
    x = torch.arange(12.0).reshape(3, 4)
    got = stt.to_array(stt.sbroadcast(lambda t: t * 2 + 1, stt.strided(x)))
    stt.to_array(stt.ssum(stt.strided(x), 0))
    torch.testing.assert_close(got, x * 2 + 1)
    t = profiling.totals()
    assert t["engine.plan"]["count"] == len(calls) >= 1
    assert t["engine.plain"]["count"] >= 1
