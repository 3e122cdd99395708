"""K4's streaming map (``tile_stream_v``) and the route that feeds it.

An aligned map (every operand read in loop order) whose body eager PyTorch
runs as two or more kernels takes K4; one of a single kernel stays on the
plain path unless ``aligned_maps``. A call whose output and inputs share one
dense layout is planned as one dim of ``n`` elements without the planner,
and the launcher streams it. ``exp`` and ``sin`` run there only: every
other plan, and K3 and K4's reductions, decline a program holding one.

On the CPU: the route rule through ``make_plan``, ``LAST_PLAN`` and the
plain version ``tile_executor_reference`` (equal to eager PyTorch bit for
bit); the dense one-dim plan against the planner's plan of the same call;
the declines and their logged reasons; the CUDA sources' side of the split
(the interpreters built without exp and sin, the launchers that refuse
them). On the card only (the ``card`` fixture skips elsewhere): the kernel
against eager PyTorch bit for bit on the README broadcast and a two-input
body in f32, bf16 and int32, on runs of whole 8-element groups, a ragged
tail and an unaligned base; one launch a call on ``MAP_PATHS["stream"]``;
the other map paths unchanged; a program holding ``sin`` refused off the
stream. This file imports no JAX, so on the card it runs as ``python -m
pytest --noconftest -p no:cacheprovider tests/test_torch_stream_map.py``.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import strided_tpu_torch as st  # noqa: E402
from strided_tpu_torch import config as tcfg  # noqa: E402
from strided_tpu_torch.core import ewise  # noqa: E402
from strided_tpu_torch.core import executor_cuda as tec  # noqa: E402
from strided_tpu_torch.core import kernels_special as tks  # noqa: E402
from strided_tpu_torch.core import stream_reduce as tsr  # noqa: E402

CSRC = Path(tec.__file__).resolve().parents[1] / "csrc"


def readme(t):
    """The README's broadcast body, ``A.*exp.(-2A) .+ sin.(A.*A)``."""
    return t * torch.exp(-2 * t) + torch.sin(t * t)


def two_input(p, q):
    return (p * 3 + q) * 0.5


@pytest.fixture(autouse=True)
def gates():
    old = tcfg.get_config()
    tcfg.set_config(use_kernels=True, min_kernel_elements=1024, map_min_elements=1024,
                    min_stream_reduce_elements=1024, kernel_reductions=False, aligned_maps=False)
    yield
    tcfg.set_config(**dataclasses.asdict(old))


def _tensor(shape, dtype=torch.float32, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-6, 6, shape).astype(np.int32)).to(device)
    return torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dtype).to(device)


def _plan(f, ins, out_dtype=None):
    """``make_plan`` of the map ``f`` over the views ``ins`` into a new
    dense output; returns (plan, output view)."""
    dims = tuple(ins[0].shape)
    dtype = out_dtype or ewise.result_dtype(f, [v.dtype for v in ins])
    out = st.strided(torch.empty(dims, dtype=dtype, device=ins[0].device))
    return tec.make_plan(f, None, None, dims, out, list(ins)), out


# ---- on the CPU ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("f,n_in", [(readme, 1), (two_input, 2)], ids=["readme", "two-input"])
def test_an_aligned_map_of_several_passes_plans_the_stream(f, n_in, dtype):
    """An aligned body of several eager kernels takes K4: one dim of n
    elements, every stride 1, the stream; its plain version equals eager
    PyTorch bit for bit."""
    xs = [_tensor((64, 48), dtype, seed=k) for k in range(n_in)]
    plan, out = _plan(f, [st.strided(x, device="cpu") for x in xs])
    assert plan is not None and plan.streams
    assert (plan.dims, plan.n_par, plan.out_strides) == ((64 * 48,), 1, (1,))
    assert tec.LAST_PLAN["stream"] and tec.LAST_PLAN["dims"] == (64 * 48,)
    got = tec.tile_executor(plan, out.parent, [x.reshape(-1) for x in xs])
    assert torch.equal(got.reshape(64, 48), f(*xs))
    assert ewise.transcendental(plan.body) == (f is readme)


def test_an_aligned_single_op_map_stays_plain_unless_aligned_maps(caplog):
    """One eager kernel is already one pass: the reference's policy holds,
    and the call says why it stayed plain. With ``aligned_maps`` it streams."""
    x = st.strided(_tensor((64, 48)), device="cpu")
    for f in (lambda t: t * 2, lambda t: torch.exp(t), lambda t: t + 1.5):
        with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
            plan, _ = _plan(f, [x])
        assert plan is None and not tec.LAST_PLAN
        assert "aligned map of one eager pass (aligned_maps off)" in caplog.text
        assert tec.eager_passes(ewise.trace(f, [torch.float32])) == 1
    tcfg.set_config(aligned_maps=True)
    plan, _ = _plan(lambda t: t * 2, [x])
    assert plan is not None and plan.streams
    assert tec.eager_passes(ewise.trace(readme, [torch.float32])) == 6  # -2*, exp, *, *, sin, +
    assert tec.eager_passes(ewise.trace(lambda t: torch.full_like(t, 2.0) * t,
                                        [torch.float32])) == 2  # a fill is a kernel


def test_the_engine_entry_points_take_the_stream():
    """``sbroadcast``, ``smap``, ``map_into`` and a lazy expression reach the
    stream on a dense call; the results equal eager PyTorch."""
    a, b = _tensor((64, 48)), _tensor((64, 48), seed=1)
    va, vb = st.strided(a, device="cpu"), st.strided(b, device="cpu")
    calls = {
        "sbroadcast": (lambda: st.sbroadcast(readme, va), readme(a)),
        "smap": (lambda: st.smap(two_input, va, vb), two_input(a, b)),
        "map_into": (lambda: st.map_into(st.strided(torch.empty(64, 48), device="cpu"),
                                         two_input, va, vb), two_input(a, b)),
        "lazy expression": (lambda: va * 2 - vb, a * 2 - b),
    }
    for name, (call, want) in calls.items():
        tec.LAST_PLAN.clear()
        got = st.to_array(call())
        assert tec.LAST_PLAN.get("stream"), name
        assert torch.equal(got, want), name


def test_a_transposed_map_holding_sin_is_declined_and_says_so(caplog):
    """``sin`` off the streaming layout (a transposed operand) leaves the
    call on the plain path with its reason; without ``sin`` the same layout
    keeps K4's tiled plan."""
    a = _tensor((64, 48))
    v = st.transpose(st.strided(a, device="cpu"))
    with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
        out = st.smap(lambda t: torch.sin(t) * 2, v)
    assert not tec.LAST_PLAN
    assert "exp or sin off the streaming map" in caplog.text
    assert torch.equal(st.materialize(out), torch.sin(a.T) * 2)
    plan, _ = _plan(lambda t: t * 2 + 1, [v])
    assert plan is not None and not plan.streams and plan.tdim == 0
    assert not tec.LAST_PLAN["stream"]


def test_a_broadcast_operand_takes_the_planner_and_declines_sin(caplog):
    """A stride-0 operand is aligned but not dense: the planner's plan, the
    amortized kernels for a body without ``sin``, the plain path with it."""
    x, row = _tensor((64, 48)), _tensor((1, 48), seed=1)
    views = [st.strided(x, device="cpu"), st.broadcast_to(st.strided(row, device="cpu"), (64, 48))]
    plan, out = _plan(two_input, views)
    assert plan is not None and not plan.streams and len(plan.dims) == 2
    got = tec.tile_executor(plan, out.parent, [x.reshape(-1), row.reshape(-1)])
    assert torch.equal(got.reshape(64, 48), two_input(x, row))
    with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
        plan, _ = _plan(lambda p, q: torch.sin(p) + q, views)
    assert plan is None and "exp or sin off the streaming map" in caplog.text


def test_a_wide_body_holding_exp_is_declined():
    """A body wider than ewise.CREG registers runs on no streaming instance:
    with ``exp`` it stays plain, without it K4's scalar interpreter takes it."""
    x = st.strided(_tensor((64, 48)), device="cpu")
    wide = lambda t: (t + 1) * ((t + 2) * ((t + 3) * (t + 4))) + t  # noqa: E731
    assert ewise.compact(ewise.trace(wide, [torch.float32])).n_reg > ewise.CREG
    plan, _ = _plan(wide, [x])
    assert plan is not None and plan.dims == (64 * 48,) and not plan.streams
    assert not tec.LAST_PLAN["stream"]
    plan, _ = _plan(lambda t: wide(torch.exp(t)), [x])
    assert plan is None


def test_a_reduction_holding_exp_is_declined_by_k3_and_k4(caplog):
    """K3's planner and K4's decline ``exp`` in a reduction with their
    reasons; the engine's result is the plain path's."""
    a = _tensor((64, 48))
    v = st.strided(a, device="cpu")
    with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
        assert tks.try_stream_reduce(lambda t: torch.exp(t), torch.add, v, (0,)) is None
    assert "exp and sin run on K4's streaming map only" in caplog.text
    assert tks.try_stream_reduce(lambda t: t * 2, torch.add, v, (0,)) is not None
    tcfg.set_config(kernel_reductions=True)
    out = st.broadcast_to(st.strided(torch.zeros(1, 48), device="cpu"), (64, 48))
    with caplog.at_level("DEBUG", logger="strided_tpu_torch.dispatch"):
        plan = tec.make_plan(lambda t: torch.exp(t), torch.add, None, (64, 48), out, [v])
    assert plan is None and "exp or sin off the streaming map" in caplog.text
    plan = tec.make_plan(lambda t: t * 2, torch.add, lambda o: torch.sin(o), (64, 48), out, [v])
    assert plan is None
    got = st.to_array(st.ssum(st.sbroadcast(torch.exp, v), axis=0))
    assert torch.allclose(got, torch.exp(a).sum(0, keepdim=True), rtol=1e-6, atol=0)


LAYOUTS = {  # name: (shape, every view's permutation of its contiguous parent)
    "row-major": ((64, 48), (0, 1)),
    "all transposed alike": ((48, 64), (1, 0)),
    "rank 4, permuted alike": ((6, 5, 4, 12), (2, 0, 3, 1)),
    "size-1 dims": ((1, 64, 1, 48), (0, 1, 2, 3)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_dense_plan_matches_the_planners(name, monkeypatch):
    """Operands that share one dense layout skip the planner: one dim of n,
    every stride 1. The planner's plan of the same call (``_dense`` off)
    computes the same output parent bit for bit."""
    shape, perm = LAYOUTS[name]
    pshape = tuple(shape[perm.index(d)] for d in range(len(shape)))
    xs = [_tensor(pshape, seed=k) for k in range(2)]
    views = [st.permutedims(st.strided(x, device="cpu"), perm) for x in xs]
    out = st.permutedims(st.strided(torch.empty(pshape), device="cpu"), perm)
    assert tuple(views[0].shape) == shape
    dense = tec.make_plan(two_input, None, None, shape, out, views)
    assert dense is not None and dense.dims == (int(np.prod(shape)),) and dense.streams
    got = tec.tile_executor(dense, out.parent, [x.reshape(-1) for x in xs])
    monkeypatch.setattr(tec, "_dense", lambda dims, operands: False)
    planned = tec.make_plan(two_input, None, None, shape, out, views)
    assert planned is not None
    want = tec.tile_executor(planned, out.parent, [x.reshape(-1) for x in xs])
    assert torch.equal(got, want)
    assert torch.equal(got, two_input(*xs).reshape(-1))


def test_dense_is_read_from_the_layout_alone():
    """``_dense``: the same strides on every operand, offset 0, the whole
    parent, strides a dense layout; a slice, a gap, a flip, a broadcast or
    one operand of another layout is not dense."""
    x = torch.zeros(64, 48)
    v = st.strided(x, device="cpu")
    t = st.transpose(st.strided(torch.zeros(48, 64), device="cpu"))
    big = st.strided(torch.zeros(64, 96), device="cpu")
    gapped = st.StridedView(big.parent, (64, 48), (96, 1), 0)
    offset = st.StridedView(big.parent, (64, 48), (48, 1), 48)
    flipped = st.StridedView(v.parent, (64, 48), (48, -1), 47)
    bcast = st.broadcast_to(st.strided(torch.zeros(1, 48), device="cpu"), (64, 48))
    dims = (64, 48)
    assert tec._dense(dims, [v, v, v])
    for other in (t, gapped, offset, flipped, bcast):
        assert not tec._dense(dims, [v, other])
    assert tec._dense(dims, [t, t])


def test_the_sources_keep_exp_and_sin_to_the_stream():
    """Only ``tile_stream_v`` instantiates the select interpreter with exp
    and sin (TR); the copying and scalar interpreters have no such op, no
    other kernel of K3's and K4's sources asks for them, and both launchers
    refuse such a program where it would reach another kernel. The launcher
    reports the stream as ``*path`` 4, ``MAP_PATHS``'s "stream"."""
    k4 = (CSRC / "tile_executor.cu").read_text()
    k3 = (CSRC / "stream_reduce.cu").read_text()
    stream = re.search(r"__global__ void __launch_bounds__\(THREADS\) tile_stream_v\(.*?\n\}",
                       k4, re.S).group(0)
    assert "ew_run_s<R, PER, TR>(p.body, r);" in stream
    rest = k4.replace(stream, "")
    for src in (rest, k3):
        assert not re.search(r"ew_run_s<[^>]*\b(TR|true)\b", src)
    launcher = k4[k4.index('extern "C" int strided_tile_executor('):]
    assert launcher.index("if (streams(p))") < launcher.index("ew_transcendental(p->body)")
    assert "*path = 4;" in launcher and tec._MAP_PATH_NAMES[4] == "stream"
    assert "ew_transcendental(*prog)" in k3[k3.index('extern "C" int strided_stream_reduce('):]
    header = (CSRC / "ewise.cuh").read_text()
    for other in ("ew_apply(", "ew_run_v(", "ew_run("):
        body = header[header.index(other):]
        assert "EW_EXP" not in body[:body.index("\n}\n")], other
    ops = re.search(r"enum \{\s*EW_CONST,(.*?)\};", header, re.S).group(1)
    names = [o.strip() for o in ops.split(",") if o.strip()]
    assert names[-2:] == ["EW_EXP", "EW_SIN"] and len(names) + 1 == ewise.SIN + 1


# ---- on the card only ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streaming kernel has no CPU version "
                    "(tile_executor_reference is its plain version, tested above)")
    tcfg.set_config(map_min_elements=1, min_kernel_elements=1)
    return torch.device("cuda")


def _unaligned(n, dtype, seed, dev):
    """A dense tensor of n elements whose first element is 4 (f32, int32)
    or 2 (bf16) bytes past a 16-byte boundary."""
    buf = _tensor((n + 1,), dtype, seed, dev)
    x = buf[1:]
    assert x.data_ptr() % 16 != 0
    return x


CARD_SIZES = {"whole groups": (4096, 2048), "ragged tail": (4099, 517), "unaligned base": None}


@pytest.mark.parametrize("size", list(CARD_SIZES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("f,n_in", [(readme, 1), (two_input, 2)], ids=["readme", "two-input"])
def test_the_stream_equals_eager_on_the_card(card, f, n_in, dtype, size):
    """The stream's output is eager PyTorch's bit for bit (``expf`` and
    ``sinf`` are what torch's kernels call), one launch a call on
    ``MAP_PATHS["stream"]``, at 8-element groups, a ragged tail (n % 8 != 0)
    and a base off 16 bytes (scalar edges)."""
    shape = CARD_SIZES[size]
    if shape is None:
        xs = [_unaligned(4097 * 33, dtype, k, card).view(4097, 33) for k in range(n_in)]
    else:
        xs = [_tensor(shape, dtype, seed=k, device=card) for k in range(n_in)]
    if dtype == torch.int32 and f is two_input:
        pytest.skip("(p*3 + q) * 0.5 on int32 is an f32 body: covered by the f32 case")
    before, launches = dict(tec.MAP_PATHS), tec.LAUNCHES
    tec.LAST_PLAN.clear()
    got = st.to_array(st.sbroadcast(f, *[st.strided(x) for x in xs]))
    torch.cuda.synchronize()
    assert tec.LAST_PLAN["stream"]
    assert tec.LAUNCHES == launches + 1
    assert {p: n - before[p] for p, n in tec.MAP_PATHS.items() if n != before[p]} == {"stream": 1}
    want = f(*xs)
    assert got.dtype == want.dtype
    assert torch.equal(got, want), f"{int((got != want).sum())} elements off"


def test_programs_without_exp_and_sin_keep_their_paths_on_the_card(card):
    """The maps that are not aligned run the kernels they ran before the
    stream: the transposed scale on the amortized interpreter, the rank-4
    reversal on the copy, the four-permute sum on the multi-axis map."""
    a = _tensor((512, 384), device=card)
    r = _tensor((12, 10, 8, 14), device=card)
    va, vr = st.strided(a), st.strided(r)
    P2, P3, P4 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)
    s = _tensor((12, 12, 12, 12), device=card)
    vs = st.strided(s)
    cases = {
        "3 .* A'": (lambda: st.to_array(3.0 * st.transpose(va)), 3.0 * a.T, "amortized"),
        "reversal": (lambda: st.materialize(st.permutedims_into(
            st.strided(torch.empty(14, 8, 10, 12, device=card)), vr, (3, 2, 1, 0))),
            r.permute(3, 2, 1, 0), "copy"),
        "four-permute sum": (lambda: st.to_array(vs + st.permutedims(vs, P2) + st.permutedims(vs, P3)
                                                 + st.permutedims(vs, P4)),
                             s + s.permute(P2) + s.permute(P3) + s.permute(P4), "multi_axis"),
    }
    for name, (call, want, path) in cases.items():
        before = dict(tec.MAP_PATHS)
        got = call()
        torch.cuda.synchronize()
        assert [p for p in tec.MAP_PATHS if tec.MAP_PATHS[p] != before[p]] == [path], name
        assert torch.equal(got, want), name


def test_the_launchers_refuse_sin_off_the_stream_on_the_card(card):
    """A plan the planner would decline, built by hand: a program holding
    ``sin`` on a transposed map reaches K4's launcher, which refuses it
    rather than run an interpreter built without it; K3's wrapper refuses
    one too."""
    a = _tensor((512, 384), device=card)
    v = st.transpose(st.strided(a))
    plan, out = _plan(lambda t: t * 2 + 1, [v])
    assert plan is not None and not plan.streams
    bad = dataclasses.replace(plan, body=ewise.trace(lambda t: torch.sin(t) + 1, [torch.float32],
                                                     out_dtype=torch.float32))
    with pytest.raises(RuntimeError):
        tec.tile_executor(bad, out.parent, [a.reshape(-1)])
    with pytest.raises(ValueError):
        tsr.stream_reduce(a, ewise.trace(lambda t: torch.exp(t), [torch.float32]), tsr.RED_SUM)
