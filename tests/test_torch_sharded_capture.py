"""The multi-GPU layer's captured functions (``parallel.mesh_capture``, the
counterpart of ``jax.jit(shard_map(...))``) on the CPU, against the JAX
package's ``strided_tpu.parallel``.

On CPU tensors the decorated ``sharded_mpc_step`` and
``scenario_consensus_control`` run as they are (gloo, eagerly). They are
held against the JAX ``shard_map`` versions on the same numpy inputs on one
gloo rank in this process and on two gloo ranks spawned through
``multiproc.spawn`` (a timeout a spawn). The ranks' capture signatures of
one call are compared, the gloo refusal's predicate is pinned with the
backend and ``capture.recorded`` replaced, and ``COLLECTIVES`` is shown to
count host calls. The card-only tests skip here (a fixture decides): the
tests never run on the card, which has no JAX, so ``chip_smoke.py`` phase
14 makes those checks there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402

import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu.parallel as jpar  # noqa: E402
from strided_tpu.config import get_config as jget_config, set_config as jset_config  # noqa: E402
from strided_tpu_torch import capture as cap  # noqa: E402
from strided_tpu_torch import parallel as tpar  # noqa: E402
from strided_tpu_torch.benchmarks import scenario_mpc  # noqa: E402
from strided_tpu_torch.mpc import fused_admm as fa  # noqa: E402
from strided_tpu_torch.parallel import mesh as mesh_mod, multiproc  # noqa: E402

DT = 0.05
ITERS = 10  # ADMM iterations
STEP_B, CONS_B = 32, 64  # scenarios
TOL = {"f64": 1e-12, "f32": 1e-5}  # as tests/test_torch_parallel.py against the unsplit step
Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]
U_MIN, U_MAX = [-5.0, -0.2, -0.2, -0.2], [10.0, 0.2, 0.2, 0.2]
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def _inputs():
    rng = np.random.default_rng(7)
    return rng.uniform(-0.2, 0.2, (STEP_B, 12)), rng.uniform(-0.2, 0.2, (CONS_B, 12))


# The worker of the two-rank spawn: no JAX in it (a worker of the port
# refuses to import it). argv: init_method, ranks, rank, output directory.
WORKER = f"""
import re, sys
import numpy as np, torch
from strided_tpu_torch import capture as cap, parallel as tpar
from strided_tpu_torch.benchmarks import scenario_mpc
from strided_tpu_torch.models import hover_input, hover_state, quadrotor
from strided_tpu_torch.mpc import make_hover_mpc
from strided_tpu_torch.parallel import dist as pdist

init, nproc, rank, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
assert pdist.init_distributed(init_method=init, world_size=nproc, rank=rank, device="cpu")
mesh = tpar.make_mesh(device="cpu")
rng = np.random.default_rng(7)
xs, xc = rng.uniform(-0.2, 0.2, ({STEP_B}, 12)), rng.uniform(-0.2, 0.2, ({CONS_B}, 12))
res = {{}}
for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
    as_t = lambda v: torch.tensor(v, dtype=dtype)
    Q = torch.diag(as_t({Q_DIAG}))
    model = quadrotor()
    ctrl = make_hover_mpc(model, hover_state(dtype, "cpu"),
                          hover_input(dtype=dtype, device="cpu"), Q,
                          torch.eye(4, dtype=dtype) * 0.1, Q, horizon=8, dt={DT},
                          u_min=as_t({U_MIN}), u_max=as_t({U_MAX}), admm_iters={ITERS})
    step = tpar.sharded_mpc_step(ctrl, model, mesh, {DT})
    cons = tpar.scenario_consensus_control(ctrl, mesh)
    x, x2 = torch.as_tensor(xs, dtype=dtype), torch.as_tensor(xc, dtype=dtype)
    before = dict(tpar.COLLECTIVES)
    xn, u = step(x)
    for _ in range(3):
        u_cons, plans = cons(x2)
    res["coll_" + name] = [tpar.COLLECTIVES[k] - before[k] for k in tpar.COLLECTIVES]
    res["step_x_" + name] = tpar.gather(xn, mesh)
    res["step_u_" + name] = tpar.gather(u, mesh)
    res["chain_" + name] = scenario_mpc.chained_step(step, mesh)(x)
    res["cons_u_" + name] = u_cons
    res["cons_plans_" + name] = tpar.gather(plans, mesh)
    res["cache_" + name] = len(step.cache) + len(cons.cache)
    key, objects = cap.signature((x,), {{}})
    res["signature_" + name] = repr(key)
    key, objects = cap.signature((ctrl, x, {DT}), {{}})
    res["signature_obj_" + name] = re.sub(str(id(ctrl)), "<ctrl>", repr(key))
    res["objects_" + name] = [type(o).__name__ for o in objects]
res["gather_dim1"] = tpar.gather(torch.full((2, 3), float(rank)), mesh, 1)
res["graphs"] = [cap.CAPTURES, cap.REPLAYS]
torch.distributed.destroy_process_group()
np.savez(f"{{outdir}}/rank{{rank}}.npz", **{{k: np.asarray(v) for k, v in res.items()}})
assert "jax" not in sys.modules
print("WORKER_OK", rank, flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_capture")
    outs = multiproc.spawn(["-c", WORKER], 2, (str(d),), timeout=120)
    assert all("WORKER_OK" in o for o in outs), outs
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's jitted ``shard_map`` step and consensus on its
    8-device CPU mesh, f64 and f32, on the same inputs. In f32 the ADMM
    loop runs as the scan: the Pallas kernel in interpret mode does not
    trace under ``shard_map`` on the CPU (its ``vma`` check), and the scan
    is the same math as K1's plain version, which the port runs here."""
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    mesh = jpar.make_mesh()
    xs, xc = _inputs()
    out = {}
    old = jget_config()
    jset_config(fused_admm=False)
    try:
        for name, (_, jd) in DTYPES.items():
            out.update(_jax_step_and_consensus(mesh, jd, name, xs, xc))
    finally:
        jset_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_step_and_consensus(mesh, jd, name, xs, xc):
    Q = jnp.diag(jnp.array(Q_DIAG, jd))
    model = jm.quadrotor()
    ctrl = jmpc.make_hover_mpc(
        model, jm.hover_state(jd), jm.hover_input(dtype=jd), Q, jnp.eye(4, dtype=jd) * 0.1, Q,
        horizon=8, dt=DT, u_min=jnp.array(U_MIN, jd), u_max=jnp.array(U_MAX, jd),
        admm_iters=ITERS)
    put = lambda a: jax.device_put(jnp.asarray(a, jd), jpar.data_sharding(mesh, 2))  # noqa: E731
    step_x, step_u = jax.jit(jpar.sharded_mpc_step(ctrl, model, mesh, DT))(put(xs))
    cons_u, plans = jax.jit(jpar.scenario_consensus_control(ctrl, mesh))(put(xc))
    return {f"step_x_{name}": step_x, f"step_u_{name}": step_u,
            f"cons_u_{name}": cons_u, f"cons_plans_{name}": plans}


def _port_controller(dtype):
    from strided_tpu_torch.models import hover_input, hover_state, quadrotor
    from strided_tpu_torch.mpc import make_hover_mpc

    as_t = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    Q = torch.diag(as_t(Q_DIAG))
    model = quadrotor()
    ctrl = make_hover_mpc(model, hover_state(dtype, "cpu"),
                          hover_input(dtype=dtype, device="cpu"), Q,
                          torch.eye(4, dtype=dtype) * 0.1, Q, horizon=8, dt=DT,
                          u_min=as_t(U_MIN), u_max=as_t(U_MAX), admm_iters=ITERS)
    return model, ctrl


@pytest.fixture
def mesh1():
    """One gloo rank of a group of this process alone, destroyed after the
    test."""
    assert not tdist.is_initialized()
    mesh = tpar.make_mesh(device="cpu")
    yield mesh
    tdist.destroy_process_group()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0.0, atol=atol)


# ---- the decorated step and consensus against JAX ------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
def test_one_rank_step_and_consensus_match_jax(mesh1, jx, name):
    dtype = DTYPES[name][0]
    model, ctrl = _port_controller(dtype)
    xs, xc = (torch.as_tensor(a, dtype=dtype) for a in _inputs())
    step = tpar.sharded_mpc_step(ctrl, model, mesh1, DT)
    cons = tpar.scenario_consensus_control(ctrl, mesh1)
    xn, u = step(xs)
    u_cons, plans = cons(xc)
    for key, got in (("step_x", xn), ("step_u", u), ("cons_u", u_cons), ("cons_plans", plans)):
        assert got.dtype == dtype
        _close(got, jx[f"{key}_{name}"], TOL[name])
    u_loc, plans_loc = ctrl.control(xc)
    _close(u_cons, u_loc.mean(0), TOL[name])
    _close(plans, plans_loc, TOL[name])


@pytest.mark.parametrize("name", list(DTYPES))
def test_one_rank_chained_step_is_the_step(mesh1, name):
    """``scenario_mpc.chained_step`` on one rank returns the step's next
    states (no gather)."""
    dtype = DTYPES[name][0]
    model, ctrl = _port_controller(dtype)
    xs = torch.as_tensor(_inputs()[0], dtype=dtype)
    step = tpar.sharded_mpc_step(ctrl, model, mesh1, DT)
    before = dict(tpar.COLLECTIVES)
    assert torch.equal(scenario_mpc.chained_step(step, mesh1)(xs), step(xs)[0])
    assert tpar.COLLECTIVES == before


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("key", ["step_x", "step_u", "cons_u", "cons_plans"])
def test_two_ranks_match_jax(two_ranks, jx, name, key):
    for res in two_ranks:
        got = res[f"{key}_{name}"]
        assert got.dtype == np.dtype("float64" if name == "f64" else "float32")
        _close(got, jx[f"{key}_{name}"], TOL[name])
    np.testing.assert_array_equal(two_ranks[0][f"{key}_{name}"], two_ranks[1][f"{key}_{name}"])


@pytest.mark.parametrize("name", list(DTYPES))
def test_two_ranks_chain_gathers_the_step(two_ranks, jx, name):
    for res in two_ranks:
        np.testing.assert_array_equal(res[f"chain_{name}"], res[f"step_x_{name}"])
        _close(res[f"chain_{name}"], jx[f"step_x_{name}"], TOL[name])


def test_two_ranks_gather_along_dim_1_in_rank_order(two_ranks):
    want = np.concatenate([np.full((2, 3), 0.0), np.full((2, 3), 1.0)], axis=1)
    for res in two_ranks:
        np.testing.assert_array_equal(res["gather_dim1"], want)


# ---- the ranks agree on the capture key ------------------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
def test_ranks_compute_the_same_signature(two_ranks, name):
    """Shape, dtype, strides, device, config and matmul mode are the same on
    both ranks; an object argument differs only by its id."""
    r0, r1 = two_ranks
    assert str(r0[f"signature_{name}"]) == str(r1[f"signature_{name}"])
    assert str(r0[f"signature_obj_{name}"]) == str(r1[f"signature_obj_{name}"])
    assert "<ctrl>" in str(r0[f"signature_obj_{name}"])
    assert list(r0[f"objects_{name}"]) == ["LinearMPC"]
    assert "(32, 12)" in str(r0[f"signature_{name}"])


def test_two_cpu_ranks_take_no_capture(two_ranks):
    for res in two_ranks:
        assert list(res["graphs"]) == [0, 0]
        assert int(res["cache_f64"]) == int(res["cache_f32"]) == 0


# ---- COLLECTIVES counts host calls ---------------------------------------------


def test_collectives_count_host_calls(two_ranks):
    """One step (no collective) and three consensus calls: three
    ``all_reduce``s, one a host call."""
    for res in two_ranks:
        for name in DTYPES:
            assert list(res[f"coll_{name}"]) == [3, 0, 0]  # all_reduce, all_gather, broadcast


def test_collectives_count_host_calls_on_one_rank(mesh1):
    model, ctrl = _port_controller(torch.float32)
    cons = tpar.scenario_consensus_control(ctrl, mesh1)
    x = torch.as_tensor(_inputs()[1], dtype=torch.float32)
    before = dict(tpar.COLLECTIVES)
    for _ in range(4):
        cons(x)
    tpar.gather(x, mesh1)
    assert [tpar.COLLECTIVES[k] - before[k] for k in tpar.COLLECTIVES] == [4, 1, 0]


# ---- the gloo refusal and its predicate ----------------------------------------


def test_recorded_is_false_on_the_cpu():
    x = torch.zeros(3)
    assert not cap.recorded([x]) and not cap.recorded([])
    assert not cap.capturing([x])
    with cap.disable_capture():
        assert not cap.recorded([x])


@pytest.mark.parametrize("backend,recorded,raises", [
    ("gloo", True, True), ("gloo", False, False), ("nccl", True, False), ("nccl", False, False),
])
def test_require_graph_backend_predicate(mesh1, monkeypatch, backend, recorded, raises):
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(cap, "recorded", lambda tensors: recorded)
    call = lambda: mesh_mod.require_graph_backend(mesh1, "data", [torch.zeros(2)], "f")  # noqa: E731
    if raises:
        with pytest.raises(RuntimeError, match="f: mesh axis 'data' runs on gloo, which a CUDA "
                                               "graph cannot record"):
            call()
    else:
        call()


def test_gloo_refused_before_any_capture_where_recorded(mesh1, monkeypatch):
    """With ``capture.recorded`` saying the call would go into a graph (as
    it does on CUDA tensors outside ``disable_capture()``), the step, the
    consensus and the chain over gloo raise before any work: no capture, no
    collective, no K1 launch, nothing cached. A bare collective raises only
    while the stream is capturing."""
    model, ctrl = _port_controller(torch.float32)
    step = tpar.sharded_mpc_step(ctrl, model, mesh1, DT)
    cons = tpar.scenario_consensus_control(ctrl, mesh1)
    chain = scenario_mpc.chained_step(step, mesh1)
    x = torch.as_tensor(_inputs()[0], dtype=torch.float32)
    monkeypatch.setattr(cap, "recorded", lambda tensors: True)
    before = (dict(tpar.COLLECTIVES), cap.CAPTURES, cap.REPLAYS, fa.LAUNCHES)
    for fn, what in ((step, "mpc_step"), (cons, "consensus_control"),
                     (chain, "step_and_gather")):
        with pytest.raises(RuntimeError, match=f"{what}: mesh axis 'data' runs on gloo"):
            fn(x)
        assert len(fn.cache) == 0
    tpar.collective("all_reduce", x.clone(), mesh1)  # a bare collective is not recorded
    monkeypatch.setattr(cap, "capturing", lambda tensors: True)
    with pytest.raises(RuntimeError, match="all_reduce: mesh axis 'data' runs on gloo"):
        tpar.collective("all_reduce", x, mesh1)  # inside a caller's graph
    tpar.COLLECTIVES["all_reduce"] -= 1  # the bare one above
    assert (dict(tpar.COLLECTIVES), cap.CAPTURES, cap.REPLAYS, fa.LAUNCHES) == before


def test_a_mesh_capture_takes_tensors_only(mesh1):
    f = tpar.mesh_capture(lambda x, s: x * s, mesh1)
    with pytest.raises(TypeError, match="takes tensors only, got float"):
        f(torch.ones(2), 2.0)
    g = tpar.mesh_capture(lambda x: x + 1, mesh1)
    assert torch.equal(g(torch.ones(2)), torch.full((2,), 2.0)) and len(g.cache) == 0


def test_the_signature_has_no_object_for_a_tensor_call():
    key, objects = cap.signature((torch.zeros(4, 12),), {})
    assert objects == [] and "object" not in repr(key)


# ---- on the card only ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step and consensus replay CUDA graphs there "
                    "(chip_smoke.py phase 14 runs these checks on the card)")
    assert not tdist.is_initialized()
    yield torch.device("cuda")
    if tdist.is_initialized():
        tdist.destroy_process_group()


def test_captured_equals_eager_on_one_nccl_rank(card):
    mesh = tpar.make_mesh(device="cuda")
    model, ctrl = scenario_mpc.controller(horizon=8, admm_iters=ITERS, device=card)
    x = scenario_mpc.states(256, card)
    step = tpar.sharded_mpc_step(ctrl, model, mesh, scenario_mpc.DT)
    cons = tpar.scenario_consensus_control(ctrl, mesh)
    n = cap.CAPTURES
    got = (*step(x), *cons(x))
    with cap.disable_capture():
        want = (*step(x), *cons(x))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cap.CAPTURES == n + 2 and len(step.cache) == len(cons.cache) == 1


def test_gloo_on_cuda_tensors_raises_before_capture(card):
    mesh = tpar.make_mesh(device="cpu")  # a gloo group
    model, ctrl = scenario_mpc.controller(horizon=8, admm_iters=ITERS, device=card)
    cons = tpar.scenario_consensus_control(ctrl, mesh)
    n = cap.CAPTURES
    with pytest.raises(RuntimeError, match="runs on gloo"):
        cons(scenario_mpc.states(64, card))
    assert cap.CAPTURES == n and len(cons.cache) == 0
    with cap.disable_capture():
        u_cons, _ = cons(scenario_mpc.states(64, card))
    assert torch.isfinite(u_cons).all()
