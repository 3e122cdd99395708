"""The port's multi-GPU layer (``strided_tpu_torch.parallel``) against the
JAX package's ``strided_tpu.parallel``.

Two module fixtures spawn 2 and 4 gloo ranks on the CPU
(``multiproc.run_multiprocess_check``: a file rendezvous in a temporary
directory, one timeout for the spawn). Each rank runs
``multiproc.dryrun_checks`` on ``multiproc.dryrun_inputs()`` and writes its
gathered results, the port's unsharded results and the collectives each
call issued. The JAX side runs here on its 8-device CPU mesh
(``tests/conftest.py``), on the same inputs. Each result is held against
both. A 1-rank mesh in this process checks the
mesh's single-process contract, and ``init_distributed``'s paths run with
``init_process_group`` replaced."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402

import strided_tpu as st  # noqa: E402
import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu.parallel as jpar  # noqa: E402
from strided_tpu.config import get_config as jget_config, set_config as jset_config  # noqa: E402
from strided_tpu_torch import parallel as tpar  # noqa: E402
from strided_tpu_torch.parallel import dist as tdist_mod, multiproc  # noqa: E402

Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]


@pytest.fixture(scope="module")
def inputs():
    return multiproc.dryrun_inputs()


def _spawn(nproc, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"ranks{nproc}")
    multiproc.run_multiprocess_check(nproc, device="cpu", timeout=120, outdir=str(d))
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request):
    """Every rank's results of one spawn (2 or 4 gloo ranks)."""
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture(scope="module")
def jx(inputs):
    """The JAX package's results on its 8-device CPU mesh, same inputs."""
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    mesh = jpar.make_mesh()
    put = lambda a, ndim: jax.device_put(jnp.asarray(a), jpar.data_sharding(mesh, ndim))  # noqa: E731
    out = {}
    dt = 0.05
    Q = jnp.diag(jnp.array(Q_DIAG, jnp.float64))
    model = jm.quadrotor()
    ctrl = jmpc.make_hover_mpc(
        model, jm.hover_state(jnp.float64), jm.hover_input(dtype=jnp.float64), Q,
        jnp.eye(4, dtype=jnp.float64) * 0.1, Q, horizon=8, dt=dt,
        u_min=jnp.array([-5.0, -0.2, -0.2, -0.2]), u_max=jnp.array([10.0, 0.2, 0.2, 0.2]))
    out["step_x"], out["step_u"] = jax.jit(jpar.sharded_mpc_step(ctrl, model, mesh, dt))(
        put(inputs["x_step"], 2))
    out["cons_u"], out["cons_plans"] = jax.jit(jpar.scenario_consensus_control(ctrl, mesh))(
        put(inputs["x_cons"], 2))
    out["rollout"] = jax.jit(jpar.sharded_rollout(jm.double_pendulum(), mesh, dt=0.01))(
        put(inputs["roll_x0"], 2), put(inputs["roll_us"], 3))
    out["batch"] = jax.jit(jpar.shard_batch(lambda z: jnp.sin(z) * 2.0, mesh))(
        jnp.asarray(inputs["batch_x"]))
    A, B = jnp.asarray(inputs["mm_A"]), jnp.asarray(inputs["mm_B"])
    for name in "nmk":
        fn = getattr(jpar, f"matmul_{name}split")
        out[f"mm_{name}"] = jax.jit(lambda a, b: fn(a, b, mesh))(A, B)
    out["mm_k_int"] = jax.jit(lambda a, b: jpar.matmul_ksplit(a, b, mesh))(
        jnp.asarray(inputs["mm_Ai"]), jnp.asarray(inputs["mm_Bi"]))
    a, at, r, e = (st.strided(jnp.asarray(inputs[k]))
                   for k in ("smap_a", "smap_at", "red_a", "expr_a"))
    out["smap"] = jpar.sharded_smap(lambda p, q: p + 2 * q, mesh, a, a)
    out["smap_t"] = jpar.sharded_smap(lambda p: p + 1.0, mesh, st.transpose(at))
    out["partial"] = jpar.sharded_reduce(lambda z: z, jnp.add, r, mesh, axes=1)
    out["complete"] = jpar.sharded_reduce(jnp.abs, jnp.maximum, r, mesh)
    out["complete_fold"] = jpar.sharded_reduce(lambda z: z, lambda p, q: p + q, r, mesh)
    out["expr"] = jpar.sharded_reduce(lambda z: z, jnp.add, (e + st.transpose(e)) / 2, mesh)
    old = jget_config()
    try:
        jset_config(use_pallas=True, min_pallas_elements=1024, pair_kernel_min_elements=1024,
                    min_stream_reduce_elements=1024)
        out["pair"] = jax.jit(lambda z: jpar.sharded_batched_pair(
            z, mesh, scale_mode="mul", scale=0.5))(jnp.asarray(inputs["pair_x"]))
        out["stream"] = jax.jit(lambda z: jpar.sharded_stream_sum(z, mesh))(
            jnp.asarray(inputs["sum_a"]))
    finally:
        jset_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})
    mesh2 = jpar.make_mesh(axis_sizes=(4, 2), axis_names=("data", "model"))
    X = jax.device_put(jnp.asarray(inputs["dm_X"]),
                       jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec("data", None)))
    out["dm_n"] = jax.jit(lambda x, w: jax.nn.relu(jpar.matmul_nsplit(x, w, mesh2, axis="model")))(
        X, jnp.asarray(inputs["dm_W"]))
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# -- scenario-split MPC (f64 controller, horizon 8) ---------------------------


def test_sharded_step_matches_jax_and_local(ranks, jx):
    res = ranks[0]
    for key in ("step_u", "step_x"):
        _close(res[key], jx[key], 1e-9)
        _close(res[key], res[key + "_local"], 1e-12)
    assert tuple(res["step_block"]) == (16 // len(ranks), 4)  # the rank's rows


def test_consensus_matches_jax_and_local(ranks, jx):
    res = ranks[0]
    _close(res["cons_u"], jx["cons_u"], 1e-9)
    _close(res["cons_u"], res["cons_u_local"], 1e-12)
    _close(res["cons_plans"], jx["cons_plans"], 1e-9)
    _close(res["cons_plans"], res["cons_plans_local"], 1e-12)


def test_sharded_rollout_and_shard_batch(ranks, jx):
    res = ranks[0]
    _close(res["rollout"], jx["rollout"], 1e-12)
    _close(res["rollout"], res["rollout_local"], 1e-12)
    _close(res["batch"], jx["batch"], 1e-12)


def test_f32_step_and_consensus_launch_no_kernel_on_the_cpu(ranks):
    """The f32 controller (K1's dtype) runs K1's plain version on the CPU:
    no launch, and the rows within 1e-5 of the unsharded step."""
    for res in ranks:
        assert int(res["k1_step_f32"]) == int(res["k1_consensus_f32"]) == 0
        assert tuple(res["step_block_f32"]) == (16 // len(ranks), 4)
        for key in ("step_u_f32", "step_x_f32", "cons_u_f32", "cons_plans_f32"):
            assert res[key].dtype == np.float32
            _close(res[key], res[key.replace("_f32", "_local_f32")], 1e-5)


def test_batch_not_divisible_by_the_ranks_raises(ranks):
    assert "does not divide" in str(ranks[0]["err_batch"])


@pytest.mark.parametrize("op", ["smap", "reduce"])
def test_engine_op_refuses_a_split_that_does_not_divide(ranks, op):
    """9 rows over 2 or 4 ranks: the explicit split raises where GSPMD
    would pad."""
    n = len(ranks)
    assert str(ranks[0][f"err_{op}"]) == (f"dim 0 of size 9 does not divide over the {n} "
                                          f"ranks of mesh axis 'data'")


# -- tensor-parallel matmuls ---------------------------------------------------


@pytest.mark.parametrize("split", ["n", "m", "k"])
def test_matmul_split_matches_jax_and_unsplit(ranks, jx, split):
    res = ranks[0]
    got, unsplit = res[f"mm_{split}"], res["mm_local"]
    assert got.dtype == np.float32
    _close(got, jx[f"mm_{split}"], 1e-4)
    assert np.abs(got - unsplit).max() <= 1e-6 * np.abs(unsplit).max()


def test_int_ksplit_stays_int_and_exact(ranks, jx, inputs):
    got = ranks[0]["mm_k_int"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jx["mm_k_int"])
    np.testing.assert_array_equal(got, inputs["mm_Ai"] @ inputs["mm_Bi"])


# -- mesh-split engine ops -----------------------------------------------------


@pytest.mark.parametrize("op", ["smap", "smap_t", "partial", "complete", "complete_fold",
                                "expr"])
def test_engine_op_matches_jax(ranks, jx, op):
    _close(ranks[0][op], jx[op], 1e-5)


def test_engine_ops_match_the_unsharded_result(ranks, inputs):
    res = ranks[0]
    a, at, r = inputs["smap_a"], inputs["smap_at"], inputs["red_a"]
    _close(res["smap"], 3 * a, 1e-12)
    _close(res["smap_t"], at.T + 1.0, 1e-12)
    _close(res["partial"], r.sum(1), 1e-12)
    _close(res["complete"], np.abs(r).max(), 0.0)
    _close(res["complete_fold"], r.sum(), 1e-12)
    _close(res["expr"], res["expr_local"], 1e-12)


def test_split_dim_choice_drives_the_block(ranks):
    """A row-major leaf splits dim 0; the lazily transposed leaf of the same
    shape splits dim 1; a partial reduction over dim 1 splits the kept dim."""
    n = len(ranks)
    for res in ranks:
        assert tuple(res["smap_block"]) == (64 // n, 32)
        assert tuple(res["smap_t_block"]) == (64, 32 // n)
        assert tuple(res["partial_block"]) == (64 // n,)


def test_batched_pair_exact_against_jax_and_plain(ranks, jx):
    res = ranks[0]
    assert tuple(res["pair_block"]) == (8 // len(ranks), 128, 128)
    np.testing.assert_array_equal(res["pair"], res["pair_local"])
    np.testing.assert_array_equal(res["pair"], jx["pair"])


def test_stream_sum_through_k3_and_its_decline(ranks, jx, inputs):
    res = ranks[0]
    a = inputs["sum_a"]
    tol = 1e-6 * a.shape[0] * np.abs(a).max()
    assert str(res["stream_dispatch"]) == "stream-kernel"
    assert str(res["stream_declined_dispatch"]) == "xla"
    for key in ("stream", "stream_declined"):
        _close(res[key], jx["stream"], tol)
        _close(res[key], res["stream_local"].reshape(-1), tol)
        _close(res[key], a.astype(np.float64).sum(0), tol)


# -- collectives: the counterparts of tests/test_sharding.py's HLO checks -----

EXPECTED_COLLECTIVES = {  # call -> (all_reduce, all_gather, broadcast)
    "step": (0, 0, 0),
    "consensus": (1, 0, 0),
    "step_f32": (0, 0, 0),
    "consensus_f32": (1, 0, 0),
    "rollout": (0, 0, 0),
    "mm_n": (0, 0, 0),
    "mm_m": (0, 0, 0),
    "mm_k": (1, 0, 0),
    "smap": (0, 0, 0),
    "smap_t": (0, 0, 0),
    "partial": (0, 0, 0),
    "complete": (1, 0, 0),
    "complete_fold": (0, 1, 0),
    "expr": (1, 0, 0),
    "pair": (0, 0, 0),
    "stream": (1, 0, 0),
    "stream_declined": (1, 0, 0),
}


@pytest.mark.parametrize("call", list(EXPECTED_COLLECTIVES))
def test_collectives_issued(ranks, call):
    for res in ranks:
        assert tuple(res[f"coll_{call}"]) == EXPECTED_COLLECTIVES[call]


def test_replicated_results_agree_on_every_rank(ranks):
    for key in ("cons_u", "complete", "complete_fold", "expr", "stream", "mm_k"):
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[key], ranks[0][key])


def test_make_mesh_clamps_1d_overask_and_refuses_2d(ranks):
    n = len(ranks)
    res = ranks[0]
    assert int(res["clamp_size"]) == n
    assert list(res["clamp_warning"]) == [f"mesh wants {n + 5} devices, only {n} available; "
                                          f"clamping 'data' axis to {n}"]
    assert "only" in str(res["err_2d"])


def test_2d_mesh_data_model_matmuls(ranks4, jx, inputs):
    """('data', 'model') = (2, 2): a data-split batch times a model-split W
    (as tests/test_sharding.py's 2-D case, there on (4, 2)), and m- and
    k-splits over one dimension of the 2-D mesh."""
    X, W = inputs["dm_X"], inputs["dm_W"]
    A, B = inputs["mm_A"], inputs["mm_B"]
    for r, res in enumerate(ranks4):
        assert tuple(res["dm_coords"]) == (r // 2, r % 2)
        assert tuple(res["coll_dm_n"]) == (0, 0, 0) and tuple(res["coll_dm_m"]) == (0, 0, 0)
        assert tuple(res["coll_dm_k"]) == (1, 0, 0)
        _close(res["dm_n"], jx["dm_n"], 1e-4)
        _close(res["dm_n"], np.maximum(X @ W, 0), 1e-5)
        for key in ("dm_m", "dm_k"):
            _close(res[key], A @ B, 1e-4)


# -- choose_split_dim ----------------------------------------------------------


def test_choose_split_dim_reference_cases():
    f = tpar.choose_split_dim
    assert f((64, 64), ((64, 1), (64, 1))) == 0
    assert f((64, 64), ((64, 1),), reduction_dims=(0,)) == 1
    assert f((1, 64), ((64, 1),)) == 1
    assert f((64, 32), ((32, 1),)) == 0
    assert f((64, 32), ((1, 64),)) == 1


@pytest.mark.parametrize("seed", range(6))
def test_choose_split_dim_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        nd = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 9, nd))
        strides = tuple(tuple(int(s) for s in rng.integers(-64, 65, nd))
                        for _ in range(int(rng.integers(1, 4))))
        red = tuple(int(i) for i in np.flatnonzero(rng.random(nd) < 0.3))
        assert tpar.choose_split_dim(dims, strides, red) == jpar.choose_split_dim(
            dims, strides, red)


# -- one rank in this process --------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    assert not tdist.is_initialized()
    mesh = tpar.make_mesh(device="cpu")
    yield mesh
    tdist.destroy_process_group()


def test_single_process_mesh_is_one_gloo_rank(mesh1):
    assert mesh1.mesh_dim_names == ("data",) and mesh1.size() == 1
    assert tdist.get_backend() == "gloo" and tdist_mod.BACKEND == "gloo"
    assert tpar.axis_size(mesh1) == 1 and tpar.axis_index(mesh1) == 0
    assert tpar.init_distributed() is False  # one process: the no-op, group or not


def test_single_rank_step_equals_the_local_step_bit_for_bit(mesh1):
    """What the card's one-rank run checks: the sharded step makes the same
    calls on the same state as ``ctrl.control`` + ``model.step``."""
    from strided_tpu_torch.entry import make_controller

    model, ctrl = make_controller(horizon=8, dt=0.02, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).uniform(-0.3, 0.3, (64, 12)),
                        dtype=torch.float32)
    xn, u = tpar.sharded_mpc_step(ctrl, model, mesh1, 0.02)(x)
    u_loc, _ = ctrl.control(x)
    assert torch.equal(u, u_loc) and torch.equal(xn, model.step(x, u_loc, 0.02))
    u_cons, _ = tpar.scenario_consensus_control(ctrl, mesh1)(x)
    assert torch.equal(u_cons, u_loc.mean(0))


def test_single_rank_mesh_clamps_and_refuses(mesh1):
    with pytest.warns(UserWarning, match="clamping 'data' axis to 1"):
        assert tpar.make_mesh(axis_sizes=(3,), device="cpu").size() == 1
    with pytest.raises(ValueError, match="mesh wants 2 devices, only 1 available"):
        tpar.make_mesh(axis_sizes=(1, 2), axis_names=("data", "model"), device="cpu")


def test_shard_gather_and_collective_at_one_rank(mesh1):
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(tpar.shard(x, mesh1, 1), x)
    assert torch.equal(tpar.gather(x, mesh1, 0), x)
    before = dict(tpar.COLLECTIVES)
    y = x.clone()
    assert tpar.collective("broadcast", y, mesh1) is y and torch.equal(y, x)
    assert tpar.COLLECTIVES["broadcast"] == before["broadcast"] + 1
    with pytest.raises(ValueError, match="collective 'reduce_scatter'"):
        tpar.collective("reduce_scatter", y, mesh1)
    with pytest.raises(ValueError, match="expected \\(B, n, n\\)"):
        tpar.sharded_batched_pair(x, mesh1)
    with pytest.raises(ValueError, match="expected \\(N, M\\)"):
        tpar.sharded_stream_sum(x.reshape(-1), mesh1)


def test_the_card_is_the_default_device():
    """Without CUDA, a mesh or a group on the default device raises rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tdist_mod.init_single_rank()


# -- init_distributed ----------------------------------------------------------

CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE")


@pytest.fixture
def fake_init(monkeypatch):
    """``init_process_group`` recorded instead of run, no group present."""
    calls = []
    state = {"up": False}

    def init(backend, **kw):
        calls.append(dict(kw, backend=backend))
        state["up"] = True

    monkeypatch.setattr(tdist_mod.dist, "init_process_group", init)
    monkeypatch.setattr(tdist_mod.dist, "is_initialized", lambda: state["up"])
    monkeypatch.setattr(tdist_mod.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(tdist_mod, "BACKEND", None)
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    return calls


def test_init_distributed_single_process_is_a_noop(fake_init, monkeypatch):
    assert tdist_mod.init_distributed() is False
    assert tdist_mod.init_distributed(world_size=1) is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist_mod.init_distributed() is False
    assert fake_init == [] and tdist_mod.BACKEND is None


def test_init_distributed_reads_torchrun_env(fake_init, monkeypatch):
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "2"),
                 ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    assert tdist_mod.init_distributed(device="cpu") is True
    assert fake_init == [{"backend": "gloo", "init_method": "env://", "world_size": 2,
                          "rank": 1}]
    assert tdist_mod.BACKEND == "gloo"
    assert tdist_mod.init_distributed(device="cpu") is True  # idempotent
    assert len(fake_init) == 1


def test_init_distributed_explicit_arguments_win(fake_init, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert tdist_mod.init_distributed("file:///tmp/x", world_size=2, rank=0, device="cpu")
    assert fake_init == [{"backend": "gloo", "init_method": "file:///tmp/x", "world_size": 2,
                          "rank": 0}]


def test_init_distributed_refuses_nccl_ranks_sharing_a_card(fake_init, monkeypatch):
    bound = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        tdist_mod.init_distributed("file:///tmp/x", world_size=2, rank=1)
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        tdist_mod.init_distributed("file:///tmp/x", world_size=2, rank=1, backend="nccl")
    assert fake_init == [] and bound == []
    assert tdist_mod.init_distributed("file:///tmp/x", world_size=2, rank=1, backend="gloo")
    assert fake_init[0]["backend"] == "gloo" and bound == [0]  # rank 1 shares card 0


@pytest.mark.parametrize("device,backend", [("cpu", "nccl"), ("cpu", "mpi"), ("xpu", None)])
def test_init_distributed_refuses_a_backend_that_cannot_run(fake_init, device, backend):
    with pytest.raises(ValueError):
        tdist_mod.init_distributed("file:///tmp/x", world_size=2, rank=0, backend=backend,
                                   device=device)
    assert fake_init == []


def test_nccl_takes_one_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist_mod.choose_backend("cuda", None, 4) == "nccl"
    assert tdist_mod.choose_backend("cuda", "gloo", 8) == "gloo"
    assert tdist_mod.choose_backend("cpu", None, 8) == "gloo"


# -- the scenario-MPC benchmark's problem ---------------------------------------


def test_scenario_mpc_controller_matches_the_reference_benchmark():
    """``benchmarks/scenario_mpc.py``'s controller (its Q, R, bounds and
    ADMM-20 at rho=1), at horizon 8 in f64, against the same controller
    built by the JAX package; and the same states."""
    from strided_tpu_torch.benchmarks import scenario_mpc

    model, ctrl = scenario_mpc.controller(horizon=8, device="cpu", dtype=torch.float64)
    Q = jnp.diag(jnp.array(Q_DIAG, jnp.float64))
    jctrl = jmpc.make_hover_mpc(
        jm.quadrotor(), jm.hover_state(jnp.float64), jm.hover_input(dtype=jnp.float64), Q,
        jnp.eye(4, dtype=jnp.float64) * 0.1, Q, horizon=8, dt=scenario_mpc.DT,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5]), u_max=jnp.array([10.0, 0.5, 0.5, 0.5]),
        admm_iters=20)
    x = scenario_mpc.states(64, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).uniform(-0.3, 0.3, (64, 12)))
    u, U = ctrl.control(x)
    ju, jU = jctrl.control(jnp.asarray(x.numpy()))
    _close(u, np.asarray(ju), 1e-9)
    _close(U, np.asarray(jU), 1e-9)
    assert ctrl.admm_iters == 20 and ctrl.qp.rho == 1.0


def test_scenario_mpc_times_the_card_only():
    from strided_tpu_torch.benchmarks import scenario_mpc

    with pytest.raises(RuntimeError, match="times a CUDA device"):
        scenario_mpc.run(scenarios=8, horizon=4, device="cpu")
