"""The reference's precision names and the arguments that take them, on the
CPU against the JAX package: ``Config.matmul_precision`` ("highest",
"high", "default"; the port's own "medium"; an unknown name), the
single-pass bf16 product's plain version, ``qp_solve``'s coarse ADMM
schedule (``coarse_iters`` / ``admm_coarse_iters``) through the controller,
its converter, its captures and the one-rank split step, ``mul``,
``contract`` and the tensor-parallel products at each name, the tile
argument of ``symmetrize`` and ``pair_axpby``, the public signatures, and
``bench.main``'s headline line."""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402

import strided_tpu as jst  # noqa: E402
import strided_tpu.config as jconfig  # noqa: E402
import strided_tpu.core.kernels_special as jks  # noqa: E402
import strided_tpu.models as jm  # noqa: E402
import strided_tpu.mpc as jmpc  # noqa: E402
import strided_tpu.parallel as jpar  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
import strided_tpu_torch.core.kernels_special as tks  # noqa: E402
import strided_tpu_torch.models as tm  # noqa: E402
import strided_tpu_torch.mpc as tmpc  # noqa: E402
import strided_tpu_torch.parallel as tpar  # noqa: E402
from strided_tpu_torch import bench as tbench  # noqa: E402
from strided_tpu_torch import capture as cap  # noqa: E402
from strided_tpu_torch import config as tconfig  # noqa: E402
from strided_tpu_torch.convert import linear_mpc_from_numpy  # noqa: E402

Q_DIAG = [10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1]
U_MIN, U_MAX = [-5.0, -0.5, -0.5, -0.5], [10.0, 0.5, 0.5, 0.5]
# f32 parity of one product or solve with the JAX package on the CPU: the
# same arithmetic, the summation order differs (as test_torch_mpc.py).
F32_TOL = 1e-5
NAMES = ("highest", "high", "default", "medium", "bogus")


@pytest.fixture
def precision():
    """Set ``matmul_precision`` in both packages (the port's check bypassed,
    so an unknown name reaches the entry points as the reference's does);
    both configs are restored after the test."""
    jold, told = jconfig.get_config(), tconfig.get_config()

    def set_both(name):
        jconfig.set_config(matmul_precision=name)
        tconfig._config = dataclasses.replace(told, matmul_precision=name)

    yield set_both
    jconfig.set_config(matmul_precision=jold.matmul_precision)
    tconfig._config = told


# ---- the names and the scope ----------------------------------------------------


def test_set_config_refuses_an_unknown_name():
    old = tconfig.get_config()
    for name in ("bogus", "float32", "DEFAULT"):
        with pytest.raises(ValueError, match="not one of"):
            tconfig.set_config(matmul_precision=name)
        assert tconfig.get_config() is old
    for name in tconfig.PRECISIONS:
        try:
            assert tconfig.set_config(matmul_precision=name).matmul_precision == name
        finally:
            tconfig.set_config(matmul_precision=old.matmul_precision)


@pytest.mark.parametrize("caller", ["high", "highest"])
def test_default_pins_ieee_fp32_whatever_the_caller_set(precision, caller):
    """The fault: with the caller at "high", "default" left TF32 on. Now the
    scope pins torch's "highest" mode, TF32 off (the single pass is
    ``config.matmul``'s), and the caller's mode comes back."""
    seen = []
    scoped = tconfig.matmul_precision_scope(
        lambda: seen.append((torch.get_float32_matmul_precision(),
                             torch.backends.cuda.matmul.allow_tf32)))
    old = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision(caller)
        precision("default")
        scoped()
        assert torch.get_float32_matmul_precision() == caller
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]
    assert seen == [("highest", False)]


def test_the_scope_refuses_an_unknown_name_like_jax(precision):
    precision("bogus")
    with pytest.raises(ValueError):
        with jax.default_matmul_precision("bogus"):
            pass
    with pytest.raises(ValueError, match="not one of"):
        tconfig.matmul_precision_scope(lambda: None)()


def _bf16_tol(a, b):
    """Two f32 summation orders of one product of bf16 values: each within
    (k - 1) u sum|a_i b_i| of the exact sum, u = 2^-24, so within
    2 k u (|a| @ |b|) of each other, elementwise."""
    a16 = np.asarray(torch.as_tensor(a).bfloat16().double())
    b16 = np.asarray(torch.as_tensor(b).bfloat16().double())
    return 2 * a.shape[-1] * 2.0 ** -24 * (np.abs(a16) @ np.abs(b16))


@pytest.mark.parametrize("m,k,n", [(64, 200, 200), (33, 257, 17), (1, 4096, 8)])
def test_the_single_pass_product_is_jax_default_on_bf16(m, k, n):
    """The plain version of the "default" product (operands rounded to
    bf16, products exact in f32, f32 accumulation) against
    ``jnp.dot(bf16, bf16, preferred_element_type=f32)``, within the f32
    summation-order bound of ``_bf16_tol``."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = tconfig.bf16_matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    want = jnp.dot(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
    assert (err <= _bf16_tol(a, b)).all()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got.double().numpy() - exact).max() > 1e-4  # the operands were rounded


def test_default_is_ieee_fp32_on_the_cpu():
    """On CPU tensors "default" is the IEEE FP32 product, as XLA:CPU
    computes the reference's DEFAULT: equal to the "highest" product."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((48, 200), (200, 200)))
    with tconfig.precision_mode("highest"):
        want = torch.matmul(a, b)
    assert torch.equal(tconfig.matmul(a, b, "default"), want)
    assert not tconfig.single_pass("default", a, b)
    with pytest.raises(ValueError):
        tconfig.matmul(a, b, "bogus")


# ---- each entry point at each name, against the reference --------------------------

# The names each entry point refuses in the reference: qp_solve through
# jax.default_matmul_precision, matmul_ksplit through lax.dot_general's
# precision; mul and contract map an unknown name to HIGHEST
# (strided_tpu/linalg.py:200-201). "medium" is the port's own name: the
# port runs it where the reference refuses it (a Known difference).
REFUSES = {"qp_solve": {"medium", "bogus"}, "mul": set(), "contract": set(),
           "matmul_ksplit": {"medium", "bogus"}}


@pytest.fixture(scope="module")
def rank1():
    """One gloo rank of this process and the JAX package's 8-device mesh."""
    assert not tdist.is_initialized()
    mesh = tpar.make_mesh(device="cpu")
    yield mesh, jpar.make_mesh()
    tdist.destroy_process_group()


def _qp_case():
    jc = jmpc.make_hover_mpc(
        jm.quadrotor(), jm.hover_state(jnp.float32), jm.hover_input(dtype=jnp.float32),
        jnp.diag(jnp.array(Q_DIAG, jnp.float32)), jnp.eye(4, dtype=jnp.float32) * 0.1,
        jnp.diag(jnp.array(Q_DIAG, jnp.float32)), horizon=8, dt=0.05,
        u_min=jnp.array(U_MIN, jnp.float32), u_max=jnp.array(U_MAX, jnp.float32),
        admm_iters=10)
    tc = linear_mpc_from_numpy(_to_numpy(jc), device="cpu")
    x = np.random.default_rng(11).uniform(-0.3, 0.3, (16, 12))
    return (lambda: jmpc.qp_solve(jc.qp, jnp.asarray(x, jnp.float32), jc.u_min, jc.u_max, 10),
            lambda: tmpc.qp_solve(tc.qp, torch.as_tensor(x, dtype=torch.float32), tc.u_min,
                                  tc.u_max, 10))


def _entry_points(name, meshes):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((24, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tmesh, jmesh = meshes
    return {
        "qp_solve": _qp_case(),
        "mul": (lambda: jst.to_array(jst.mul(jst.strided(jnp.zeros((24, 16), jnp.float32)),
                                             jst.strided(ja), jst.strided(jb))),
                lambda: tst.to_array(tst.mul(tst.strided(torch.zeros(24, 16)),
                                             tst.strided(ta), tst.strided(tb)))),
        "contract": (lambda: jst.contract("ab,bc->ac", jst.strided(ja), jst.strided(jb)),
                     lambda: tst.contract("ab,bc->ac", tst.strided(ta), tst.strided(tb))),
        "matmul_ksplit": (lambda: jpar.matmul_ksplit(ja, jb, jmesh, precision=name),
                          lambda: tpar.matmul_ksplit(ta, tb, tmesh, precision=name)),
    }


@pytest.mark.parametrize("entry", list(REFUSES))
@pytest.mark.parametrize("name", NAMES)
def test_each_entry_point_takes_or_refuses_a_name_as_the_reference(precision, rank1, name,
                                                                   entry):
    precision(name)
    ref, port = _entry_points(name, rank1)[entry]
    if name in REFUSES[entry]:
        with pytest.raises(ValueError):
            np.asarray(ref())
        if name != "medium":
            with pytest.raises(ValueError):
                port()
            return
        # Known difference: the port's "medium" runs (TF32 on cuBLAS; oneDNN
        # may take bf16 passes on the CPU), so its values are not compared.
        assert torch.isfinite(port()).all()
        return
    got = port()
    if name == "medium":
        assert torch.isfinite(got).all()  # the port's own mode: values not compared
        return
    want = np.asarray(ref(), np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_the_tensor_parallel_products_take_a_precision(rank1):
    """``precision=None`` is the configured name; an explicit name is used
    whatever is configured; bf16 operands are multiplied exactly in f32."""
    tmesh, _ = rank1
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    with tconfig.precision_mode("highest"):
        want = torch.matmul(a, b)
    for split in (tpar.matmul_nsplit, tpar.matmul_msplit, tpar.matmul_ksplit):
        for p in (None, "highest", "default"):
            assert torch.equal(split(a, b, tmesh, precision=p), want)
        with pytest.raises(ValueError):
            split(a, b, tmesh, precision="bogus")
    a16, b16 = a.bfloat16(), b.bfloat16()
    assert torch.equal(tpar.matmul_ksplit(a16, b16, tmesh, precision="default"),
                       tconfig.bf16_matmul_reference(a, b).bfloat16())


# ---- qp_solve's coarse schedule ------------------------------------------------------


def _to_numpy(ctrl) -> dict:
    qp = ctrl.qp
    d = {k: np.asarray(getattr(qp, k)) for k in ("A", "B", "Su", "Sx", "H", "M", "K_lqr",
                                                 "solver")}
    d.update(rho=qp.rho, N=qp.N, n=qp.n, m=qp.m, use_chol=qp.use_chol)
    d.update({k: np.asarray(getattr(ctrl, k)) for k in ("x_eq", "u_eq", "u_min", "u_max")})
    d.update(admm_iters=ctrl.admm_iters, constrained=ctrl.constrained,
             admm_coarse_iters=ctrl.admm_coarse_iters)
    return d


def _port_hover(coarse, dtype=torch.float32, iters=12, horizon=10):
    f = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return tmpc.make_hover_mpc(
        tm.quadrotor(), tm.hover_state(dtype, "cpu"), tm.hover_input(dtype=dtype, device="cpu"),
        torch.diag(f(Q_DIAG)), torch.eye(4, dtype=dtype) * 0.1, torch.diag(f(Q_DIAG)),
        horizon=horizon, dt=0.02, u_min=f(U_MIN), u_max=f(U_MAX), admm_iters=iters,
        admm_coarse_iters=coarse)


def _jax_hover(coarse, dtype=jnp.float32, iters=12, horizon=10):
    return jmpc.make_hover_mpc(
        jm.quadrotor(), jm.hover_state(dtype), jm.hover_input(dtype=dtype),
        jnp.diag(jnp.array(Q_DIAG, dtype)), jnp.eye(4, dtype=dtype) * 0.1,
        jnp.diag(jnp.array(Q_DIAG, dtype)), horizon=horizon, dt=0.02,
        u_min=jnp.array(U_MIN, dtype), u_max=jnp.array(U_MAX, dtype), admm_iters=iters,
        admm_coarse_iters=coarse)


@pytest.mark.parametrize("prec,tol", [("f32", F32_TOL), ("f64", 1e-12)])
def test_admm_coarse_iters_knob(prec, tol):
    """``tests/test_mpc.py::test_admm_coarse_iters_knob`` on the port: on the
    CPU "default" is IEEE FP32, so coarse 6 of 12 equals coarse 0 bit for
    bit in each package, and the port's plans equal the reference's within
    the f32 summation order (f64: 1e-12)."""
    tdt, jdt = (torch.float32, jnp.float32) if prec == "f32" else (torch.float64, jnp.float64)
    x = np.random.default_rng(0).uniform(-0.3, 0.3, (8, 12))
    u0, u6 = (_port_hover(c, tdt).plan(torch.as_tensor(x, dtype=tdt)) for c in (0, 6))
    assert torch.equal(u0, u6)
    j0, j6 = (np.asarray(_jax_hover(c, jdt).plan(jnp.asarray(x, jdt))) for c in (0, 6))
    np.testing.assert_array_equal(j0, j6)
    np.testing.assert_allclose(u6.double().numpy(), j6.astype(np.float64), rtol=0, atol=tol)


@pytest.mark.parametrize("coarse", [-3, 0, 5, 12, 40])
def test_qp_solve_coarse_iters_clips_and_matches_jax(coarse):
    """``coarse_iters`` clipped to [0, iters] on both sides; f64, 1e-12."""
    jc, tc = _jax_hover(0, jnp.float64, iters=12), _port_hover(0, torch.float64, iters=12)
    x = np.random.default_rng(2).uniform(-0.3, 0.3, (5, 12))
    want = jmpc.qp_solve(jc.qp, jnp.asarray(x), jc.u_min, jc.u_max, 12, coarse_iters=coarse)
    got = tmpc.qp_solve(tc.qp, torch.as_tensor(x), tc.u_min, tc.u_max, 12, coarse_iters=coarse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_the_converter_carries_admm_coarse_iters():
    d = _to_numpy(_jax_hover(6))
    assert linear_mpc_from_numpy(d, device="cpu").admm_coarse_iters == 6
    del d["admm_coarse_iters"]
    assert linear_mpc_from_numpy(d, device="cpu").admm_coarse_iters == 0


def test_controllers_differing_only_in_coarse_iters_take_two_captures():
    """Their ``closed_loop`` keys differ (the controller is held by
    identity), so one never replays the other's graph."""
    c0 = _port_hover(0)
    c6 = dataclasses.replace(c0, admm_coarse_iters=6)
    model, x = tm.quadrotor(), torch.zeros(8, 12)
    k0, objs = cap.signature((c0, model, x, 20, 0.02), {})
    k6, _ = cap.signature((c6, model, x, 20, 0.02), {})
    assert k0 != k6
    cache = cap.Cache()
    cache.put(k0, objs, "entry")
    assert cache.get(k6) is None and cache.get(k0) == "entry"


def test_the_split_step_with_coarse_iters_is_the_unsplit_step(rank1):
    """The split step and the consensus reach ``qp_solve`` through
    ``ctrl.control``: on one gloo rank, with ``admm_coarse_iters`` 4 of 12,
    both equal the unsplit controller bit for bit."""
    mesh1 = rank1[0]
    model, ctrl = tm.quadrotor(), _port_hover(4, horizon=8)
    x = torch.as_tensor(np.random.default_rng(7).uniform(-0.2, 0.2, (16, 12)),
                        dtype=torch.float32)
    xn, u = tpar.sharded_mpc_step(ctrl, model, mesh1, 0.02)(x)
    u_loc, plans_loc = ctrl.control(x)
    assert torch.equal(u, u_loc) and torch.equal(xn, model.step(x, u_loc, 0.02))
    u_cons, plans = tpar.scenario_consensus_control(ctrl, mesh1)(x)
    assert torch.equal(plans, plans_loc)
    torch.testing.assert_close(u_cons, u_loc.mean(0), rtol=0, atol=1e-6)


# ---- symmetrize and pair_axpby take the reference's tile ---------------------------


@pytest.mark.parametrize("n", [256, 257, 1000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_symmetrize_and_pair_axpby_take_the_tile_as_the_reference(n, dtype):
    """``symmetrize(x, 256)`` (before: ``alpha`` = 256, off by up to 1585.98
    at 256^2 f32) and ``pair_axpby(x, tile=...)`` equal the reference's
    (its Pallas kernel in interpret mode, or its plain expression where it
    refuses the tile), exactly. The cases are those whose arithmetic has one
    rounding a term (``3A + 2A^T`` may contract to an FMA on XLA:CPU, so
    ``test_torch_engine_kernels.py`` holds it to a tolerance)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    a = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    ja, ta = jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)
    cases = [(lambda m, x: m.symmetrize(x, 256), jst, tst),
             (lambda m, x: m.symmetrize(x, tile=128, alpha=0.25), jst, tst),
             (lambda m, x: m.pair_axpby(x, scale_mode="div", scale=2.0, tile=128), jks, tks),
             (lambda m, x: m.pair_axpby(x, alpha=1.0, beta=-1.0, tile=64), jks, tks)]
    for call, jmod, tmod in cases:
        want = np.asarray(call(jmod, ja).astype(jnp.float32))
        got = call(tmod, ta).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_pair_axpby_refuses_a_tile_that_is_no_edge():
    x = torch.zeros(4, 4)
    for tile in (0, -128, 2.5, True):
        with pytest.raises(ValueError, match="tile"):
            tks.pair_axpby(x, tile=tile)


# ---- the public signatures -------------------------------------------------------


@pytest.mark.parametrize("name", ["qp_solve", "LinearMPC", "make_hover_mpc", "symmetrize",
                                  "pair_axpby", "matmul_nsplit", "matmul_msplit",
                                  "matmul_ksplit"])
def test_the_signature_is_the_references(name):
    """The parameter names, in order."""
    home = {"qp_solve": (jmpc, tmpc), "LinearMPC": (jmpc, tmpc), "make_hover_mpc": (jmpc, tmpc),
            "symmetrize": (jks, tks), "pair_axpby": (jks, tks),
            "matmul_nsplit": (jpar, tpar), "matmul_msplit": (jpar, tpar),
            "matmul_ksplit": (jpar, tpar)}[name]
    ref, port = (list(inspect.signature(getattr(m, name)).parameters) for m in home)
    assert port == ref


# ---- bench.main's headline line --------------------------------------------------


def test_the_headline_line_has_the_references_keys():
    line = tbench.headline(2.5e7)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["unit"] == "solves/s/chip" and line["value"] == 2.5e7
    assert line["vs_baseline"] == 2.5e7 / 10_000
    assert "ADMM-6 rho=8" in line["metric"] and "N=50" in line["metric"]


def test_bench_main_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])


def test_a_checkpoint_keeps_admm_coarse_iters(tmp_path):
    """``admm_coarse_iters`` is static context of the controller's pytree
    node, as in the reference's: no leaf, and it round-trips."""
    from strided_tpu_torch.utils import load_pytree, save_pytree

    ctrl = _port_hover(6)
    p = str(tmp_path / "ctrl.npz")
    save_pytree(p, ctrl)
    back = load_pytree(p, ctrl)
    assert back.admm_coarse_iters == 6 and torch.equal(back.qp.solver, ctrl.qp.solver)
