"""The engine's size sweeps (``strided_tpu_torch/benchmarks/sweeps.py``) on
the CPU: every family, run small with both packages' size gates lowered,
where the engine spelling equals the plain PyTorch spelling and the same
expression written with the JAX package (``benchmarks/sweeps.py``'s
spellings, Pallas in interpret mode) on the same numpy inputs from
``default_rng(seed)``.

Tolerances: ``exact`` for copies and maps; ``ulp`` (5 * max|a| * 2^-23)
against JAX for the two-coefficient spellings, which XLA on the CPU may
contract into an FMA; ``trans`` (4 f32 ulps of the result's magnitude)
against JAX for ``exp``/``sin``, whose libraries differ; ``sum``
(1e-6 * elements * max|a|) for f32 sums; and the products in f64 at 1e-12
of the result's magnitude. Against the plain PyTorch spelling every family
is exact but the f32 sums (another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
from strided_tpu import config as jcfg  # noqa: E402
from strided_tpu_torch import config as tcfg  # noqa: E402
from strided_tpu_torch.benchmarks import sweeps  # noqa: E402

J_GATES = dict(use_pallas=True, min_pallas_elements=1024, pallas_map_min_elements=1024,
               pair_kernel_min_elements=1024, min_stream_reduce_elements=1024)
T_GATES = dict(use_kernels=True, min_kernel_elements=1024, map_min_elements=1024,
               pair_kernel_min_elements=1024, min_stream_reduce_elements=1024)


@pytest.fixture(autouse=True)
def gates():
    jold, told = jcfg.get_config(), tcfg.get_config()
    jcfg.set_config(**J_GATES)
    tcfg.set_config(**T_GATES)
    yield
    jcfg.set_config(**dataclasses.asdict(jold))
    tcfg.set_config(**dataclasses.asdict(told))


def _jax_permute4(x):
    v = jst.strided(x)
    return jst.to_array(v + jst.permutedims(v, sweeps.P2) + jst.permutedims(v, sweeps.P3)
                        + jst.permutedims(v, sweeps.P4))


def _jax_mul(x):
    C = jst.strided(jnp.zeros((x.shape[0], x.shape[0]), x.dtype))
    return jst.to_array(jst.mul(C, jst.transpose(jst.strided(x)), jst.strided(x)))


def _jax_contraction(x, W):
    a, b, c = x.shape
    xv = jst.sreshape(jst.strided(x), (a, b * c))
    wv = jst.sreshape(jst.strided(W), (b * c, W.shape[2]))
    C = jst.strided(jnp.zeros((a, W.shape[2]), x.dtype))
    return x + jst.to_array(jst.mul(C, xv, wv)).sum()


# family: (small size, dtype, tolerance against JAX, the JAX package's spelling)
CASES = {
    "sum_transposed": (64, np.float32, "sum", lambda x: x + jst.sreduce(
        lambda v: v, jnp.add, jst.transpose(jst.strided(x)))),
    "permutedims_4d": (8, np.float32, "exact", lambda x: jst.permutedims_into(
        jst.strided(jnp.zeros_like(x)), jst.strided(x), sweeps.REVERSE).parent.reshape(x.shape)),
    "symmetrize": (64, np.float32, "exact", lambda x: jst.to_array(
        (jst.strided(x) + jst.transpose(jst.strided(x))) * 0.5)),
    "symmetrize_kernel": (64, np.float32, "exact", lambda x: jst.symmetrize(x)),
    "axpby_transpose": (64, np.float32, "ulp", lambda x: jst.to_array(
        3.0 * jst.strided(x) + 2.0 * jst.transpose(jst.strided(x)))),
    "axpby_linalg": (64, np.float32, "ulp", lambda x: jst.to_array(
        jst.axpby(3.0, jst.transpose(jst.strided(x)), 2.0, jst.strided(x)))),
    "compute_broadcast": (64, np.float32, "trans", lambda x: jst.to_array(jst.sbroadcast(
        lambda t: t * jnp.exp(-2 * t) + jnp.sin(t * t), jst.strided(x)))),
    "mul_At_B": (32, np.float64, "product", _jax_mul),
    "contraction_mera": (4, np.float64, "product", _jax_contraction),
    "permute4_fused": (8, np.float32, "exact", _jax_permute4),
    "permute4_temporaries": (8, np.float32, "exact", _jax_permute4),
}


def _inputs(name, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in sweeps.FAMILIES[name].shapes(d)]


def _check(got, want, tol, a):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(a)))
    atol = {"exact": 0.0, "ulp": 5 * scale * 2.0 ** -23,
            "trans": 4 * float(np.max(np.abs(want))) * 2.0 ** -23,
            "sum": 1e-6 * a.size * scale,
            "product": 1e-12 * float(np.max(np.abs(want)))}[tol]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_the_table_holds_every_family_of_the_jax_script():
    assert list(CASES) == list(sweeps.FAMILIES)
    groups = {f.group for f in sweeps.FAMILIES.values()}
    assert groups == {"sum", "permute", "symmetrize", "compute_bound", "mul", "contraction",
                      "permute4_sum"}  # benchmarks/sweeps.py::ALL_BENCHES


@pytest.mark.parametrize("name", list(CASES))
def test_family_engine_equals_plain_and_jax(name):
    d, dtype, tol, jax_spelling = CASES[name]
    x, *fixed = _inputs(name, d, dtype, seed=len(name))
    engine, plain = sweeps.FAMILIES[name].spell(*(torch.from_numpy(t) for t in (x, *fixed)))
    xt = torch.from_numpy(x)
    got, route = sweeps.route_of(lambda: engine(xt))
    assert route["route"] == "plain"  # on the CPU no kernel launches
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(plain(xt).shape)
    _check(got.numpy(), plain(xt).numpy(), "sum" if tol == "sum" else "exact", x)
    _check(got.numpy(), jax_spelling(*(jnp.asarray(t) for t in (x, *fixed))), tol, x)


@pytest.mark.parametrize("name,record", [
    ("symmetrize", ("pair-kernel", "", False)), ("axpby_linalg", ("pair-kernel", "", False)),
    ("permutedims_4d", ("", "", True)), ("permute4_fused", ("generic", "", True)),
    ("sum_transposed", ("", "xla", False)), ("compute_broadcast", ("", "", True)),
])
def test_route_of_reads_the_dispatch_records(name, record):
    """``route_of`` resets the records before the call and reports them:
    the pair spellings reach K2's dispatch, the permutes and the
    transcendental map (an aligned body of several eager passes, ``exp`` and
    ``sin`` in the program table) K4's plan, the complete sum the plain
    path."""
    d = CASES[name][0]
    x, *fixed = (torch.from_numpy(t) for t in _inputs(name, d, np.float32, 0))
    engine, _plain = sweeps.FAMILIES[name].spell(x, *fixed)
    _out, route = sweeps.route_of(lambda: engine(x))
    assert (route["expr"], route["reduce"], route["plan"] is not None) == record


def test_traffic_models_follow_the_jax_script():
    """3 passes for the sum, 2 for the permutes, the symmetrize family and
    the broadcast, 5 for the four-permute sum, 2*m*n*k for the products."""
    F = sweeps.FAMILIES
    assert F["sum_transposed"].traffic(1024) == {"bytes": 3 * 1024 ** 2 * 4}
    assert F["permutedims_4d"].traffic(32) == {"bytes": 2 * 32 ** 4 * 4}
    for name in ("symmetrize", "symmetrize_kernel", "axpby_transpose", "axpby_linalg",
                 "compute_broadcast"):
        assert F[name].traffic(4000) == {"bytes": 2 * 4000 ** 2 * 4}
    assert F["permute4_fused"].traffic(64) == {"bytes": 5 * 64 ** 4 * 4}
    assert F["mul_At_B"].traffic(512) == {"flops": 2 * 512 ** 3}
    assert F["contraction_mera"].traffic(128) == {"flops": 2 * 512 ** 2 * 128 ** 2}


def test_sizes_are_the_jax_scripts():
    F = sweeps.FAMILIES
    assert F["sum_transposed"].sizes == (1024, 2048, 4096, 8192)
    assert F["permutedims_4d"].sizes == (16, 32, 48, 64)
    assert all(F[n].sizes == (4000, 8192) for n in ("symmetrize", "symmetrize_kernel",
                                                      "axpby_transpose", "axpby_linalg"))
    assert F["compute_broadcast"].sizes == (1000, 2048, 4096, 8192)
    assert F["mul_At_B"].sizes == (512, 1024, 2048, 4096)
    assert F["contraction_mera"].sizes == (64, 128, 192)
    assert F["permute4_fused"].sizes == F["permute4_temporaries"].sizes == (32, 48, 64)


@pytest.mark.parametrize("only,want", [
    (None, list(sweeps.FAMILIES)),
    (["sum"], ["sum_transposed", "permute4_fused", "permute4_temporaries"]),
    (["mul", "contraction"], ["mul_At_B", "contraction_mera"]),
    (["symmetrize_kernel"], ["symmetrize_kernel"]),
])
def test_only_selects_as_the_jax_script(only, want):
    """A key matches a family name or the JAX script's bench function (so
    ``sum`` also takes ``bench_permute4_sum``'s records, as there)."""
    assert sweeps.families(only) == want


def test_operands_are_seeded_and_shaped():
    x, W = sweeps.operands("contraction_mera", 4, "cpu", seed=3)
    assert x.shape == (16, 4, 4) and W.shape == (4, 4, 16)
    x2, W2 = sweeps.operands("contraction_mera", 4, "cpu", seed=3)
    assert torch.equal(x, x2) and torch.equal(W, W2)
