"""Parity of the port's rank-4 reversal probes (strided_tpu_torch.benchmarks
exp_perm2, exp_perm4, exp_perm_probe, over perm_kernels) with the JAX
package's TPU probe scripts (benchmarks/exp_perm2.py, exp_perm4.py,
exp_perm_probe.py, imported by path), on the same seeded numpy input at
D = 16 (the scripts' module constant D set to 16: the kernels read it when
they are traced). On the CPU each port wrapper runs its plain PyTorch
version; the JAX bodies run their Pallas kernels in interpret mode
(exp_perm2 and exp_perm_probe by themselves, exp_perm4 under
``force_tpu_interpret_mode``). Every comparison is exact: the outputs are
data movement. The one known difference: ``mxu_default`` is exact in JAX's
interpret mode on the CPU, while the port's plain version rounds to bf16 as
the TPU's DEFAULT does; the port is held to the JAX body at "highest" and
its default to ``bf16(x)`` reversed. Variants whose runs exceed 16 (32, 64)
do not fit D = 16 in either package and are left to the card.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from strided_tpu_torch.benchmarks import exp_perm2 as p2  # noqa: E402
from strided_tpu_torch.benchmarks import exp_perm4 as p4  # noqa: E402
from strided_tpu_torch.benchmarks import exp_perm_probe as pp  # noqa: E402
from strided_tpu_torch.benchmarks import perm_kernels as pk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D = 16


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_perm_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.D = D
    return mod


JP2 = _load("exp_perm2")
JP4 = _load("exp_perm4")
JPP = _load("exp_perm_probe")


def _input(seed=0):
    return np.random.default_rng(seed).standard_normal((D,) * 4).astype(np.float32)


def _port(fn, x):
    before = dict(pk.LAUNCHES)
    got = fn(torch.from_numpy(x)).numpy()
    assert pk.LAUNCHES == before  # CPU tensors never launch a kernel
    return got


def _jax(fn, x, force=False):
    if force:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(jnp.asarray(x)))
    return np.asarray(fn(jnp.asarray(x)))


def _rev(x):
    return np.ascontiguousarray(np.transpose(x, (3, 2, 1, 0)))


# (port script, variant name, JAX body maker, force interpret mode)
CASES = [
    *[(p2, f"loop2d_{b}_{c}", lambda b=b, c=c: JP2.v_loop2d(b, c), False)
      for b, c in ((8, 8), (16, 8), (8, 16), (16, 16))],
    (p2, "chain_8_8", lambda: JP2.v_chain(8, 8), False),
    (p2, "chain3_8_8", lambda: JP2.v_chain3(8, 8), False),
    (p2, "chain3_16_16", lambda: JP2.v_chain3(16, 16), False),
    (p2, "nocompute_8_8", lambda: JP2.v_loop2d_nocompute(8, 8), False),
    *[(p2, f"mxu_{b}_{c}", lambda b=b, c=c: JP2.v_mxu(b, c), False)
      for b, c in ((8, 8), (16, 8), (8, 16))],
    (p2, "plain", lambda: JP2.v_xla, False),
    *[(p4, f"grouped_j2_b{b}", lambda b=b: JP4.v_grouped_j2(b), True) for b in (4, 8)],
    *[(p4, f"grouped_j1j2_{b}_{b}", lambda b=b: JP4.v_grouped_j1j2(b, b), True) for b in (8, 16)],
    *[(p4, f"plain4d_{b}_{b}", lambda b=b: JP4.v_plain4d(b, b), True) for b in (8, 16)],
    *[(p4, f"t2d_{th}x{tw}", lambda: JP4.v_2d_transpose_ref(64), True) for th, tw in p4.T2D_TILES],
    *[(p4, f"dma4d_c{c}", lambda c=c: JP4.v_dma4d(c), True) for c in (4, 8, 16)],
    *[(pp, f"{name}_{b}_{c}", lambda f=f, b=b, c=c: getattr(JPP, f)(b, c), False)
      for name, f, b, c in (("direct", "v_direct", 8, 8), ("3stage", "v_3stage", 8, 8),
                            ("3stage", "v_3stage", 16, 16), ("2stage", "v_2stage_batch", 8, 8),
                            ("2stage", "v_2stage_batch", 16, 16),
                            ("loop_rank3", "v_loop_rank3", 8, 8))],
    *[(pp, f"{name}_{k}_{b}", lambda f=f, k=k, b=b: getattr(JPP, f)(k, b), False)
      for name, f in (("direct_m", "v_direct_m"), ("2stage_m", "v_2stage_m"),
                      ("3stage_m", "v_3stage_m"))
      for k, b in ((4, 8), (8, 16))],
]


@pytest.mark.parametrize("script, name, make, force", CASES,
                         ids=[f"{c[0].__name__.rsplit('.', 1)[1]}-{c[1]}" for c in CASES])
def test_variant_matches_the_tpu_probe(script, name, make, force):
    x = _input(len(name))
    fn, plain = script.variants()[name]
    got = _port(fn, x)
    np.testing.assert_array_equal(got, _jax(make(), x, force))
    np.testing.assert_array_equal(got, plain(torch.from_numpy(x)).numpy())
    if name.startswith("nocompute"):
        np.testing.assert_array_equal(got, np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3))))
    elif name.startswith("t2d"):
        np.testing.assert_array_equal(got.reshape(D * D, D * D), x.reshape(D * D, D * D).T)
    else:
        np.testing.assert_array_equal(got, _rev(x))


def test_mxu_default_rounds_to_bf16_as_the_tpu_does():
    """The port's default is ``bf16(x)`` reversed (the TPU's DEFAULT rounds
    to bf16); JAX's interpret mode on the CPU is exact, so the JAX body is
    compared at "highest"."""
    x = _input(7)
    got = _port(p2.variants()["mxu_default_8_8"][0], x)
    want = torch.from_numpy(x).to(torch.bfloat16).float().permute(3, 2, 1, 0).contiguous()
    np.testing.assert_array_equal(got, want.numpy())
    assert not np.array_equal(got, _rev(x))  # bf16 rounding is visible
    np.testing.assert_array_equal(_jax(JP2.v_mxu(8, 8, precision="highest"), x), _rev(x))
    high = _port(lambda t: pk.rev4_mma(t, pk.J2J1, 8, 8, "highest"), x)
    np.testing.assert_array_equal(high, _rev(x))


@pytest.mark.parametrize("tpu", [JP2, JPP], ids=["exp_perm2", "exp_perm_probe"])
def test_engine_row_matches_jax_and_records_its_route(tpu):
    from strided_tpu.core import executor_pallas

    x = _input(11)
    executor_pallas.LAST_PLAN.clear()
    jgot = np.asarray(tpu.engine_rank4(jnp.asarray(x)))
    assert not executor_pallas.LAST_PLAN  # 16^4 is below the JAX map gate: XLA
    before = dict(pk.LAUNCHES)
    got, route = pk.engine_reversal(torch.from_numpy(x))
    assert route == "plain" and pk.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(jgot, _rev(x))


def test_variant_names_follow_the_tpu_scripts():
    """Every TPU variant has a port row of its name; the TPU's tile-named
    2-D transposes become rows named after the card's tiles, ``xla``
    becomes ``plain``."""
    tpu4 = {n for n in JP4.VARIANTS if not n.startswith("t2d")}
    assert tpu4 <= set(p4.variants())
    assert {f"t2d_{th}x{tw}" for th, tw in p4.T2D_TILES} <= set(p4.variants())
    assert len(p2.variants()) == 13 and "plain" in p2.variants()
    assert len(pp.variants()) == 17 and "plain" in pp.variants()


@pytest.mark.parametrize("call, err", [
    (lambda x: pk.rev4_tiles(x, pk.J2J1, 3, 8), ValueError),  # D not a multiple of the run
    (lambda x: pk.rev4_tiles(x, pk.J3J2, 4, 8, pk.BLOCK), ValueError),  # no J3J2 kernel
    (lambda x: pk.rev4_tiles(x, pk.J2J1, 8, 8, pk.BLOCK, copy=True), ValueError),
    (lambda x: pk.rev4_tiles(x[..., :8].contiguous(), pk.J2J1, 8, 8), ValueError),
    (lambda x: pk.rev4_tiles(x.double(), pk.J2J1, 8, 8), TypeError),
    (lambda x: pk.rev4_tiles(x, 2, 8, 8), ValueError),
    (lambda x: pk.rev4_mma(x, pk.J2J1, 5, 8), ValueError),
    (lambda x: pk.rev4_mma(x, pk.J3J2, 8, 8), ValueError),  # J3J2 takes whole planes
    (lambda x: pk.rev4_mma(x, pk.J2J1, 8, 8, "high"), ValueError),
    (lambda x: pk.rev4_async(x, 6), ValueError),
    (lambda x: pk.rev4_async(x.transpose(0, 1), 4), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call(torch.from_numpy(_input()))


def test_run_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    for mod in (p2, p4, pp):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(d=D)


def test_perm_probe_modules_import_no_jax():
    code = ("import sys\n"
            "from strided_tpu_torch.benchmarks import exp_perm2, exp_perm4, exp_perm_probe\n"
            "from strided_tpu_torch.benchmarks import exp_reduce, perm_kernels\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


@pytest.mark.parametrize("script, name, make, force", CASES,
                         ids=[f"{c[0].__name__.rsplit('.', 1)[1]}-{c[1]}" for c in CASES])
def test_variant_written_through_out_matches_the_tpu_probe(script, name, make, force):
    """Each variant written into a NaN-filled ``out=`` (as the card's checks
    write it) equals the JAX probe and fills ``out``."""
    x = _input(len(name) + 1)
    fn, _plain = script.variants()[name]
    out = torch.full((D,) * 4, float("nan"))
    got = _port(lambda t: fn(t, out=out), x)
    assert not np.isnan(out.numpy()).any()
    np.testing.assert_array_equal(got, out.numpy())
    np.testing.assert_array_equal(got, _jax(make(), x, force))


def _square(x):
    return x.reshape(D * D, D * D)


def _sym(a):
    return (a + a.T) * np.float32(0.5)


# each wrapper with an ``out=``: (its input made from the 4-D seeded input,
# call(input, out), the plain result as numpy)
def _out_wrappers():
    from strided_tpu_torch.benchmarks import exp_sym as es

    same = lambda x: x  # noqa: E731
    return {
        "rev4_tiles": (same, lambda a, out: pk.rev4_tiles(a, pk.J3J2, 8, 8, pk.BLOCK, out=out),
                       _rev),
        "rev4_mma": (same, lambda a, out: pk.rev4_mma(a, pk.J2J1, 8, 8, out=out), _rev),
        "rev4_async": (same, lambda a, out: pk.rev4_async(a, 4, out=out), _rev),
        "transpose_tiles": (_square, lambda a, out: es.transpose_tiles(a, 32, out=out),
                            lambda a: a.T),
        "sym_two_read": (_square, lambda a, out: es.sym_two_read(a, 64, out=out), _sym),
        "pair_tiles": (_square, lambda a, out: es.pair_tiles(a, 32, out=out), _sym),
    }


OUT_WRAPPERS = ["rev4_tiles", "rev4_mma", "rev4_async", "transpose_tiles", "sym_two_read",
                "pair_tiles"]


@pytest.mark.parametrize("wrapper", OUT_WRAPPERS)
def test_out_is_written_and_returned(wrapper):
    make, call, want = _out_wrappers()[wrapper]
    a = make(torch.from_numpy(_input(3)))
    out = torch.full_like(a, float("nan"))
    before = dict(pk.LAUNCHES)
    res = call(a, out)
    assert res is out and pk.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), want(a.numpy()))


@pytest.mark.parametrize("bad", ["shape", "dtype", "overlap", "strided"])
@pytest.mark.parametrize("wrapper", OUT_WRAPPERS)
def test_out_refuses_a_wrong_tensor(wrapper, bad):
    """A wrong shape, dtype or layout, or an ``out`` that shares bytes with
    the input (half of it here), is refused with ``ValueError``."""
    make, call, _want = _out_wrappers()[wrapper]
    a = make(torch.from_numpy(_input(4)))
    n = a.numel()
    if bad == "overlap":
        buf = torch.zeros(n * 3 // 2)
        buf[:n].copy_(a.flatten())
        a, out = buf[:n].view(a.shape), buf[n // 2:].view(a.shape)
    else:
        out = {"shape": lambda: torch.zeros(n // 2).view(a.shape[0] // 2, *a.shape[1:]),
               "dtype": lambda: torch.zeros_like(a, dtype=torch.float64),
               "strided": lambda: torch.zeros_like(a).transpose(0, 1)}[bad]()
    with pytest.raises(ValueError):
        call(a, out)


def _tiles_requests():
    """``(geometry, ra, staging, copy)`` of every ``rev4_tiles`` call the
    three scripts' variants make, recorded by a stand-in for the wrapper."""
    seen = set()

    def record(x, geometry, ra, rb, staging=pk.PLANE, copy=False, out=None):
        seen.add(pk.tiles_instance(geometry, ra, staging, copy))
        return x

    x = torch.empty((pk.KERNEL_D,) * 4, device="meta")
    for script in (p2, p4, pp):
        saved = script.rev4_tiles
        script.rev4_tiles = record
        try:
            for name, (fn, _plain) in script.variants().items():
                if "rev4_tiles" in _kernel_of(name):
                    fn(x)
        finally:
            script.rev4_tiles = saved
    return seen


def _kernel_of(name):
    if name.startswith("mxu"):
        return "rev4_mma"
    if name.startswith(("dma4d", "t2d")) or name == "plain":
        return "other"
    return "rev4_tiles"


def _source_instances():
    """``(geometry, E3, staging, copy)`` of every ``tiles_launch`` branch of
    ``csrc/exp_perm.cu``'s dispatchers, and the one ``rev4_async`` takes."""
    import re

    src = (ROOT / "strided_tpu_torch" / "csrc" / "exp_perm.cu").read_text()
    names = {"J2J1": pk.J2J1, "J3J2": pk.J3J2, "PLANE": pk.PLANE, "BLOCK": pk.BLOCK,
             "D": pk.KERNEL_D, "true": True, "false": False}
    found = {}
    for fn in ("strided_rev4_tiles", "strided_rev4_async"):
        body = src[src.index(f'extern "C" int {fn}('):]
        body = body[:body.index("\n}\n")]
        found[fn] = {tuple(names[v] if v in names else int(v) for v in m)
                     for m in re.findall(r"tiles_launch<(\w+), (\w+), (\w+), (\w+)>", body)}
    return found


def test_every_variant_has_a_kernel_instance_in_the_source():
    """Every (geometry, E3, staging, copy) the scripts' variants ask of
    ``rev4_tiles`` has a dispatch branch in ``csrc/exp_perm.cu``, the
    wrapper's instance list and J3J2 heights are the source's, and
    ``rev4_async`` runs the J2J1 PLANE instance: no variant meets
    ``cudaErrorInvalidValue`` on the card."""
    found = _source_instances()
    requests = _tiles_requests()
    assert len(requests) >= 6
    assert requests <= found["strided_rev4_tiles"]
    assert set(pk.TILES_INSTANCES) == found["strided_rev4_tiles"]
    assert len(pk.TILES_INSTANCES) == len(set(pk.TILES_INSTANCES))
    assert {e for g, e, _s, _c in found["strided_rev4_tiles"] if g == pk.J3J2} \
        == set(pk.J3J2_HEIGHTS)
    assert found["strided_rev4_async"] == {pk.tiles_instance(pk.J2J1, pk.KERNEL_D)}
