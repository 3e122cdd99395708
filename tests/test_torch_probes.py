"""Parity of the port's transpose-pair probes (strided_tpu_torch.benchmarks)
with the JAX package's TPU probe scripts (benchmarks/exp_sym.py and
benchmarks/exp_pair_rect.py, imported by path), on the same seeded numpy
input at n <= 768. On the CPU each port wrapper runs its plain PyTorch
version; the JAX probes run their Pallas kernels in interpret mode
(``v_pair`` by itself, the others under ``force_tpu_interpret_mode``).
Every comparison is exact: the outputs are data movement, or one add and
one multiply by 0.5. ``rect_pairs`` leaves the band no supertile covers
unwritten, so it is compared on the covered band, with the supertile count.
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

from strided_tpu_torch.benchmarks import exp_pair_rect as er  # noqa: E402
from strided_tpu_torch.benchmarks import exp_sym as es  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSYM = _load("exp_sym")
JRECT = _load("exp_pair_rect")


def _input(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)


def _jax(fn, x):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x)))


def _port(fn, x):
    before = dict(es.LAUNCHES)
    got = fn(torch.from_numpy(x)).numpy()
    assert es.LAUNCHES == before  # CPU tensors never launch a kernel
    return got


@pytest.mark.parametrize("th, tw", [(32, 32), (64, 64), *es.RECT_TILES])
def test_transpose_tiles_matches_the_tpu_probe(th, tw):
    x = _input(256)
    jfn = JSYM.v_pallas_t2d(th) if th == tw else JSYM.v_pallas_t2d_rect(th, tw)
    got = _port(lambda a: es.transpose_tiles(a, th, tw), x)
    np.testing.assert_array_equal(got, _jax(jfn, x))
    np.testing.assert_array_equal(got, x.T)


@pytest.mark.parametrize("tile", es.SQUARE_TILES)
def test_sym_two_read_matches_the_tpu_probe(tile):
    x = _input(256, 1)
    got = _port(lambda a: es.sym_two_read(a, tile), x)
    np.testing.assert_array_equal(got, _jax(JSYM.v_pallas_sym_blockspec(tile), x))


@pytest.mark.parametrize("skip_diag", [False, True])
@pytest.mark.parametrize("do_transpose", [False, True])
@pytest.mark.parametrize("tile", es.SQUARE_TILES)
def test_pair_tiles_matches_the_tpu_probe(tile, do_transpose, skip_diag):
    x = _input(256, 2)
    got = _port(lambda a: es.pair_tiles(a, tile, do_transpose, skip_diag), x)
    want = np.asarray(JSYM.v_pair(tile, do_transpose, skip_diag)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_plain_variants_match_the_tpu_probe():
    """The port's plain versions against the JAX script's XLA variants, and
    every variant (its plain version, here) against the value it is held
    to on the card."""
    x = _input(256, 3)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(es.sym_reference(t).numpy(), np.asarray(JSYM.v_xla_sym(x)))
    np.testing.assert_array_equal(es.transpose_reference(t).numpy(), x.T)
    np.testing.assert_array_equal((t + 1.0).numpy(), np.asarray(JSYM.v_stream(x)))
    for name, (fn, want) in es.variants().items():
        assert torch.equal(fn(t), want(t)), name


@pytest.mark.parametrize("n, T", [(256, 32), (768, 64)])
def test_rect_pairs_matches_the_tpu_probe_on_its_band(n, T):
    x = _input(n, 5)
    with pltpu.force_tpu_interpret_mode():
        jout, jwork = JRECT.rect_pairs(jnp.asarray(x), T=T)
    jout = np.asarray(jout)
    got, nwork = er.rect_pairs(torch.from_numpy(x), T=T)
    assert nwork == jwork == len(er.rect_worklist(n, T))
    band = er.band_mask(n, T, torch.device("cpu")).numpy()
    assert 0 < band.mean() < 1
    got = got.numpy()
    np.testing.assert_array_equal(got[band], jout[band])
    np.testing.assert_array_equal(got[band], ((x + x.T) * np.float32(0.5))[band])
    assert np.isnan(got[~band]).all()  # never written


def test_rect_pairs_writes_into_the_given_output():
    x = torch.from_numpy(_input(128, 6))
    out = torch.full_like(x, -7.0)
    res, nwork = er.rect_pairs(x, out, T=32)
    assert res is out and nwork == len(er.rect_worklist(128, 32))
    band = er.band_mask(128, 32, torch.device("cpu"))
    assert torch.equal(out[band], es.sym_reference(x)[band])
    assert (out[~band] == -7.0).all()
    assert er.LAUNCHES == {"rect_pairs": 0}


def test_traffic_models_match_the_tpu_probe():
    """Rectangles: ``nwork * 4 * T * 2T * 4`` bytes; square pair schedules:
    reads of two tiles a pair, writes of two tiles a pair minus the
    diagonal (benchmarks/exp_pair_rect.py:150-172 at a divisible n)."""
    n = 8064
    for T in er.TILES:
        nb = n // T
        pairs = nb * (nb + 1) // 2
        assert er._square_bytes(n, T) == pairs * 2 * T * T * 4 + (pairs * 2 - nb) * T * T * 4
    V = er.variants(n)
    for T in er.TILES:
        assert V[f"rect_{T}x{2 * T}"][2] == len(er.rect_worklist(n, T)) * 4 * T * (2 * T) * 4
    assert set(V) == {"square_k2", "square_pair_32", "square_pair_64", "rect_32x64",
                      "rect_64x128"}


@pytest.mark.parametrize("call, err", [
    (lambda: es.transpose_tiles(torch.zeros(100, 100)), ValueError),
    (lambda: es.transpose_tiles(torch.zeros(128, 128), 32, 96), ValueError),
    (lambda: es.sym_two_read(torch.zeros(96, 96), 64), ValueError),
    (lambda: es.sym_two_read(torch.zeros(64, 64, dtype=torch.float64)), TypeError),
    (lambda: es.pair_tiles(torch.zeros(64, 32)), ValueError),
    (lambda: es.pair_tiles(torch.zeros(64, 64), 16), ValueError),
    (lambda: er.rect_pairs(torch.zeros(96, 96), T=32), ValueError),
    (lambda: er.rect_pairs(torch.zeros(128, 128), T=128), ValueError),
    (lambda: er.rect_pairs(torch.zeros(128, 128), torch.zeros(64, 64), T=32), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def _offset(t, nbytes):
    """``t``'s values in a contiguous tensor whose base lies ``nbytes`` past
    a 16-byte boundary."""
    k = nbytes // t.element_size()
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[k:k + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("nbytes", [4, 8, 12])
@pytest.mark.parametrize("which", ["a", "out"])
def test_pair_tiles_refuses_a_base_not_16_byte_aligned(which, nbytes):
    x = torch.from_numpy(_input(64, 7))
    a = _offset(x, nbytes) if which == "a" else x
    out = _offset(torch.zeros(64, 64), nbytes) if which == "out" else torch.zeros(64, 64)
    assert a.is_contiguous() and out.is_contiguous()
    with pytest.raises(ValueError, match=f"{which} is not 16-byte aligned"):
        es.pair_tiles(a, 32, out=out)
    assert torch.equal(es.pair_tiles(x, 32, out=torch.zeros(64, 64)), es.sym_reference(x))


def _source_pair_instances():
    """``(tile, do_transpose, skip_diag)`` of every ``pair_tiles_kernel``
    launch that ``csrc/exp_sym.cu``'s ``strided_pair_tiles`` reaches, each
    checked against the condition of its branch."""
    import re

    src = (ROOT / "strided_tpu_torch" / "csrc" / "exp_sym.cu").read_text()
    entry = src[src.index('extern "C" int strided_pair_tiles('):]
    entry = entry[:entry.index("\n}\n")]
    tiles = {int(t) for t in re.findall(r"tile == (\d+)\) return \(int\)pair_launch<\1>", entry)}
    launch = src[src.index("cudaError_t pair_launch("):]
    launch = launch[:launch.index("\n}\n")]
    branches = re.findall(r"(if \((?:do_t && skip_diag|do_t|skip_diag)\)|else) "
                          r"pair_tiles_kernel<T, (\w+), (\w+)><<<", launch)
    conds = {"if (do_t && skip_diag)": (True, True), "if (do_t)": (True, False),
             "if (skip_diag)": (False, True), "else": (False, False)}
    flags = {"true": True, "false": False}
    found = set()
    for cond, do_t, skip in branches:
        assert (flags[do_t], flags[skip]) == conds[cond], (cond, do_t, skip)
        found |= {(t, flags[do_t], flags[skip]) for t in tiles}
    assert len(branches) == 4, branches
    return found


def test_every_pair_tiles_variant_has_a_kernel_instance_in_the_source():
    """Every (tile, do_transpose, skip_diag) the wrapper accepts has its
    dispatch branch in ``csrc/exp_sym.cu``, each branch the instance its
    condition names: no accepted call meets ``cudaErrorInvalidValue`` on the
    card."""
    accepted = {(t, d, k) for t in es.SQUARE_TILES for d in (False, True) for k in (False, True)}
    assert _source_pair_instances() == accepted
    for t, d, k in accepted:  # and the wrapper takes each of them (plain path here)
        x = torch.from_numpy(_input(2 * t, 8))
        assert torch.equal(es.pair_tiles(x, t, d, k), es.pair_reference(x, d))


@pytest.mark.parametrize("row", [0, 37, 127])
def test_run_check_fails_a_kernel_that_leaves_a_row_unwritten(row):
    """``run``'s check writes into a NaN-filled output: a stand-in kernel
    that computes every element but leaves one row of its ``out`` alone
    fails it, and the same stand-in writing every row passes."""
    x = torch.from_numpy(_input(128, 9))

    def skips_a_row(a, out=None):
        full = es.sym_reference(a)
        keep = torch.ones(a.shape[0], dtype=torch.bool)
        keep[row] = False
        out[keep] = full[keep]
        return out

    assert not es.agrees(skips_a_row, es.sym_reference, x)
    assert es.agrees(lambda a, out=None: es.sym_reference(a, out), es.sym_reference, x)


@pytest.mark.parametrize("name", list(es.variants()))
def test_every_variant_writes_its_result_into_out(name):
    """Each variant of ``run`` takes ``out=`` and passes ``run``'s check
    (its plain path, here)."""
    fn, want = es.variants()[name]
    x = torch.from_numpy(_input(256, 10))
    assert es.agrees(fn, want, x), name


def test_run_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    for mod in (es, er):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(n=256)


def test_probe_modules_import_no_jax():
    code = ("import sys\n"
            "import strided_tpu_torch.benchmarks.exp_sym, strided_tpu_torch.benchmarks.exp_pair_rect\n"
            "import strided_tpu_torch.linalg\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
