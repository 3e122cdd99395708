"""Parity of the port's streaming-reduction probe
(strided_tpu_torch.benchmarks.exp_reduce) with the JAX package's TPU probe
script (benchmarks/exp_reduce.py, imported by path), on the same seeded
numpy input at n = 512 with the slabs (256, 256) and (128, 512). On the CPU
the port's wrapper runs its plain version; the JAX ``stream_sum_axis0``
runs its Pallas kernel under ``force_tpu_interpret_mode``. Sums are held to
K3's tolerance, ``1e-6 * rows * max|a|`` (the summation order differs),
against each other and against the f64 sum; with compute off both return
``A[0]`` exactly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from strided_tpu_torch.benchmarks import exp_reduce as er  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 512


def _load():
    spec = importlib.util.spec_from_file_location("tpu_probe_exp_reduce",
                                                  ROOT / "benchmarks" / "exp_reduce.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JRED = _load()


def _input(seed=0):
    return np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)


def _tol(x):
    return 1e-6 * x.shape[0] * np.abs(x).max()


@pytest.mark.parametrize("compute", [True, False])
@pytest.mark.parametrize("R, C", [(256, 256), (128, 512)])
def test_stream_sum_slabs_matches_the_tpu_probe(R, C, compute):
    x = _input(R + C)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JRED.stream_sum_axis0(jnp.asarray(x), R=R, C=C, compute=compute))
    before = dict(er.LAUNCHES)
    got = er.stream_sum_slabs(torch.from_numpy(x), R, C, compute).numpy()
    assert er.LAUNCHES == before  # CPU tensors never launch a kernel
    assert got.shape == want.shape == (N,)
    if not compute:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x[0])
        return
    f64 = x.astype(np.float64).sum(0)
    tol = _tol(x)
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - f64).max() <= tol
    assert np.abs(want - f64).max() <= tol


def test_variants_hold_their_plain_results():
    """Every variant at a size its slabs divide, with the plain and f64
    sums (``sum_error``), and ``nocompute`` exactly ``A[0]``."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1024, 8192)).astype(np.float32))
    for name, (fn, want) in er.variants().items():
        got = fn(x)
        if name.startswith("nocompute"):
            assert torch.equal(got, x[0]) and torch.equal(got, want(x)), name
        else:
            e_plain, e64, tol = er.sum_error(got, x)
            assert e_plain <= tol and e64 <= tol, name
    assert er.LAUNCHES == {"stream_sum_slabs": 0}
    assert set(er.variants()) == {"plain", "k3", *(f"{k}_{R}x{C}" for k in ("stream", "nocompute")
                                                   for R, C in er.SLABS)}


@pytest.mark.parametrize("call, err", [
    (lambda: er.stream_sum_slabs(torch.zeros(384, 512), 256, 256), ValueError),  # n % R
    (lambda: er.stream_sum_slabs(torch.zeros(512, 640), 256, 256), ValueError),  # m % C
    (lambda: er.stream_sum_slabs(torch.zeros(512, 512), 64, 256), ValueError),  # no kernel R
    (lambda: er.stream_sum_slabs(torch.zeros(512, 480), 256, 160), ValueError),  # C % 128
    (lambda: er.stream_sum_slabs(torch.zeros(512, 512).T, 256, 256), ValueError),
    (lambda: er.stream_sum_slabs(torch.zeros(512), 256, 256), ValueError),
    (lambda: er.stream_sum_slabs(torch.zeros(512, 512, dtype=torch.float64), 256, 256), TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(call, err):
    with pytest.raises(err):
        call()


def test_run_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        er.run(n=N)
