"""The port's size gates and the measurement layer that sets them, on the
CPU: ``exp_crossover.pick_gate`` on hand-made tables, the rotation count
against the L2 size, the records' no-measurement marking, the gates'
defaults, the vendor products reading a lazily transposed dense operand as
the caller's storage (flipped, conjugated and gapped views materialized
first, values as the JAX package's), each benchmark script's refusal to
run without CUDA, and that none of them imports JAX or the JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
from strided_tpu_torch import bench, config as tcfg, linalg as tla  # noqa: E402
from strided_tpu_torch.benchmarks import exp_crossover as xc, exp_mapgate as mg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_SCRIPTS = ("sweeps", "exp_crossover", "exp_mapgate", "exp_contract", "exp_mul",
               "exp_mpc_prec")


def _rows(table):
    """Rows from ``(elements, kernel eager, plain eager, kernel device,
    plain device)`` tuples."""
    keys = ("elements", "kernel_ms", "plain_ms", "kernel_device_ms", "plain_device_ms")
    return [dict(zip(keys, t)) for t in table]


def test_pick_gate_clean_crossover_rounds_up_to_a_power_of_two():
    rows = _rows([(256 ** 2, 2, 1, 2, 1), (362 ** 2, 2, 1, 2, 1), (512 ** 2, 1, 2, 1, 2),
                  (724 ** 2, 1, 2, 1, 2), (1024 ** 2, 1, 2, 1, 2)])
    gate, note = xc.pick_gate(rows)
    assert gate == 1 << 18 and "262144" in note
    rows[2]["elements"] = 362 ** 2 + 1  # a crossover between powers of two rounds up
    rows[1]["elements"] = 300 ** 2
    assert xc.pick_gate(rows)[0] == 1 << 17


def test_pick_gate_when_the_kernel_never_wins():
    rows = _rows([(1 << 16, 2, 1, 2, 1), (1 << 20, 2, 1, 2, 1), (1 << 26, 1.1, 1, 0.5, 1)])
    gate, note = xc.pick_gate(rows)
    assert gate == 1 << 27 and gate > max(r["elements"] for r in rows)
    assert "never wins" in note


def test_pick_gate_a_dip_above_the_crossover_moves_it_up():
    rows = _rows([(1 << 16, 2, 1, 2, 1), (1 << 18, 1, 2, 1, 2), (1 << 20, 2, 1, 1, 2),
                  (1 << 22, 1, 2, 1, 2), (1 << 24, 1, 2, 1, 2)])
    assert xc.pick_gate(rows)[0] == 1 << 22


@pytest.mark.parametrize("k_eager,p_eager,k_dev,p_dev", [
    (1, 2, 3, 2),  # wins eagerly, loses on the device
    (3, 2, 1, 2),  # the other way
    (1, 2, None, 2),  # no device time: not a win
])
def test_pick_gate_needs_eager_and_device_to_agree(k_eager, p_eager, k_dev, p_dev):
    rows = _rows([(1 << 16, 1, 2, 1, 2), (1 << 18, k_eager, p_eager, k_dev, p_dev),
                  (1 << 20, 1, 2, 1, 2)])
    assert xc.pick_gate(rows)[0] == 1 << 20
    assert xc.pick_gate(_rows([(1 << 16, 1, 2, 1, 2), (1 << 18, 1, 1, 1, 1)]))[0] == 1 << 16


def test_pick_gate_a_size_must_win_in_every_run():
    run1 = _rows([(1 << 16, 2, 1, 2, 1), (1 << 18, 1, 2, 1, 2), (1 << 20, 1, 2, 1, 2)])
    run2 = _rows([(1 << 16, 2, 1, 2, 1), (1 << 18, 2, 1, 1, 2), (1 << 20, 1, 2, 1, 2)])
    assert xc.pick_gate(run1)[0] == 1 << 18
    assert xc.pick_gate(run1 + run2)[0] == 1 << 20
    with pytest.raises(ValueError):
        xc.pick_gate([])


def test_gates_take_the_largest_pick_of_their_variants():
    win = (1, 2, 1, 2)
    rows = []
    for variant, crossover in (("sym", 1 << 22), ("sym_bf16", 1 << 20), ("scaleT", 1 << 26)):
        for e in (1 << 16, 1 << 20, 1 << 22, 1 << 24):
            t = win if e >= crossover else (2, 1, 2, 1)
            rows.append({"family": "pair", "variant": variant, **_rows([(e, *t)])[0]})
    g = xc.gates(rows)
    assert g["pair_kernel_min_elements"]["value"] == 1 << 22
    assert g["pair_kernel_min_elements"]["picks"] == {"sym": 1 << 22, "sym_bf16": 1 << 20}
    assert "min_stream_reduce_elements" not in g
    maps = [{"workload": w, **r} for w, c in (("scaleT", 1 << 24), ("rev4", 1 << 18))
            for r in _rows([(e, *(win if e >= c else (2, 1, 2, 1)))
                            for e in (1 << 16, 1 << 18, 1 << 24)])]
    g = mg.gates(maps)
    assert g["map_min_elements"]["value"] == 1 << 24
    assert g["min_kernel_elements"]["value"] == 1 << 18


def test_read_rows_takes_the_json_lines_of_earlier_runs(tmp_path):
    log = tmp_path / "run.log"
    rows = [{"family": "pair", "variant": "sym", **r}
            for r in _rows([(1 << 16, 2, 1, 2, 1), (1 << 22, 1, 2, 1, 2)])]
    log.write_text("build 40 s\n" + '{"card": "x"}\n'
                   + "".join(json.dumps(r) + "\n" for r in rows)
                   + '{"gates": {}}\n')
    assert xc.read_rows([log], "variant") == rows
    assert xc.gates(xc.read_rows([log, log], "variant"))["pair_kernel_min_elements"][
        "value"] == 1 << 22


def test_the_ladders_span_two_to_the_16_to_26_elements():
    assert xc.LADDER[0] == 256 and xc.LADDER[-1] == 8192 and len(xc.LADDER) == 11
    assert [n * n for n in xc.LADDER][::2] == [1 << k for k in range(16, 27, 2)]
    assert {4000, 5120} <= set(xc.SIZES) and {6144, 8192} <= set(mg.SCALE_SIZES)
    assert mg.REV4_SIDES == (16, 24, 32, 48, 64)


@pytest.mark.parametrize("copy_bytes,operands", [
    (256 * 256 * 4, 1), (8192 * 8192 * 4, 1), (4000 * 4000 * 4, 2), (1, 1), (10 ** 9, 2),
])
def test_rotation_count_exceeds_four_l2s(copy_bytes, operands):
    l2 = bench.L2_BYTES_ASSUMED
    m = bench.rotation_count(copy_bytes, l2, operands)
    assert m * copy_bytes > 4 * l2  # no call finds its input in L2
    assert m >= 2 * operands and m % operands == 0
    assert (m - operands) * copy_bytes <= 4 * l2 or m == 2 * operands  # no more than needed


def test_rotated_copies_are_equal_and_distinct():
    x = torch.randn(512, 512)
    copies = bench.rotated(x, l2=4 * 2 ** 20)
    assert len(copies) == bench.rotation_count(512 * 512 * 4, 4 * 2 ** 20) == 17
    assert copies[0] is x and all(torch.equal(c, x) for c in copies)
    assert len({c.data_ptr() for c in copies}) == len(copies)


def test_rotating_ms_refuses_a_rotation_of_one_call():
    one = [torch.zeros(1)]
    for inputs, ops in ((one, 1), (one * 3, 2), (one * 2, 2)):
        with pytest.raises(ValueError, match="operand"):
            bench.rotating_ms(lambda *a: None, inputs, operands=ops)


def test_rate_notes_mark_no_measurement_and_unrotated_operands():
    assert bench.rate_notes(gbs=3000.0, tflops=50.0) == []
    (note,) = bench.rate_notes(gbs=3400.0)
    assert note.startswith("no-measurement") and "3400" in note
    (note,) = bench.rate_notes(tflops=70.0)
    assert note.startswith("no-measurement") and "TFLOP/s" in note
    (note,) = bench.rate_notes(unrotated_bytes=4 * 2 ** 20, l2=50 * 2 ** 20)
    assert "not rotated" in note
    assert bench.rate_notes(unrotated_bytes=100 * 2 ** 20, l2=50 * 2 ** 20) == []


def test_the_default_gates_are_the_cards_crossovers():
    """The four gates as set from the card's crossovers (PERF.md): powers
    of two, K4's floor never above its map gate; the JAX package's stay
    the TPU's."""
    from strided_tpu import config as jcfg

    c = tcfg.Config()
    gates = (c.min_kernel_elements, c.map_min_elements, c.pair_kernel_min_elements,
             c.min_stream_reduce_elements)
    assert gates == (1 << 25, 1 << 26, 1 << 22, 1 << 26)
    assert all(g & (g - 1) == 0 for g in gates)
    assert c.min_kernel_elements <= c.map_min_elements
    assert not c.kernel_reductions and not c.aligned_maps
    j = jcfg.Config()
    assert (j.pallas_map_min_elements, j.pair_kernel_min_elements) == (1 << 25, 1 << 22)


# ---------------------------------------------------------------------------
# the vendor products read a dense lazy operand where it lies
# ---------------------------------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    """Each tensor argument ``torch.matmul`` and ``torch.einsum`` receive."""
    seen = []
    real_matmul, real_einsum = torch.matmul, torch.einsum

    def matmul(a, b, *args, **kw):
        seen.extend([a, b])
        return real_matmul(a, b, *args, **kw)

    def einsum(eq, *ops, **kw):
        seen.extend(ops)
        return real_einsum(eq, *ops, **kw)

    monkeypatch.setattr(torch, "matmul", matmul)
    monkeypatch.setattr(torch, "einsum", einsum)
    return seen


def _f64(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_mul_and_contract_read_a_lazy_transpose_as_the_callers_storage(spy):
    a, b = _f64((6, 5), 1), _f64((6, 4), 2)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    C = tst.strided(torch.zeros(5, 4, dtype=torch.float64))
    got = tst.to_array(tla.mul(C, tst.transpose(tst.strided(at)), tst.strided(bt)))
    A, B = spy[0], spy[1]
    assert A.data_ptr() == at.data_ptr() and A.stride() == (1, 5) and tuple(A.shape) == (5, 6)
    assert B.data_ptr() == bt.data_ptr()
    want = np.asarray(jst.to_array(jst.mul(jst.strided(jnp.zeros((5, 4))),
                                           jst.transpose(jst.strided(jnp.asarray(a))),
                                           jst.strided(jnp.asarray(b)))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    spy.clear()
    got = tla.contract("ab,bc->ac", tst.transpose(tst.strided(at)), tst.strided(bt))
    assert spy[0].data_ptr() == at.data_ptr() and spy[0].stride() == (1, 5)
    want = np.asarray(jst.contract("ab,bc->ac", jst.transpose(jst.strided(jnp.asarray(a))),
                                   jst.strided(jnp.asarray(b))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_a_dense_block_at_an_offset_and_a_lazy_reshape_are_read_in_place(spy):
    """Rows 1-3 of a parent (an offset, no gap) and a 3-D view reshaped to
    2-D for a contraction: no copy."""
    x = torch.from_numpy(_f64((6, 5), 3))
    rows = tst.sview(tst.strided(x), (slice(1, 4),))
    tla.contract("ab,bc->ac", rows, tst.strided(torch.ones(5, 2, dtype=torch.float64)))
    assert spy[0].data_ptr() == x.data_ptr() + 5 * 8
    spy.clear()
    y = torch.from_numpy(_f64((4, 3, 2), 4))
    flat = tst.sreshape(tst.strided(y), (4, 6))
    got = tst.to_array(tla.mul(tst.strided(torch.zeros(6, 6, dtype=torch.float64)),
                               tst.transpose(flat), flat))
    assert spy[0].data_ptr() == spy[1].data_ptr() == y.data_ptr()
    np.testing.assert_allclose(got.numpy(), (y.reshape(4, 6).T @ y.reshape(4, 6)).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["flipped", "conjugated", "gapped"])
def test_flipped_conjugated_and_gapped_operands_still_materialize(spy, kind):
    """These layouts reach the product as a new dense tensor (no view of the
    caller's storage), with the JAX package's values."""
    a = _f64((6, 6), 5) + (1j * _f64((6, 6), 6) if kind == "conjugated" else 0)
    b = _f64((6, 6), 7) + (1j * _f64((6, 6), 8) if kind == "conjugated" else 0)
    make = {"flipped": lambda m, v: m.flip(v, 0), "conjugated": lambda m, v: m.conj(v),
            "gapped": lambda m, v: m.sview(v, (slice(None), slice(1, 4)))}[kind]
    at = torch.from_numpy(a)
    bv = b[:3] if kind == "gapped" else b
    got = tla.contract("ab,bc->ac", make(tst, tst.strided(at)), tst.strided(torch.from_numpy(bv)))
    assert spy[0].data_ptr() != at.data_ptr() and spy[0].is_contiguous()
    want = np.asarray(jst.contract("ab,bc->ac", make(jst, jst.strided(jnp.asarray(a))),
                                   jst.strided(jnp.asarray(bv))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    spy.clear()
    C = tst.strided(torch.zeros(6, bv.shape[1], dtype=at.dtype))
    tla.mul(C, make(tst, tst.strided(at)), tst.strided(torch.from_numpy(bv)))
    assert spy[0].data_ptr() != at.data_ptr() and spy[0].is_contiguous()


# ---------------------------------------------------------------------------
# the scripts need the card and import nothing of JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_each_script_refuses_to_run_without_cuda(name):
    """``python -m strided_tpu_torch.benchmarks.<name>`` with no arguments
    raises before it times anything: no CPU fallback."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    main = importlib.import_module(f"strided_tpu_torch.benchmarks.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_the_scripts_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import strided_tpu_torch.benchmarks.{n}\n" for n in NEW_SCRIPTS)
            + "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "assert not any(m.startswith('strided_tpu.') or m == 'strided_tpu' "
            "for m in sys.modules)\n"
            "assert not any(m.startswith('benchmarks') for m in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
