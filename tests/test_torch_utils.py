"""The port's ``utils`` (checkpoint and profiling) on the CPU: the
reference's own checks of ``tests/test_quality.py`` on the port, and
checkpoints crossing between the two packages bit for bit."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu.utils as jutils  # noqa: E402
import strided_tpu_torch as stt  # noqa: E402
from strided_tpu_torch.utils import Timer, annotate, load_pytree, save_pytree, trace  # noqa: E402


def _controller():
    Q, R = torch.eye(12, dtype=torch.float64), torch.eye(4, dtype=torch.float64)
    return stt.make_hover_mpc(
        stt.quadrotor(), stt.hover_state(torch.float64, "cpu"),
        stt.hover_input(dtype=torch.float64, device="cpu"), Q, R, Q, horizon=4, dt=0.05)


def _tree(rng):
    return {
        "a": [rng.standard_normal((3, 4)).astype(np.float32),
              (rng.integers(-9, 9, (5,)).astype(np.int32),)],
        "b": rng.standard_normal((2, 2)),
        "c": np.array([True, False]),
    }


def test_checkpoint_roundtrip(tmp_path):
    ctrl = _controller()
    p = str(tmp_path / "ctrl.npz")
    save_pytree(p, ctrl)
    ctrl2 = load_pytree(p, ctrl)
    assert isinstance(ctrl2, stt.LinearMPC) and isinstance(ctrl2.qp, stt.CondensedQP)
    for name in ("A", "B", "Su", "Sx", "H", "M", "K_lqr", "solver"):
        assert torch.equal(getattr(ctrl2.qp, name), getattr(ctrl.qp, name))
    assert (ctrl2.qp.rho, ctrl2.qp.N, ctrl2.admm_iters, ctrl2.constrained) == (
        ctrl.qp.rho, ctrl.qp.N, ctrl.admm_iters, ctrl.constrained)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2, (8, 12)))
    assert torch.equal(ctrl2.control(x)[0], ctrl.control(x)[0])
    # structure mismatch must raise
    with pytest.raises(ValueError):
        load_pytree(p, {"not": "a controller", "x": torch.zeros(3)})


def test_controller_key_paths(tmp_path):
    p = str(tmp_path / "ctrl.npz")
    save_pytree(p, _controller())
    meta = json.loads(bytes(np.load(p)["__manifest__"]).decode())
    assert meta["nleaves"] == 12
    assert meta["paths"][:2] == [".qp.A", ".qp.B"] and meta["paths"][-1] == ".u_max"
    assert meta["leaves"][0] == {"shape": [12, 12], "dtype": "float64"}


def test_checkpoint_rejects_a_different_key_path_or_leaf(tmp_path):
    rng = np.random.default_rng(1)
    tree = {k: torch.as_tensor(v) for k, v in (("a", rng.standard_normal(3)),
                                                 ("b", rng.standard_normal(3)))}
    p = str(tmp_path / "t.npz")
    save_pytree(p, tree)
    with pytest.raises(ValueError, match="saved key path \"\\['a'\\]\", expected \"\\['z'\\]\""):
        load_pytree(p, {"z": tree["a"], "b": tree["b"]})
    with pytest.raises(ValueError, match="leaf 1 mismatch: saved float64\\[3\\], expected "
                                         "float32\\[3\\]"):
        load_pytree(p, {"a": tree["a"], "b": tree["b"].float()})


def test_load_puts_each_leaf_on_the_device_of_like(tmp_path):
    tree = {"x": torch.arange(4.0), "y": np.arange(3)}
    p = str(tmp_path / "t.npz")
    save_pytree(p, tree)
    got = load_pytree(p, tree)
    assert isinstance(got["x"], torch.Tensor) and got["x"].device == tree["x"].device
    assert got["y"].device.type == "cpu" and got["y"].dtype == torch.int64


def test_bfloat16_has_no_numpy_dtype(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_pytree(str(tmp_path / "t.npz"), [torch.zeros(2, dtype=torch.bfloat16)])


def test_a_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    tree = _tree(np.random.default_rng(2))
    p = str(tmp_path / "jax.npz")
    jutils.save_pytree(p, {"a": [jnp.asarray(tree["a"][0]), (jnp.asarray(tree["a"][1][0]),)],
                           "b": jnp.asarray(tree["b"]), "c": jnp.asarray(tree["c"])})
    like = {"a": [torch.zeros(3, 4), (torch.zeros(5, dtype=torch.int32),)],
            "b": torch.zeros(2, 2, dtype=torch.float64), "c": torch.zeros(2, dtype=torch.bool)}
    got = load_pytree(p, like)
    for g, w in ((got["a"][0], tree["a"][0]), (got["a"][1][0], tree["a"][1][0]),
                 (got["b"], tree["b"]), (got["c"], tree["c"])):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_a_port_checkpoint_loads_into_jax_bit_for_bit(tmp_path):
    tree = _tree(np.random.default_rng(3))
    p = str(tmp_path / "port.npz")
    save_pytree(p, {"a": [torch.as_tensor(tree["a"][0]), (torch.as_tensor(tree["a"][1][0]),)],
                    "b": torch.as_tensor(tree["b"]), "c": torch.as_tensor(tree["c"])})
    got = jutils.load_pytree(p, tree)
    for g, w in ((got["a"][0], tree["a"][0]), (got["a"][1][0], tree["a"][1][0]),
                 (got["b"], tree["b"]), (got["c"], tree["c"])):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_profiling_timer_and_annotation():
    out = []
    with Timer("phase", sink=out.append):
        with annotate("inner"):
            _ = torch.ones(8) + 1
    assert out and "phase" in out[0]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        with annotate("strided-trace-range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(d, "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "strided-trace-range" for e in events)


def test_checkpoint_legacy_per_leaf_validation(tmp_path):
    """A checkpoint without a manifest with the SAME leaf count but
    different per-leaf shapes/dtypes is rejected, not mis-assigned."""
    p = str(tmp_path / "legacy.npz")
    tree = {"a": np.zeros((3, 4), np.float32), "b": np.ones(5, np.int32)}
    np.savez(p, leaf_0=tree["a"], leaf_1=tree["b"])
    with pytest.warns(UserWarning, match="without a manifest"):
        got = load_pytree(p, tree)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    bad = {"a": np.zeros((4, 3), np.float32), "b": np.ones(5, np.int32)}
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        load_pytree(p, bad)
    bad2 = {"a": np.zeros((3, 4), np.float64), "b": np.ones(5, np.int32)}
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        load_pytree(p, bad2)
    with pytest.raises(ValueError, match="saved 2 leaves, expected 1"):
        load_pytree(p, {"a": tree["a"]})
