"""Parity of the port's view algebra (strided_tpu_torch.core.view and
core.regularize) with the JAX package's, on the same numpy inputs.

Views and copies are exact: every comparison here is equality (no
tolerance). Layout metadata (shape, strides, offset) and ``decompose``'s
output must be equal too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strided_tpu as jst  # noqa: E402
import strided_tpu_torch as tst  # noqa: E402
from strided_tpu.core import regularize as jreg  # noqa: E402
from strided_tpu.core.view import StridedView as JView  # noqa: E402
from strided_tpu_torch.core import regularize as treg  # noqa: E402
from strided_tpu_torch.core.view import StridedView as TView  # noqa: E402


def _both(a: np.ndarray):
    return jst.strided(jnp.asarray(a)), tst.strided(torch.from_numpy(np.array(a)))


def _dec(mod, shape, strides, offset):
    return dataclasses.astuple(mod.decompose(shape, strides, offset))


def _same_layout(jv, tv):
    assert tuple(jv.shape) == tuple(tv.shape)
    assert tuple(jv.strides) == tuple(tv.strides)
    assert jv.offset == tv.offset and jv.conj == tv.conj


def _same_values(jv, tv):
    want = np.asarray(jreg.materialize(jv))
    got = treg.materialize(tv).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _random_chain(rng, ndim):
    """A list of (name, args) view transforms valid for a rank-``ndim`` view."""
    ops = []
    shape_rank = ndim
    for _ in range(4):
        k = rng.integers(0, 5)
        if k == 0:
            ops.append(("permutedims", tuple(rng.permutation(shape_rank))))
        elif k == 1:
            ops.append(("flip", int(rng.integers(0, shape_rank))))
        elif k == 2:
            ops.append(("sview", int(rng.integers(0, shape_rank)), int(rng.choice([-2, -1, 2]))))
        elif k == 3:
            ops.append(("transpose",))
        else:
            ops.append(("newaxis",))
            shape_rank += 1
    return ops


def _apply(pkg, v, op):
    name = op[0]
    if name == "permutedims":
        return pkg.permutedims(v, op[1])
    if name == "flip":
        return pkg.flip(v, op[1])
    if name == "transpose":
        return pkg.transpose(v)
    if name == "newaxis":
        return pkg.sview(v, (None, Ellipsis))
    axis, step = op[1], op[2]
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(None, None, step)
    return pkg.sview(v, tuple(idx))


@pytest.mark.parametrize("seed", range(12))
def test_random_view_chains_match_jax(seed):
    rng = np.random.default_rng(seed)
    ndim = int(rng.integers(1, 6))
    shape = tuple(int(d) for d in rng.integers(1, 5, ndim))
    a = rng.standard_normal(shape)
    jv, tv = _both(a)
    for op in _random_chain(rng, ndim):
        jv, tv = _apply(jst, jv, op), _apply(tst, tv, op)
        _same_layout(jv, tv)
    _same_values(jv, tv)
    assert _dec(jreg, jv.shape, jv.strides, jv.offset) == _dec(treg, tv.shape, tv.strides,
                                                               tv.offset)


@pytest.mark.parametrize("idx", [
    (slice(1, None, 2), slice(None, None, -1)),
    (Ellipsis, 2),
    (None, slice(3, 0, -2), Ellipsis),
    (-1, slice(None, 4)),
    (slice(None, None, -3), None, slice(1, 5)),
])
def test_sview_matches_jax(idx):
    a = np.arange(6 * 7, dtype=np.float64).reshape(6, 7)
    jv, tv = _both(a)
    j2, t2 = jst.sview(jv, idx), tst.sview(tv, idx)
    _same_layout(j2, t2)
    _same_values(j2, t2)


@pytest.mark.parametrize("shape,new", [((4, 6), (24,)), ((4, 6), (2, 2, 6)), ((2, 3, 4), (6, 4)),
                                       ((2, 3, 4), (2, 12)), ((1, 5, 1), (5,))])
def test_sreshape_matches_jax(shape, new):
    a = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    jv, tv = _both(a)
    j2, t2 = jst.sreshape(jv, new), tst.sreshape(tv, new)
    _same_layout(j2, t2)
    _same_values(j2, t2)


@pytest.mark.parametrize("make", [
    lambda pkg, v: pkg.sreshape(pkg.transpose(v), (24,)),
    lambda pkg, v: pkg.sreshape(pkg.sview(v, (slice(None), slice(0, 3))), (12,)),
    lambda pkg, v: pkg.sreshape(v, (5, 5)),
    lambda pkg, v: pkg.permutedims(v, (0, 0)),
    lambda pkg, v: pkg.broadcast_to(v, (3, 6)),
    lambda pkg, v: pkg.sview(v, (slice(None), slice(None), 0)),
])
def test_layout_errors_match_jax(make):
    a = np.arange(24, dtype=np.float64).reshape(4, 6)
    jv, tv = _both(a)
    with pytest.raises(jst.StridedLayoutError):
        make(jst, jv)
    with pytest.raises(tst.StridedLayoutError):
        make(tst, tv)


def test_broadcast_and_overlapping_views_match_jax():
    a = np.arange(12, dtype=np.float64)
    jp, tp = jnp.asarray(a), torch.from_numpy(a.copy())
    # an overlapping (Hankel-like) window and a stride-0 broadcast
    for shape, strides, offset in [((5, 4), (1, 2), 1), ((3, 4), (0, 1), 2), ((4, 3), (2, 1), 0),
                                   ((2, 3, 2), (1, 4, -1), 1)]:
        jv = JView(jp, shape, strides, offset)
        tv = TView(tp, shape, strides, offset)
        _same_values(jv, tv)
        assert _dec(jreg, shape, strides, offset) == _dec(treg, shape, strides, offset)
    jv = jst.broadcast_to(jst.sview(jst.strided(jnp.asarray(a)), (slice(0, 4),)), (3, 4))
    tv = tst.broadcast_to(tst.sview(tst.strided(torch.from_numpy(a.copy())), (slice(0, 4),)), (3, 4))
    _same_layout(jv, tv)
    _same_values(jv, tv)


def test_out_of_bounds_view_raises_like_jax():
    a = np.arange(10, dtype=np.float64)
    jv = JView(jnp.asarray(a), (4,), (3,), 1)
    tv = TView(torch.from_numpy(a), (4,), (3,), 1)
    with pytest.raises(jst.StridedLayoutError):
        jreg.materialize(jv)
    with pytest.raises(tst.StridedLayoutError):
        treg.materialize(tv)


@pytest.mark.parametrize("make", [
    lambda b: b.T,
    lambda b: b[::2, 1:],
    lambda b: b[::-1, ::-2],
    lambda b: np.lib.stride_tricks.as_strided(b, (3, 4), (b.strides[1], b.strides[1])),
    lambda b: b.reshape(6, 8, order="F")[1:, ::3],
])
def test_numpy_adoption_matches_jax(make):
    base = np.arange(48, dtype=np.float64).reshape(6, 8)
    x = make(base)
    jv, tv = jst.strided(x), tst.strided(x, device="cpu")
    _same_layout(jv, tv)
    _same_values(jv, tv)
    assert jst.isstrided(x) and tst.isstrided(x)


def test_numpy_adoption_errors_match_jax():
    rec = np.zeros(6, dtype=[("a", np.float32), ("b", np.int16)])["a"]
    for pkg in (jst, tst):
        with pytest.raises(pkg.StridedLayoutError):
            pkg.strided(rec)
        assert not pkg.isstrided(rec)


@pytest.mark.parametrize("make", [lambda t: t.T, lambda t: t[1:, ::2], lambda t: t[:, 2:5].T,
                                  lambda t: t.unsqueeze(1).expand(6, 3, 8)])
def test_torch_tensor_adoption(make):
    """A non-contiguous tensor is adopted with its own strides and offset
    over its storage (no copy), and reads back as itself."""
    base = torch.arange(48, dtype=torch.float64).reshape(6, 8)
    t = make(base)
    v = tst.strided(t)
    assert v.strides == tuple(t.stride()) and v.offset == t.storage_offset()
    assert v.parent.data_ptr() == base.data_ptr()
    assert torch.equal(treg.materialize(v), t)


def _views_for_scatter(pkg, p):
    v = pkg.strided(p)
    return [
        pkg.transpose(v),  # full bijection
        pkg.sview(v, (slice(1, None, 2), slice(None, None, -1))),  # gapped, flipped
        pkg.flip(pkg.sview(v, (2,)), 0),
        pkg.sview(v, (slice(None), None, slice(0, 3))),  # a size-1 broadcast dim
    ]


@pytest.mark.parametrize("k", range(4))
def test_scatter_into_matches_jax(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((5, 6))
    jv = _views_for_scatter(jst, jnp.asarray(a))[k]
    tv = _views_for_scatter(tst, torch.from_numpy(a.copy()))[k]
    vals = rng.standard_normal(jv.shape)
    want = np.asarray(jreg.scatter_into(jv, jnp.asarray(vals)))
    got = treg.scatter_into(tv, torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert jreg.is_full_bijection(jv) == treg.is_full_bijection(tv)


def test_scatter_into_overlapping_and_broadcast_writes_match_jax():
    a = np.zeros(8)
    vals = np.arange(12, dtype=np.float64).reshape(3, 4)
    for shape, strides, offset in [((3, 4), (0, 1), 2), ((3, 4), (1, 1), 0)]:
        jv = JView(jnp.asarray(a), shape, strides, offset)
        tv = TView(torch.from_numpy(a.copy()), shape, strides, offset)
        want = np.asarray(jreg.scatter_into(jv, jnp.asarray(vals)))
        got = treg.scatter_into(tv, torch.from_numpy(vals)).numpy()
        np.testing.assert_array_equal(got, want)


def test_at_set_and_add_match_jax():
    a = np.arange(30, dtype=np.float64).reshape(5, 6)
    jv, tv = _both(a)
    j2 = jv.at[1:4, ::2].set(7.0)
    t2 = tv.at[1:4, ::2].set(7.0)
    np.testing.assert_array_equal(treg.materialize(t2).numpy(), np.asarray(jreg.materialize(j2)))
    j3 = jv.at[:, 0].add(jst.sview(jv, (slice(None), 1)))
    t3 = tv.at[:, 0].add(tst.sview(tv, (slice(None), 1)))
    np.testing.assert_array_equal(treg.materialize(t3).numpy(), np.asarray(jreg.materialize(j3)))
    # the source view keeps its old parent: writes are functional
    np.testing.assert_array_equal(treg.materialize(tv).numpy(), a)


EXPRS = {
    "float": (np.float32, lambda pkg, v: v * 2 + 1),
    "int": (np.int32, lambda pkg, v: v * 3 - 7),
    "transposed": (np.float32, lambda pkg, v: pkg.transpose(v) * 0.5 + 2),
    "transposed int": (np.int32, lambda pkg, v: pkg.transpose(v) - 4),
}


@pytest.mark.parametrize("wrap", ["strided", "as_view"])
@pytest.mark.parametrize("case", sorted(EXPRS))
def test_strided_of_an_expression_evaluates_it_like_jax(case, wrap):
    """``strided(expr)`` and ``as_view(expr)`` evaluate the expression into
    a dense row-major view, as the JAX package does (exact)."""
    dtype, make = EXPRS[case]
    a = (np.arange(12).reshape(3, 4) * (1 if dtype == np.int32 else 0.25)).astype(dtype)
    jv, tv = _both(a)
    jres = getattr(jst, wrap)(make(jst, jv))
    tres = getattr(tst, wrap)(make(tst, tv))
    assert isinstance(tres, TView)
    assert treg.materialize(tres).numpy().dtype == np.asarray(jreg.materialize(jres)).dtype
    _same_layout(jres, tres)
    _same_values(jres, tres)


NO_CUDA = (AssertionError, RuntimeError)  # torch's refusal: a CPU build asserts, else it raises


def test_strided_puts_numpy_on_the_card_unless_asked():
    """A numpy array, scalar or sequence goes to the card unless ``device``
    is given (without CUDA: torch's own error); a tensor or view keeps its
    device; ``device="cpu"`` adopts numpy without a copy; an engine call
    gives a numpy operand the device of the tensor it already holds."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for x in (np.ones((3, 4)), a.T, [1.0, 2.0], 3.0):
        with pytest.raises(NO_CUDA, match="CUDA|NVIDIA"):
            tst.strided(x)
    v = tst.strided(a, device="cpu")
    assert v.device.type == "cpu" and v.parent.data_ptr() == a.ctypes.data  # no copy
    assert tst.strided(torch.from_numpy(a), device="cuda").device.type == "cpu"
    assert tst.strided(v, device="cuda") is v
    y = tst.strided(np.ones((3, 4), np.float32), device="cpu")
    got = treg.materialize(tst.axpby(2.0, a, 1.0, y))
    np.testing.assert_array_equal(got.numpy(), 2 * a + 1)
    got = treg.materialize(tst.axpby(2.0, a, 0.5, y))
    np.testing.assert_array_equal(got.numpy(), 2 * a + 0.5)
    got = treg.materialize(tst.mul(tst.strided(np.zeros((3, 3), np.float32), device="cpu"), a, a.T))
    np.testing.assert_array_equal(got.numpy(), a @ a.T)
    out = tst.strided(torch.zeros(4, 3))
    np.testing.assert_array_equal(treg.materialize(tst.permutedims_into(out, a, (1, 0))).numpy(), a.T)
    np.testing.assert_array_equal(treg.materialize(tst.smap(lambda p, q: p + q, y, a)).numpy(), a + 1)
