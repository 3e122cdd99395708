"""Lazy strided views over flat tensors: the engine's view algebra.

Counterpart of ``strided_tpu/core/view.py``. A :class:`StridedView` is a
window into a flat, contiguous 1-D tensor (``parent``); ``shape``,
``strides`` (in elements), ``offset`` and ``conj`` are plain Python
metadata. Every layout transform (``permutedims``, ``transpose``,
``adjoint``, ``conj``, ``sreshape``, ``sview``, ``flip``, ``broadcast_to``)
edits that metadata in O(1) and moves no data. Strides may be negative
(``flip``, negative slice steps) although torch tensors cannot carry them:
the engine resolves them when it reads or writes (``regularize.py``).

The engine is functional like the reference: a write returns a view over a
new parent and never changes a parent in place, so a view may share memory
with the tensor it was made from.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "StridedView",
    "StridedLayoutError",
    "strided",
    "as_view",
    "isstrided",
    "row_major_strides",
    "permutedims",
    "transpose",
    "adjoint",
    "conj",
    "sreshape",
    "sview",
    "set_view",
    "flip",
    "broadcast_to",
]


class StridedLayoutError(ValueError):
    """Raised when a requested view cannot preserve stridedness."""


def row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """C-order strides (in elements) for a dense array of ``shape``."""
    strides = []
    acc = 1
    for d in reversed(tuple(shape)):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


@dataclass(frozen=True, eq=False)
class StridedView:
    """A lazy strided window into a flat 1-D tensor.

    Logical element ``(i_0, ..., i_{n-1})`` lives at flat index
    ``offset + sum_k i_k * strides[k]`` of ``parent``; with ``conj`` set,
    reads conjugate and writes conjugate back."""

    parent: torch.Tensor
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    offset: int
    conj: bool = False

    def __post_init__(self):
        if len(self.shape) != len(self.strides):
            raise StridedLayoutError(
                f"shape {self.shape} and strides {self.strides} rank mismatch"
            )
        p = self.parent
        if p.ndim != 1 or (p.numel() > 1 and p.stride(0) != 1):
            raise StridedLayoutError("a view's parent must be a contiguous 1-D tensor")

    @property
    def dtype(self) -> torch.dtype:
        return self.parent.dtype

    @property
    def device(self) -> torch.device:
        return self.parent.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    # -- lazy transforms (all O(1) metadata) -------------------------------
    def permute(self, perm: Sequence[int]) -> "StridedView":
        return permutedims(self, perm)

    @property
    def T(self) -> "StridedView":
        return transpose(self)

    @property
    def H(self) -> "StridedView":
        return adjoint(self)

    def reshape(self, *shape) -> "StridedView":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return sreshape(self, shape)

    def __getitem__(self, idx) -> "StridedView":
        return sview(self, idx)

    @property
    def at(self) -> "_At":
        """Functional indexed assignment: ``v.at[idx].set(expr)`` writes
        through ``sview(v, idx)`` and returns the whole view over its new
        parent. Also ``.add``, ``.mul`` and ``.apply(f, *args)``."""
        return _At(self)

    def materialize(self) -> torch.Tensor:
        from . import regularize

        return regularize.materialize(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"StridedView(shape={self.shape}, strides={self.strides}, "
            f"offset={self.offset}, conj={self.conj}, dtype={self.dtype})"
        )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _flat_storage(t: torch.Tensor) -> torch.Tensor:
    """The whole storage under ``t`` as a contiguous 1-D tensor."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0)


def strided(x: Union[torch.Tensor, np.ndarray, StridedView, Any], device=None) -> StridedView:
    """Wrap an array as a :class:`StridedView`.

    A contiguous tensor wraps with row-major strides over ``t.reshape(-1)``
    (no copy). A non-contiguous tensor is ADOPTED: its own ``stride()`` and
    ``storage_offset()`` become the view's metadata over its whole storage.
    A tensor or a view keeps its own device; ``device`` is not read for it.

    A numpy array, a Python scalar or a sequence goes to ``device``, the card
    (``"cuda"``) unless one is given, as the reference puts it on its default
    device. A non-contiguous numpy array is adopted the same way over its
    owning base buffer, so transposes, ``stride_tricks`` windows and
    negative-step slices keep their lazy layout (without a copy on the CPU);
    layouts that are not element-aligned raise :class:`StridedLayoutError`.
    A lazy expression is evaluated into a dense row-major view, as the
    reference does."""
    if isinstance(x, StridedView):
        return x
    if not isinstance(x, torch.Tensor):
        from .lazy_expr import StridedExpr

        if isinstance(x, StridedExpr):
            return x.evaluate()
        device = torch.device("cuda" if device is None else device)
        if isinstance(x, np.ndarray) and not x.flags.c_contiguous and x.size > 0:
            return _adopt_numpy(x, device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x if x.flags.writeable else x.copy()).to(device)
        else:
            x = torch.as_tensor(x, device=device)
    shape = tuple(x.shape)
    if x.is_contiguous() or x.numel() == 0:
        return StridedView(x.reshape(-1), shape, row_major_strides(shape), 0, False)
    return StridedView(_flat_storage(x), shape, tuple(x.stride()),
                       x.storage_offset(), False)


def held_device(*xs) -> Union[torch.device, None]:
    """The device of the first of ``xs`` that already lies on one (a tensor,
    a view, or a lazy expression over views), else None: the device an
    engine call gives the numpy and scalar operands it wraps."""
    for x in xs:
        if isinstance(x, (torch.Tensor, StridedView)):
            return x.device
        leaves = getattr(x, "leaves", None)
        if leaves:
            return leaves[0].device
    return None


def _adopt_layout(x: np.ndarray):
    """Validate and derive ``(strides_el, root, offset)`` for adopting a
    non-contiguous numpy array; the one check both :func:`strided` and
    :func:`isstrided` use. Raises :class:`StridedLayoutError`."""
    itemsize = x.itemsize
    if any(s % itemsize for s in x.strides):
        raise StridedLayoutError(
            f"cannot adopt numpy layout: byte strides {x.strides} are not "
            f"multiples of the {itemsize}-byte element size"
        )
    strides_el = tuple(s // itemsize for s in x.strides)
    root = _numpy_root(x)
    if root.dtype.itemsize != itemsize or root.dtype != x.dtype:
        raise StridedLayoutError(
            f"cannot adopt numpy view of dtype {x.dtype} over a base of "
            f"dtype {root.dtype} (reinterpreted layouts are not strided)"
        )
    if not (root.flags.c_contiguous or root.flags.f_contiguous):
        raise StridedLayoutError(
            "cannot adopt numpy view: owning base buffer is not contiguous"
        )
    off_bytes = x.__array_interface__["data"][0] - root.__array_interface__["data"][0]
    if off_bytes % itemsize:
        raise StridedLayoutError(
            "cannot adopt numpy view: data offset is not element-aligned"
        )
    offset = off_bytes // itemsize
    lo = offset + sum(min(0, (d - 1) * s) for d, s in zip(x.shape, strides_el))
    hi = offset + sum(max(0, (d - 1) * s) for d, s in zip(x.shape, strides_el))
    if lo < 0 or hi >= root.size:
        raise StridedLayoutError(
            f"adopted view spans [{lo}, {hi}] outside base of {root.size} elements"
        )
    return strides_el, root, offset


def _adopt_numpy(x: np.ndarray, device: torch.device) -> StridedView:
    strides_el, root, offset = _adopt_layout(x)
    flat = root.reshape(-1) if root.flags.c_contiguous else root.reshape(-1, order="F")
    parent = torch.from_numpy(flat if flat.flags.writeable else flat.copy()).to(device)
    return StridedView(parent, tuple(x.shape), strides_el, offset, False)


def isstrided(x) -> bool:
    """Can ``x`` be expressed as a strided view without a copy?"""
    if isinstance(x, (StridedView, torch.Tensor)):
        return True
    if isinstance(x, np.ndarray):
        if x.flags.c_contiguous or x.size == 0:
            return True
        try:
            _adopt_layout(x)
            return True
        except StridedLayoutError:
            return False
    return False


def _numpy_root(x: np.ndarray) -> np.ndarray:
    """Deepest ndarray in the ``.base`` chain."""
    node, root = x, x
    while True:
        b = getattr(node, "base", None)
        if b is None:
            break
        node = b
        if isinstance(b, np.ndarray):
            root = b
    return root


as_view = strided


# ---------------------------------------------------------------------------
# lazy layout transforms
# ---------------------------------------------------------------------------


def permutedims(v: StridedView, perm: Sequence[int]) -> StridedView:
    """Lazy dimension permutation."""
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(v.ndim)):
        raise StridedLayoutError(f"invalid permutation {perm} for rank {v.ndim}")
    return StridedView(
        v.parent,
        tuple(v.shape[p] for p in perm),
        tuple(v.strides[p] for p in perm),
        v.offset,
        v.conj,
    )


def transpose(v: StridedView) -> StridedView:
    """Full-rank reversal (2-D: matrix transpose), lazy."""
    return permutedims(v, tuple(reversed(range(v.ndim))))


def conj(v: StridedView) -> StridedView:
    """Lazy conjugation (toggles ``conj``); the identity for real dtypes."""
    if not v.dtype.is_complex:
        return v
    return StridedView(v.parent, v.shape, v.strides, v.offset, not v.conj)


def adjoint(v: StridedView) -> StridedView:
    """Lazy conjugate transpose."""
    return conj(transpose(v))


def flip(v: StridedView, axis: int) -> StridedView:
    """Lazy reversal along ``axis`` through a negative stride."""
    axis = range(v.ndim)[axis]
    d, s = v.shape[axis], v.strides[axis]
    new_strides = list(v.strides)
    new_strides[axis] = -s
    return StridedView(v.parent, v.shape, tuple(new_strides), v.offset + (d - 1) * s, v.conj)


def broadcast_to(v: StridedView, shape: Sequence[int]) -> StridedView:
    """Lazy broadcast: size-1 (or missing leading) dims become stride 0."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < v.ndim:
        raise StridedLayoutError(f"cannot broadcast rank {v.ndim} to shape {shape}")
    lead = len(shape) - v.ndim
    new_strides = [0] * lead
    for k in range(v.ndim):
        if v.shape[k] == shape[lead + k]:
            new_strides.append(v.strides[k])
        elif v.shape[k] == 1:
            new_strides.append(0)
        else:
            raise StridedLayoutError(f"cannot broadcast shape {v.shape} to {shape}")
    return StridedView(v.parent, shape, tuple(new_strides), v.offset, v.conj)


def sreshape(v: StridedView, shape: Sequence[int]) -> StridedView:
    """Stride-preserving lazy reshape; raises :class:`StridedLayoutError` if
    the new shape cannot be expressed over the existing strides without a
    copy. Old dims merge into maximal contiguous chunks, and the new shape
    is factored across the chunks in order; size-1 dims are free."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != v.size:
        raise StridedLayoutError(
            f"cannot reshape view of size {v.size} (shape {v.shape}) to {shape}"
        )
    if v.size == 0:
        return StridedView(v.parent, shape, row_major_strides(shape), v.offset, v.conj)
    chunks = []  # (total size, inner stride), dense row-major within a chunk
    for d, s in ((d, s) for d, s in zip(v.shape, v.strides) if d != 1):
        if chunks and chunks[-1][1] == s * d:
            chunks[-1] = (chunks[-1][0] * d, s)
        else:
            chunks.append((d, s))
    if not chunks:
        chunks = [(1, 1)]
    new_strides = []
    ci = 0
    remaining, inner = chunks[0]
    for d in shape:
        if d == 1:
            new_strides.append(remaining * inner if remaining else 1)
            continue
        while remaining == 1 and ci + 1 < len(chunks):
            ci += 1
            remaining, inner = chunks[ci]
        if remaining % d != 0:
            raise StridedLayoutError(
                f"cannot sreshape {v.shape} with strides {v.strides} to {shape} "
                "without a copy"
            )
        remaining //= d
        new_strides.append(remaining * inner)
    if remaining != 1 or ci + 1 < len(chunks):
        raise StridedLayoutError(
            f"cannot sreshape {v.shape} with strides {v.strides} to {shape} "
            "without a copy"
        )
    return StridedView(v.parent, shape, tuple(new_strides), v.offset, v.conj)


class _At:
    """Indexer for :attr:`StridedView.at`."""

    __slots__ = ("_view",)

    def __init__(self, view: StridedView):
        self._view = view

    def __getitem__(self, idx) -> "_IndexUpdate":
        return _IndexUpdate(self._view, idx)


class _IndexUpdate:
    __slots__ = ("_view", "_idx")

    def __init__(self, view: StridedView, idx):
        self._view = view
        self._idx = idx

    def _finish(self, sub_updated: StridedView) -> StridedView:
        v = self._view
        return StridedView(sub_updated.parent, v.shape, v.strides, v.offset, v.conj)

    def apply(self, f, *args) -> StridedView:
        """``v[idx] .= f.(args...)``; returns the whole updated view."""
        from .broadcast import sbroadcast_into

        return self._finish(sbroadcast_into(sview(self._view, self._idx), f, *args))

    def set(self, value) -> StridedView:
        """``v[idx] .= value`` (scalar, array, view or lazy expression)."""
        from .lazy_expr import identity_f

        return self.apply(identity_f, value)

    def add(self, value) -> StridedView:
        from .broadcast import sbroadcast_into

        sub = sview(self._view, self._idx)
        return self._finish(sbroadcast_into(sub, lambda a, b: a + b, sub, value))

    def mul(self, value) -> StridedView:
        from .broadcast import sbroadcast_into

        sub = sview(self._view, self._idx)
        return self._finish(sbroadcast_into(sub, lambda a, b: a * b, sub, value))


def set_view(v: StridedView, idx, value) -> StridedView:
    """Functional ``v[idx] .= value``: ``v.at[idx].set(value)``."""
    return _At(v)[idx].set(value)


def sview(v: StridedView, idx) -> StridedView:
    """Lazy basic indexing: ints (drop the dim), slices (any sign of step),
    ``...`` and ``None`` (a new size-1 dim of stride 0)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_specified = sum(1 for i in idx if i is not None and i is not Ellipsis)
    if Ellipsis in idx:
        e = idx.index(Ellipsis)
        idx = idx[:e] + (slice(None),) * (v.ndim - n_specified) + idx[e + 1:]
        if Ellipsis in idx:
            raise StridedLayoutError("only one Ellipsis allowed")
    else:
        idx = idx + (slice(None),) * (v.ndim - n_specified)
    new_shape, new_strides = [], []
    offset = v.offset
    axis = 0
    for i in idx:
        if i is None:
            new_shape.append(1)
            new_strides.append(0)
            continue
        if axis >= v.ndim:
            raise StridedLayoutError(f"too many indices for rank {v.ndim}")
        d, s = v.shape[axis], v.strides[axis]
        if isinstance(i, int) or (hasattr(i, "__index__") and not isinstance(i, bool)):
            i = operator.index(i)
            if i < 0:
                i += d
            if not 0 <= i < d:
                raise IndexError(f"index {i} out of bounds for dim {axis} size {d}")
            offset += i * s
        elif isinstance(i, slice):
            start, stop, step = i.indices(d)
            length = (max(0, -(-(stop - start) // step)) if step > 0
                      else max(0, -(-(start - stop) // -step)))
            offset += start * s
            new_shape.append(length)
            new_strides.append(s * step)
        else:
            raise StridedLayoutError(
                f"unsupported index {i!r}: sview supports ints, slices, None, ..."
            )
        axis += 1
    return StridedView(v.parent, tuple(new_shape), tuple(new_strides), offset, v.conj)
