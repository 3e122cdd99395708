"""Reading and writing strided views: materialize and scatter.

Counterpart of ``strided_tpu/core/regularize.py``. The reference has no
pointer arithmetic on the TPU and lowers a view to a slice/pad/reshape
cascade; PyTorch has ``as_strided``, which reads any non-negative layout
(overlapping and stride-0 ones included) straight from the flat parent.
Negative strides, which torch tensors cannot carry, are read with their
absolute value from the lowest address and then flipped.

:func:`decompose` (the physical-order description of a layout) is ported
verbatim: the executors and the stream reduction plan from it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .view import StridedView, StridedLayoutError

__all__ = [
    "Decomposition",
    "decompose",
    "materialize",
    "scatter_into",
    "is_full_bijection",
]


@dataclass(frozen=True)
class Decomposition:
    """How a view maps onto its flat parent.

    - ``real_axes``: logical axes with a genuine stride (size > 1, stride
      != 0), in *physical* order (descending |stride|);
    - ``sizes``/``strides``: their sizes and |strides| in that order;
    - ``flipped``: physical-order flags for negative logical strides;
    - ``min_offset``: flat index of the lowest-address element;
    - ``extent``: number of flat elements spanned (1 + sum (d-1)*s);
    - ``overlapping``: True when two logical elements can share an address.
    """

    shape: Tuple[int, ...]
    real_axes: Tuple[int, ...]
    sizes: Tuple[int, ...]
    strides: Tuple[int, ...]
    flipped: Tuple[bool, ...]
    min_offset: int
    extent: int
    overlapping: bool


def decompose(shape, strides, offset) -> Decomposition:
    shape = tuple(int(d) for d in shape)
    strides = tuple(int(s) for s in strides)
    real = []  # (|stride|, size, axis, flipped)
    min_offset = offset
    for axis, (d, s) in enumerate(zip(shape, strides)):
        if d == 1 or s == 0:
            continue
        if s < 0:
            min_offset += (d - 1) * s
            real.append((-s, d, axis, True))
        else:
            real.append((s, d, axis, False))
    real.sort(key=lambda t: (-t[0], t[2]))
    extent = 1 + sum((d - 1) * s for s, d, _, _ in real)
    overlapping = False
    inner = 1
    for s, d, _, _ in reversed(real):
        if s < inner:
            overlapping = True
        inner = (d - 1) * s + inner if s >= inner else max(inner, (d - 1) * s + 1)
    return Decomposition(
        shape=shape,
        real_axes=tuple(t[2] for t in real),
        sizes=tuple(t[1] for t in real),
        strides=tuple(t[0] for t in real),
        flipped=tuple(t[3] for t in real),
        min_offset=min_offset,
        extent=extent,
        overlapping=overlapping,
    )


def _window(v: StridedView, parent: torch.Tensor):
    """``(window, flip_axes)``: ``parent`` seen through ``v``'s layout with
    every stride made non-negative, and the logical axes to flip after.
    Raises :class:`StridedLayoutError` if the view leaves its parent."""
    dec = decompose(v.shape, v.strides, v.offset)
    if dec.min_offset < 0 or dec.min_offset + dec.extent > parent.numel():
        raise StridedLayoutError(
            f"view spans [{dec.min_offset}, {dec.min_offset + dec.extent}) "
            f"outside parent of length {parent.numel()}"
        )
    flips = [a for a, s in enumerate(v.strides) if s < 0 and v.shape[a] > 1]
    win = parent.as_strided(v.shape, tuple(abs(s) for s in v.strides),
                            parent.storage_offset() + dec.min_offset)
    return win, flips


def materialize(v: StridedView) -> torch.Tensor:
    """The logical dense tensor of a view (``Array(::StridedView)``). Where
    the view already is the dense parent this returns the parent's memory
    reshaped; the engine never writes into a parent, so that is safe."""
    if 0 in v.shape:
        return torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    win, flips = _window(v, v.parent)
    if flips:
        win = win.flip(flips)
    if v.conj:
        win = win.conj().resolve_conj()
    return win.contiguous()


def is_full_bijection(v: StridedView) -> bool:
    """True when the view is a bijective relabeling of its entire parent:
    no broadcast dims, exactly nested strides in physical order with
    innermost stride 1, zero min-offset, full coverage."""
    if 0 in v.shape:
        return v.parent.numel() == 0
    dec = decompose(v.shape, v.strides, v.offset)
    if dec.overlapping or dec.min_offset != 0:
        return False
    if len(dec.real_axes) != sum(1 for d in v.shape if d != 1):
        return False
    n = len(dec.sizes)
    if n == 0:
        return v.parent.numel() == 1
    if dec.strides[-1] != 1:
        return False
    for k in range(n - 1):
        if dec.strides[k] != dec.sizes[k + 1] * dec.strides[k + 1]:
            return False
    return math.prod(dec.sizes) == v.parent.numel()


def scatter_into(v: StridedView, values) -> torch.Tensor:
    """Write dense ``values`` (the logical shape of ``v``) through the view
    and return the **new flat parent** (a functional update; the old parent
    is left as it was). A full bijection writes into a fresh buffer; any
    other non-overlapping layout into a copy of the parent; layouts that
    visit an element more than once (overlap, broadcast dims) fall back to
    an indexed write, where the last duplicate wins as in the reference."""
    values = torch.as_tensor(values, device=v.device)
    if tuple(values.shape) != tuple(v.shape):
        raise StridedLayoutError(
            f"scatter_into: value shape {tuple(values.shape)} != view shape {v.shape}"
        )
    if v.conj:
        values = values.conj().resolve_conj()
    values = values.to(v.dtype)
    if 0 in v.shape:
        return v.parent
    dec = decompose(v.shape, v.strides, v.offset)
    has_broadcast_write = any(d > 1 and s == 0 for d, s in zip(v.shape, v.strides))
    if dec.overlapping or has_broadcast_write:
        if dec.min_offset < 0 or dec.min_offset + dec.extent > v.parent.numel():
            raise StridedLayoutError(
                f"view spans [{dec.min_offset}, {dec.min_offset + dec.extent}) "
                f"outside parent of length {v.parent.numel()}"
            )
        idx = torch.full((1,) * v.ndim, v.offset, dtype=torch.int64, device=v.device)
        for k, (d, s) in enumerate(zip(v.shape, v.strides)):
            shape = [1] * v.ndim
            shape[k] = d
            idx = idx + (torch.arange(d, device=v.device) * s).reshape(shape)
        new = v.parent.clone()
        new[idx.reshape(-1)] = values.reshape(-1)
        return new
    new = torch.empty_like(v.parent) if is_full_bijection(v) else v.parent.clone()
    win, flips = _window(v, new)
    win.copy_(values.flip(flips) if flips else values)
    return new
