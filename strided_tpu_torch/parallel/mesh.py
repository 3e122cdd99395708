"""Device mesh over ``torch.distributed`` ranks, and the one helper that
issues every collective of the multi-GPU layer.

Counterpart of ``strided_tpu/parallel/mesh.py``. The reference's
``jax.sharding.Mesh`` over ``jax.devices()`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, with named dimensions. Operands are plain local tensors: a function
of this layer takes the tensor every rank holds, computes on the rank's
block (:func:`shard`) and returns either the rank's block (the reference's
``out_specs=P(axis)``) or a replicated result (``P()``), combining partial
results with explicit collectives over the group of one mesh dimension
(``mesh.get_group(name)``). :func:`gather` assembles a global tensor from
the ranks' blocks. Every collective goes through :func:`collective`, which
counts it in ``COLLECTIVES``: the counterpart of the reference's checks of
the compiled HLO's collectives.

On the card the layer's functions run captured (``sharded.py``), and an
NCCL collective is recorded into the graph like a kernel. A gloo group
cannot be recorded, since gloo moves CUDA tensors through the host:
:func:`require_graph_backend` refuses it before a captured function runs
and in a collective issued while a graph is being captured, and a caller
who wants gloo on the card calls inside ``capture.disable_capture()``.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import capture as _capture
from . import dist as _dist

__all__ = ["make_mesh", "shard", "gather", "axis_size", "axis_index", "collective",
           "require_graph_backend", "COLLECTIVES"]

# collectives issued through :func:`collective`, by kind: host calls, so the
# warm-up and the capture of a captured function count and a replay does not
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> DeviceMesh:
    """Build a mesh over the ranks of the process group, on the card (the
    default) or ``device="cpu"``.

    Default: a 1-D ``('data',)`` mesh over every rank. Pass e.g.
    ``axis_sizes=(2, 2), axis_names=('data', 'model')`` for 2-D meshes. A
    1-D over-ask clamps to the ranks there are, with a warning; a 2-D
    over-ask raises ``ValueError``. With no process group initialized, the
    mesh is one rank of a group of this process alone
    (:func:`~.dist.init_single_rank`), so library code runs unchanged in
    one process. Every rank must build the same meshes in the same order."""
    device_type = torch.device("cuda" if device is None else device).type
    if not dist.is_initialized():
        _dist.init_single_rank(device_type)
    ranks = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (ranks,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    want = math.prod(axis_sizes)
    if want > ranks:
        if len(axis_sizes) == 1:
            warnings.warn(
                f"mesh wants {want} devices, only {ranks} available; "
                f"clamping '{axis_names[0]}' axis to {ranks}",
                stacklevel=2,
            )
            axis_sizes = (ranks,)
        else:
            raise ValueError(f"mesh wants {want} devices, only {ranks} available")
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """Ranks along mesh dimension ``axis``."""
    return dist.get_world_size(mesh.get_group(axis))


def axis_index(mesh: DeviceMesh, axis: str = "data") -> int:
    """This rank's coordinate along mesh dimension ``axis``."""
    return mesh.get_local_rank(axis)


def shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """The rank's block of ``x`` (which every rank holds) split along
    ``dim`` over mesh dimension ``axis``: a view, no copy. Raises
    ``ValueError`` when the size does not divide by the axis size, as
    ``shard_map`` does."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over the {n} "
                         f"ranks of mesh axis {axis!r}")
    k = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * k, k)


def gather(t: torch.Tensor, mesh: DeviceMesh, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """The global tensor whose blocks along ``dim`` the ranks of mesh
    dimension ``axis`` hold, in rank order (the reverse of :func:`shard`);
    replicated. One ``all_gather``; along dim 0 no copy follows it."""
    return collective("all_gather", t, mesh, axis).movedim(0, dim).flatten(dim, dim + 1)


def require_graph_backend(mesh: DeviceMesh, axis: str, tensors: Sequence[torch.Tensor],
                          what: str) -> None:
    """Raise ``RuntimeError`` naming the backend when work of ``what`` on
    ``tensors`` would be recorded into a CUDA graph
    (``capture.recorded``) and the group of mesh dimension ``axis`` is not
    NCCL's. Gloo takes CUDA tensors through the host, which a graph cannot
    record; the work never runs eagerly in its place."""
    backend = dist.get_backend(mesh.get_group(axis))
    if backend != "nccl" and _capture.recorded(tensors):
        raise RuntimeError(
            f"{what}: mesh axis {axis!r} runs on {backend}, which a CUDA graph cannot record "
            f"({backend} moves CUDA tensors through the host); use NCCL, or call inside "
            f"capture.disable_capture() to run eagerly")


def collective(kind: str, t: torch.Tensor, mesh: DeviceMesh, axis: str = "data",
               op=dist.ReduceOp.SUM, src: int = 0):
    """Issue one collective over the group of mesh dimension ``axis`` and
    count it in ``COLLECTIVES``: ``"all_reduce"`` (in place with ``op``;
    returns ``t``), ``"all_gather"`` (returns the ranks' tensors stacked
    in rank order, ``(ranks, *t.shape)``: NCCL's
    ``all_gather_into_tensor``, or gloo's list form into the stack's rows)
    or ``"broadcast"`` (in place from the axis coordinate ``src``; returns
    ``t``). Refuses a gloo group while the stream is capturing
    (:func:`require_graph_backend`): a caller's own graph."""
    group = mesh.get_group(axis)
    if kind not in COLLECTIVES:
        raise ValueError(f"collective {kind!r}: expected one of {sorted(COLLECTIVES)}")
    if _capture.capturing((t,)):
        require_graph_backend(mesh, axis, (t,), kind)
    if kind == "all_reduce":
        COLLECTIVES[kind] += 1
        dist.all_reduce(t, op=op, group=group)
        return t
    if kind == "all_gather":
        t = t.contiguous()
        out = t.new_empty((dist.get_world_size(group), *t.shape))
        COLLECTIVES[kind] += 1
        if dist.get_backend(group) == "nccl":
            dist.all_gather_into_tensor(out, t, group=group)
        else:
            dist.all_gather(list(out.unbind(0)), t, group=group)
        return out
    COLLECTIVES[kind] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t
