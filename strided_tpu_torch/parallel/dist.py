"""Process-group initialization: the multi-GPU layer's entry point.

Counterpart of ``strided_tpu/parallel/dist.py``. The reference joins hosts
through ``jax.distributed.initialize``; here every process is one rank of a
``torch.distributed`` process group, and the meshes of ``mesh.py`` span the
ranks. A single process is a documented no-op, so library code can call
:func:`init_distributed` unconditionally.

The backend is chosen explicitly, never by a silent downgrade: NCCL when the
ranks run on CUDA devices, one device a rank; gloo on the CPU. Several ranks
on one CUDA device are refused unless the caller asks for gloo, because NCCL
refuses two ranks on one device ("Duplicate GPU detected").
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "init_single_rank", "choose_backend", "BACKEND"]

BACKEND: Optional[str] = None  # the backend of the group this module initialized


def choose_backend(device_type: str, backend: Optional[str], local_ranks: int) -> str:
    """The backend for ``local_ranks`` ranks of this host on ``device_type``
    ("cuda" or "cpu"): the one asked for, or NCCL on CUDA and gloo on the
    CPU. Raises ``ValueError`` for a combination that cannot run."""
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl', 'gloo' or None")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs CUDA devices; the CPU takes 'gloo'")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device {device_type!r}: expected 'cuda' or 'cpu'")
    if backend == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if local_ranks > cards:
        raise ValueError(
            f"{local_ranks} ranks on this host and {cards} CUDA device(s): NCCL takes one "
            f"device a rank and refuses two on one device; pass backend='gloo' to share a card"
        )
    return "nccl"


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join this process to the ranks of a multi-process run.

    Returns ``True`` when a process group of more than one rank is set up
    (by this call or an earlier one), ``False`` for the single-process no-op.
    Explicit arguments win; otherwise torchrun's environment is read
    (``MASTER_ADDR``/``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). ``device`` is where the
    ranks compute: the card (the default) or ``"cpu"``. On the card each rank
    binds to ``cuda:LOCAL_RANK`` (modulo the device count, for gloo ranks
    sharing a card). The backend used is kept in ``BACKEND``."""
    global BACKEND
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_n = os.environ.get("WORLD_SIZE")
    explicit = init_method is not None or world_size not in (None, 1)
    from_env = "MASTER_ADDR" in os.environ and env_n is not None and int(env_n) > 1
    if not explicit and not from_env:
        return False  # single process: nothing to coordinate
    n = int(world_size if world_size is not None else env_n or -1)
    r = int(rank if rank is not None else os.environ.get("RANK", -1))
    local_rank = int(os.environ.get("LOCAL_RANK", max(r, 0)))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", max(n, 1)))
    device_type = torch.device("cuda" if device is None else device).type
    chosen = choose_backend(device_type, backend, local_ranks)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(chosen, init_method=init_method or "env://", world_size=n, rank=r)
    BACKEND = chosen
    return True


def init_single_rank(device=None) -> str:
    """A process group of this process alone (an in-memory store; NCCL on
    the card, gloo on the CPU), so that library code runs unchanged in one
    process as the reference's does on one device. Returns the backend."""
    global BACKEND
    device_type = torch.device("cuda" if device is None else device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on device 'cuda' needs a CUDA device; pass device='cpu'")
    chosen = choose_backend(device_type, None, 1)
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())  # bound before the mesh, as NCCL asks
    dist.init_process_group(chosen, store=dist.HashStore(), rank=0, world_size=1)
    BACKEND = chosen
    return chosen
