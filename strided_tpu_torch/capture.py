"""Captured calls: the port's counterpart of ``jax.jit``.

``@capture`` makes a function run as one CUDA-graph replay on the card. On
the first call with a new signature it copies the tensor arguments into
static input buffers of the same shape, dtype, strides and device, runs the
function once eagerly on a side stream (the warm-up: K1's once-per-device
set-up, the cuBLAS handle and its workspace are made there, before any
capture), and captures one call into a ``torch.cuda.CUDAGraph``. Every
call, the first included, copies its tensor arguments into the static
buffers, replays the graph and returns clones of the outputs: a graph's
outputs are overwritten by its next replay, and JAX returns fresh arrays.

The signature is each tensor argument's shape, dtype, strides and device;
each scalar, string, dtype, device or tuple of them by value; every other
argument (a controller, a model, a cost) by identity, held through a weak
reference, so that an entry dies with its object and a reused ``id`` finds
nothing; the whole ``config.get_config()``, since ``qp_solve`` reads
``fused_admm`` while the call is captured; the f32 matmul mode, which
capture freezes; and whether tracing is on, which decides the graph's
section markers. The tensors inside an object are read where they lie: the
graph holds their addresses, as a jitted closure holds its constants.

There is no fallback. On a CUDA tensor a capture that fails raises: a host
read such as ``.item()``, a synchronising call, an allocation the graph's
pool cannot serve. The call never runs eagerly instead. Where no argument
is a CUDA tensor (the caller asked for the CPU), inside
:func:`disable_capture`, during a warm-up and inside another capture (a
captured function that calls another one, or a caller's own graph) the
function runs as it is.

The live graphs of a device share one memory pool (a new graph takes a
live one's ``pool()``; the pool goes with the last of them). Replays are
ordered on the current stream, and each call's outputs are cloned before it
returns, so no graph needs another's memory to outlive its replay.

A capture records this thread's work only (``capture_error_mode=
"thread_local"``): NCCL's watchdog thread queries CUDA events while a
captured collective is recorded, which a process-wide capture would count
as an error. A collective is captured like any other launch once its
communicator exists; the warm-up's eager call makes it.
:func:`recorded` says whether work on given tensors would be recorded into
a graph; the multi-GPU layer refuses a gloo group there, before any
capture (``parallel/mesh.py::require_graph_backend``).

``CAPTURES`` counts captures, ``REPLAYS`` replays (the first call's
included) and ``LAST_CAPTURE_MS`` is the host time of the last capture and
its instantiation. A kernel's own launch count (``fused_admm.LAUNCHES``)
and the collectives of ``parallel.COLLECTIVES`` count host calls: the
warm-up's and the capture's, and no replay.

What a replay shows: a profiler sees ``cudaGraphLaunch`` on the host and
the graph's kernels on the card, and none of the host spans that ran while
it was captured. The call's host side is spans of its own
(``utils/profiling.py``): ``capture.replay`` from the key to the return,
with ``capture.signature`` (the key and the lookup) and ``capture.launch``
(the copies into the static buffers and the replay) inside it and the
output clones its self time; a call that finds no entry counts its key and
lookup as ``capture.miss`` instead, and its warm-up and capture as
``capture.record``. With tracing on (``profiling.enable``) a capture also
puts each span entered inside it between two marker kernels, so a profiled
replay shows, for instance, ``qp.solve``'s and ``model.step``'s kernels
between their markers. The tracing switch is part of the signature: a
graph captured with tracing off has no markers, and turning tracing on
captures anew.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref

import torch

from .config import get_config
from .utils import profiling
from .utils.profiling import annotate

__all__ = ["capture", "disable_capture", "capturing", "recorded", "signature", "Cache", "CAPTURES",
           "REPLAYS", "LAST_CAPTURE_MS"]

CAPTURES: int = 0
REPLAYS: int = 0
LAST_CAPTURE_MS: float = 0.0
_eager_depth = 0  # > 0: decorated functions run as they are
_graphs = {}  # device index -> its live graphs, which share one memory pool

_VALUES = (type(None), bool, int, str, torch.dtype, torch.device)


@contextlib.contextmanager
def disable_capture():
    """Inside, decorated functions run eagerly (``jax.disable_jit``). Nests."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def capturing(tensors) -> bool:
    """Whether work on ``tensors`` is being captured now: some tensor is on
    the card and the current stream is capturing (a decorated function's
    capture, or a caller's own graph)."""
    return any(t.is_cuda for t in tensors) and torch.cuda.is_current_stream_capturing()


def recorded(tensors) -> bool:
    """Whether work on ``tensors`` goes into a CUDA graph instead of running:
    it is being captured (:func:`capturing`), or a decorated function called
    on them now would capture or replay (some tensor is on the card, outside
    :func:`disable_capture` and a warm-up)."""
    return capturing(tensors) or (not _eager_depth and any(t.is_cuda for t in tensors))


def _arg_key(v, objects: list, nested: bool = False):
    if isinstance(v, torch.Tensor):
        if nested:
            raise TypeError("capture: a tensor inside a tuple or list is not supported; "
                            "pass it as an argument of its own")
        return ("tensor", tuple(v.shape), v.dtype, v.stride(), v.device)
    if isinstance(v, _VALUES):
        return (type(v), v)
    if isinstance(v, float):
        return (float, v.hex())  # tells -0.0 from 0.0; a NaN equals itself
    if isinstance(v, (tuple, list)):
        return (type(v), tuple(_arg_key(x, objects, True) for x in v))
    objects.append(v)
    return ("object", id(v))


def signature(args: tuple, kwargs: dict):
    """``(key, objects)``: the cache key of a call, and the arguments it
    holds by identity (see the module docstring)."""
    objects = []
    key = (tuple(_arg_key(a, objects) for a in args),
           tuple((k, _arg_key(v, objects)) for k, v in sorted(kwargs.items())),
           get_config(),
           torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32,
           profiling.enabled())
    return key, objects


class Cache:
    """Entries by call signature. An entry is dropped when one of the
    objects of its key dies."""

    def __init__(self):
        self._entries = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        return self._entries.get(key, (None, None))[1]

    def put(self, key, objects, entry) -> None:
        drop = lambda _ref, entries=self._entries: entries.pop(key, None)  # noqa: E731
        refs = []
        for o in objects:
            try:
                refs.append(weakref.ref(o, drop))
            except TypeError:
                raise TypeError(f"capture: an argument of type {type(o).__name__} is held "
                                f"by identity and must take a weak reference") from None
        self._entries[key] = (refs, entry)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple) and hasattr(out, "_fields"):  # a NamedTuple
        return type(out)(*map(_clone, out))
    if isinstance(out, tuple):
        return tuple(map(_clone, out))
    raise TypeError(f"capture: a captured function returns tensors or tuples of them, "
                    f"got {type(out).__name__}")


def _tensors(args, kwargs) -> list:
    """The tensor arguments in a fixed order: positional, then by keyword."""
    return [a for a in (*args, *(kwargs[k] for k in sorted(kwargs)))
            if isinstance(a, torch.Tensor)]


def _static(a):
    if not isinstance(a, torch.Tensor):
        return a
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device).copy_(a)


def _record(fn, args, kwargs, dev):
    """Warm up and capture one call of ``fn``; returns ``(graph, static
    tensor arguments, outputs)``."""
    global _eager_depth, LAST_CAPTURE_MS
    s_args = [_static(a) for a in args]
    s_kwargs = {k: _static(v) for k, v in kwargs.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    _eager_depth += 1  # the warm-up runs inner decorated functions as they are
    try:
        with torch.cuda.stream(side):
            fn(*s_args, **s_kwargs)
    finally:
        _eager_depth -= 1
    torch.cuda.current_stream(dev).wait_stream(side)
    live = _graphs.setdefault(dev.index, weakref.WeakSet())
    pool = next(iter(live)).pool() if live else torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"), \
            profiling.own_capture():
        outputs = fn(*s_args, **s_kwargs)
    LAST_CAPTURE_MS = (time.perf_counter() - t0) * 1e3
    live.add(graph)
    _clone(outputs)  # the output's structure is checked before the entry is kept
    return graph, _tensors(s_args, s_kwargs), outputs


def _launch(entry, tensors):
    """Copy the call's tensors into the entry's static buffers and replay
    its graph; returns the graph's outputs."""
    global REPLAYS
    graph, inputs, outputs = entry
    with annotate("capture.launch"):
        for buf, a in zip(inputs, tensors):
            buf.copy_(a)
        graph.replay()
    REPLAYS += 1
    return outputs


def capture(fn):
    """Decorator: run ``fn`` as one CUDA-graph replay per call on the card
    (the module docstring says how). ``fn`` returns a tensor or a tuple of
    them (a NamedTuple keeps its type) and must not write to its tensor
    arguments: it writes to the static buffers only. The decorated
    function's ``cache`` holds its entries."""
    cache = Cache()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        global CAPTURES
        tensors = _tensors(args, kwargs)
        cuda = [a for a in tensors if a.is_cuda]
        if _eager_depth or not cuda or torch.cuda.is_current_stream_capturing():
            return fn(*args, **kwargs)
        dev = cuda[0].device
        with torch.cuda.device(dev):
            with annotate("capture.replay") as span:
                with annotate("capture.signature"):
                    key, objects = signature(args, kwargs)
                    entry = cache.get(key)
                if entry is not None:
                    return _clone(_launch(entry, tensors))
                profiling.rename(span, "capture.miss")
            with annotate("capture.record"):
                entry = _record(fn, args, kwargs, dev)
            cache.put(key, objects, entry)
            CAPTURES += 1
            return _clone(_launch(entry, tensors))

    wrapped.cache = cache
    return wrapped
