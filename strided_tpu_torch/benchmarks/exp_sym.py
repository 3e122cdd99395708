"""Transpose and symmetrize probes on the card: the port of
``benchmarks/exp_sym.py``.

What the transpose-pair workload can reach on this card, variant by variant,
at ``n x n`` f32: the streaming ceiling (``x + 1``), the plain PyTorch
symmetrize and transpose, a tiled transpose copy at square and rectangular
tiles, a symmetrize that reads A twice (three passes), the tile-pair
schedule with its transposes (two passes), without them (a pure pair copy:
the schedule's ceiling) and without the duplicate diagonal write, and K2
itself (``prod_kernel``: ``symmetrize``, whose tile is fixed).

    python -m strided_tpu_torch.benchmarks.exp_sym [variant,names] [n]

prints one JSON line per variant: ``v``, ``n``, ``gbs`` (``2 * n^2 * 4``
bytes over the time), ``ok`` (an exact comparison with the plain result on
the card) and ``ms`` (CUDA events after a warm-up). ``n`` (default 8192)
must be a multiple of every tile swept.

The three kernels are ``csrc/exp_sym.cu``. Each wrapper checks its input,
launches on the current stream for a CUDA tensor (raising on a non-zero
``cudaError_t``) and counts ``LAUNCHES[name]``; a CPU tensor takes the
plain version beside it. Each takes an optional ``out=``, a contiguous
tensor of the result's shape, dtype and device that does not overlap the
input, writes the result there (on either path) and returns it.
``pair_tiles`` moves 16-byte words, so it refuses an input or ``out`` whose
base is not 16-byte aligned, on either path. ``run`` checks each variant
written into a NaN-filled ``out`` (:func:`agrees`), so an element a kernel
skips fails the check.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import check_out, cli, into, same

__all__ = ["transpose_tiles", "transpose_reference", "sym_two_read", "sym_reference",
           "pair_tiles", "pair_reference", "variants", "agrees", "run", "main", "LAUNCHES"]

LAUNCHES = {"transpose_tiles": 0, "sym_two_read": 0, "pair_tiles": 0}
SQUARE_TILES = (32, 64)  # csrc/exp_sym.cu: sym_two_read and pair_tiles
RECT_TILES = ((32, 64), (64, 32), (32, 128), (128, 32))  # and square 32, 64: transpose_tiles


def _check(a: torch.Tensor, what: str, *tiles: int) -> int:
    """n of a square contiguous f32 matrix that every tile divides."""
    if a.dtype != torch.float32:
        raise TypeError(f"{what}: takes float32, got {a.dtype}")
    if a.ndim != 2 or a.shape[0] != a.shape[1] or not a.is_contiguous():
        raise ValueError(f"{what}: takes a square contiguous matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    if n == 0 or any(n % t for t in tiles):
        raise ValueError(f"{what}: n={n} is not a multiple of the tile {tiles}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensor on {a.device}")
    return n


@functools.cache
def _lib():
    from .._build import load_library

    lib = load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.strided_transpose_tiles, [P, P, I, I, I, P]),
                     (lib.strided_sym_two_read, [P, P, I, I, P]),
                     (lib.strided_pair_tiles, [P, P, P, P, I, I, I, I, I, P])):
        fn.argtypes, fn.restype = args, I
    return lib


def _launch(name: str, a: torch.Tensor, out: torch.Tensor | None, call) -> torch.Tensor:
    out = torch.empty_like(a) if out is None else out
    with torch.cuda.device(a.device):
        err = call(out, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def transpose_reference(a: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    return into(out, a.T.contiguous())


def transpose_tiles(a: torch.Tensor, th: int = 32, tw: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``a.T`` through ``th x tw`` tiles (``v_pallas_t2d``, ``v_pallas_t2d_rect``)."""
    tw = th if tw is None else tw
    if (th, tw) not in RECT_TILES and not (th == tw and th in SQUARE_TILES):
        raise ValueError(f"transpose_tiles: no kernel for tiles {th}x{tw}")
    n = _check(a, "transpose_tiles", th, tw)
    check_out("transpose_tiles", a, out)
    if a.device.type == "cpu":
        return transpose_reference(a, out)
    return _launch("transpose_tiles", a, out, lambda y, s: _lib().strided_transpose_tiles(
        a.data_ptr(), y.data_ptr(), n, th, tw, s))


def sym_reference(a: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    return into(out, (a + a.T) * 0.5)


def sym_two_read(a: torch.Tensor, tile: int = 32, out: torch.Tensor | None = None) -> torch.Tensor:
    """``(a + a.T) * 0.5``, one output tile a block reading both mirror tiles
    (``v_pallas_sym_blockspec``)."""
    if tile not in SQUARE_TILES:
        raise ValueError(f"sym_two_read: no kernel for tile {tile}")
    n = _check(a, "sym_two_read", tile)
    check_out("sym_two_read", a, out)
    if a.device.type == "cpu":
        return sym_reference(a, out)
    return _launch("sym_two_read", a, out, lambda y, s: _lib().strided_sym_two_read(
        a.data_ptr(), y.data_ptr(), n, tile, s))


def pair_reference(a: torch.Tensor, do_transpose: bool = True,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    return into(out, sym_reference(a) if do_transpose else a.clone())


@functools.lru_cache(maxsize=None)
def pair_worklist(nb: int, device: torch.device):
    """The upper-triangle tile pairs ``(i, j), i <= j``, as two int32 tensors
    on ``device`` (built once per size, as the TPU probe's scalar prefetch)."""
    ii, jj = torch.triu_indices(nb, nb)
    return ii.to(torch.int32).to(device), jj.to(torch.int32).to(device)


def pair_tiles(a: torch.Tensor, tile: int = 32, do_transpose: bool = True,
               skip_diag: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """The tile-pair schedule (``v_pair``): ``(a + a.T) * 0.5`` with
    ``do_transpose``, else a pair copy ``a``; ``skip_diag`` writes a diagonal
    pair's tile once (same result). ``a`` and ``out`` must be 16-byte
    aligned."""
    if tile not in SQUARE_TILES:
        raise ValueError(f"pair_tiles: no kernel for tile {tile}")
    n = _check(a, "pair_tiles", tile)
    check_out("pair_tiles", a, out)
    for name, t in (("a", a), ("out", out)):  # its threads move 16-byte words
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"pair_tiles: {name} is not 16-byte aligned")
    if a.device.type == "cpu":
        return pair_reference(a, do_transpose, out)
    ii, jj = pair_worklist(n // tile, a.device)
    return _launch("pair_tiles", a, out, lambda y, s: _lib().strided_pair_tiles(
        a.data_ptr(), y.data_ptr(), ii.data_ptr(), jj.data_ptr(), ii.numel(), n, tile,
        int(do_transpose), int(skip_diag), s))


def variants():
    """``{name: (fn(x, out=None), want(x))}``: each variant, written into
    ``out`` when one is given, and the plain result it must equal."""
    from ..core.kernels_special import symmetrize

    stream = lambda x, out=None: torch.add(x, 1.0, out=out)  # noqa: E731
    V = {"stream": (stream, stream),
         "plain_sym": (sym_reference, sym_reference),
         "plain_transpose": (transpose_reference, transpose_reference)}
    for t in SQUARE_TILES:
        V[f"t2d_{t}"] = (functools.partial(transpose_tiles, th=t), transpose_reference)
        V[f"sym_two_read_{t}"] = (functools.partial(sym_two_read, tile=t), sym_reference)
        V[f"pair_copy_{t}"] = (functools.partial(pair_tiles, tile=t, do_transpose=False),
                               torch.Tensor.clone)
        V[f"pair_full_{t}"] = (functools.partial(pair_tiles, tile=t), sym_reference)
        V[f"pair_full_skipdiag_{t}"] = (functools.partial(pair_tiles, tile=t, skip_diag=True),
                                        sym_reference)
    for th, tw in RECT_TILES:
        V[f"t2d_rect_{th}x{tw}"] = (functools.partial(transpose_tiles, th=th, tw=tw),
                                    transpose_reference)
    # K2 writes its own new output, which is copied into ``out`` when one is given
    V["prod_kernel"] = (lambda x, out=None: into(out, symmetrize(x, alpha=0.5)), sym_reference)
    return V


OWN_OUTPUT = {"prod_kernel"}  # variants that allocate their output: timed without ``out``


def agrees(fn, want, x: torch.Tensor) -> bool:
    """``fn(x, out=...)`` written into a NaN-filled tensor made just before
    the call equals ``want(x)`` bit for bit, NaNs in the same places: an
    element ``fn`` leaves unwritten stays NaN and fails."""
    return same(fn(x, out=torch.full_like(x, float("nan"))), want(x))


def run(names=None, n: int = 8192, reps: int = 20, seed: int = 0):
    """Check (:func:`agrees`) and time ``names`` (default: all) on a seeded
    ``n x n`` f32 matrix on the card; returns one dict per variant. The
    timed calls write into one output, NaN-filled once outside the loop,
    except those of :data:`OWN_OUTPUT`, which time the kernel's own output."""
    from ..bench import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError("exp_sym measures the card; no CUDA device found")
    V = variants()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, device="cuda", generator=gen)
    out = torch.full_like(x, float("nan"))
    nbytes = 2 * x.numel() * 4  # one read and one write of the matrix
    rows = []
    for name in names or list(V):
        fn, want = V[name]
        ok = agrees(fn, want, x)
        timed = (lambda: fn(x)) if name in OWN_OUTPUT else (lambda: fn(x, out=out))
        ms = cuda_ms(timed, reps=reps)
        rows.append({"v": name, "n": n, "gbs": nbytes / ms / 1e6, "ok": ok, "ms": ms})
    return rows


def main(argv=None) -> int:
    return cli(run, 8192, argv)


if __name__ == "__main__":
    raise SystemExit(main())
