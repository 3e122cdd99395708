"""Where the engine's kernels start to win on the card: the port of
``benchmarks/exp_crossover_r5.py``, which set the JAX package's
``pair_kernel_min_elements``.

Two families, each kernel arm against its plain arm on square (n, n)
inputs, n in sqrt(2) steps from 256 to 8192 (2^16-2^26 elements) and the
TPU script's 4000 and 5120:

- ``pair`` (K2's gate): the TPU script's variants. The kernel arm is K2
  (``core/kernels_special.py::pair_axpby``, whose tile is fixed), the plain
  arm the PyTorch spelling:
  ``sym`` ``(x + x.T) / 2``; ``scaleT`` ``0.999 * x.T`` written row-major
  (``torch.mul(x.T, 0.999, out=...)``: a bare ``x.T * 0.999`` would keep the
  transposed layout and move nothing); ``distinct`` ``(x + y.T) * 0.5``
  over two rotated operands (3 passes); ``sym_bf16`` the pair in bf16.
  ``stream`` (``x + 1.0``) is the honesty litmus beside ``x.clone()``.
- ``stream`` (K3's gate): ``st.ssum(v, 0)`` and ``st.smean(v, 0)`` over
  f32 and bf16 through the public engine, with
  ``min_stream_reduce_elements`` forced to 1 (kernel arm) and to 2^60
  (plain arm). The JAX package set this gate from a study with no script;
  this family is its measurement on the card.

Every arm is timed through ``bench.rotating_ms`` (eager and device time,
inputs rotated through copies over 4x the L2), and every kernel result is
held against the plain one first (pairs bit for bit, sums within
``1e-6 * rows * max|a|``, and bf16 results one bf16 rounding of it).
:func:`pick_gate` turns a variant's rows into a gate.

    python -m strided_tpu_torch.benchmarks.exp_crossover [--family pair,stream]
        [--sizes 256,4000] [--variants sym,ssum_f32]

prints one JSON line a (variant, size), then one line of the gates the
rows give (``pair_kernel_min_elements`` from ``sym`` and ``sym_bf16``,
``min_stream_reduce_elements`` from the four reductions). It needs a CUDA
device. ``--from OUT [OUT ...]`` prints instead the gates of the rows that
earlier runs printed (saved outputs; a size must win in every run).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import time_arm

__all__ = ["LADDER", "SIZES", "PAIR", "STREAM", "GATES", "pick_gate", "gates", "pair_row",
           "stream_row", "run", "read_rows", "main"]

# square sides in sqrt(2) steps: 2^16 .. 2^26 elements
LADDER = tuple(round(256 * 2 ** (k / 2)) for k in range(11))
SIZES = tuple(sorted(set(LADDER) | {4000, 5120}))


def _scale_t(x):
    return torch.mul(x.T, 0.999, out=torch.empty_like(x))


def _pair_kernels():
    from ..core.kernels_special import pair_axpby

    return {
        "sym": lambda x: pair_axpby(x, scale_mode="div", scale=2.0),
        "scaleT": lambda x: pair_axpby(x, alpha=0.0, beta=0.999),
        "distinct": lambda x, y: pair_axpby(x, y, alpha=1.0, beta=1.0, scale_mode="mul",
                                            scale=0.5),
        "sym_bf16": lambda x: pair_axpby(x, scale_mode="mul", scale=0.5),
    }


# variant: (dtype, operands a call, passes over an operand's bytes, plain arm)
PAIR = {
    "sym": (torch.float32, 1, 2, lambda x: (x + x.T) / 2.0),
    "scaleT": (torch.float32, 1, 2, _scale_t),
    "distinct": (torch.float32, 2, 3, lambda x, y: (x + y.T) * 0.5),
    "sym_bf16": (torch.bfloat16, 1, 2, lambda x: (x + x.T) * 0.5),
}


def _ssum(v):
    import strided_tpu_torch as st

    return st.ssum(v, 0)


def _smean(v):
    import strided_tpu_torch as st

    return st.smean(v, 0)


# variant: (dtype, the engine call on a view)
STREAM = {
    "ssum_f32": (torch.float32, _ssum),
    "smean_f32": (torch.float32, _smean),
    "ssum_bf16": (torch.bfloat16, _ssum),
    "smean_bf16": (torch.bfloat16, _smean),
}

# the config field each family's crossover sets, from which variants
GATES = {
    "pair_kernel_min_elements": ("pair", ("sym", "sym_bf16")),
    "min_stream_reduce_elements": ("stream", tuple(STREAM)),
}


def _wins(row) -> bool:
    k, p = row.get("kernel_device_ms"), row.get("plain_device_ms")
    return (k is not None and p is not None and row["kernel_ms"] <= row["plain_ms"]
            and k <= p)


def pick_gate(rows):
    """``(gate, note)`` from one variant's rows (dicts with ``elements``,
    ``kernel_ms``, ``plain_ms``, ``kernel_device_ms``, ``plain_device_ms``;
    several rows of one size, from repeated runs, must all win): the
    smallest measured size from which the kernel arm is no slower than the
    plain arm in both eager and device time, at that size and every larger
    one, rounded up to a power of two (the measured-safe side). A missing
    device time counts as a loss. If the kernel loses at the largest size,
    the gate is the power of two above the largest size."""
    if not rows:
        raise ValueError("pick_gate: no rows")
    sizes = sorted({r["elements"] for r in rows})
    lost = [r["elements"] for r in rows if not _wins(r)]
    if lost and max(lost) == sizes[-1]:
        return 1 << sizes[-1].bit_length(), (f"the kernel never wins up to {sizes[-1]} "
                                             f"elements: gate above the largest measured size")
    s = min(e for e in sizes if not lost or e > max(lost))
    below = sum(1 for e in sizes if e < s)
    return 1 << (s - 1).bit_length(), (f"the kernel is no slower from {s} elements on "
                                       f"({below} smaller sizes lose at least once)")


def gates(rows) -> dict:
    """Each :data:`GATES` field's value and reason: the largest of its
    variants' :func:`pick_gate`."""
    out = {}
    for field, (family, variants) in GATES.items():
        picks = {v: pick_gate([r for r in rows if r["family"] == family and r["variant"] == v])
                 for v in variants if any(r["family"] == family and r["variant"] == v
                                          for r in rows)}
        if picks:
            worst = max(picks, key=lambda v: picks[v][0])
            out[field] = {"value": picks[worst][0], "from": worst,
                          "picks": {v: g for v, (g, _) in picks.items()},
                          "note": picks[worst][1]}
    return out


def _input(n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, n), device="cuda", generator=gen).to(dtype)


def pair_row(variant: str, n: int, l2: int, seed: int = 0) -> dict:
    """K2 and the plain spelling of ``variant`` at n^2, checked bit for bit
    and timed; ``stream`` times ``x + 1.0`` (kernel arm) against
    ``x.clone()`` (plain arm), the litmus."""
    from ..bench import rotated

    row = {"family": "pair", "variant": variant, "n": n, "elements": n * n, "notes": []}
    if variant == "stream":
        dtype, ops, passes = torch.float32, 1, 2
        kernel, plain = (lambda x: x + 1.0), torch.clone
    else:
        dtype, ops, passes, plain = PAIR[variant]
        kernel = _pair_kernels()[variant]
    inputs = rotated(_input(n, dtype, seed), l2, operands=ops)
    args = inputs[:ops]
    if variant != "stream":
        row["ok"] = bool(torch.equal(kernel(*args), plain(*args)))
    traffic = {"bytes": passes * n * n * inputs[0].element_size()}
    time_arm(row, "kernel", kernel, inputs, traffic, ops)
    time_arm(row, "plain", plain, inputs, traffic, ops)
    if variant == "stream":  # the litmus: near the copy's rate, under the HBM rate
        row["ok"] = not any(": no-measurement" in note for note in row["notes"])
        if n >= 8192:
            ratio = row.get("kernel_device_gbs", 0.0) / row.get("plain_device_gbs", 1.0)
            row["ok"] = row["ok"] and abs(ratio - 1) <= 0.15
    return row


def stream_row(variant: str, n: int, l2: int, seed: int = 0) -> dict:
    """``variant`` of :data:`STREAM` at n^2 through the engine, K3's gate
    forced low (kernel arm) and high (plain arm); the kernel result within
    K3's tolerance of the plain one. One pass over the input."""
    import strided_tpu_torch as st
    from ..bench import rotated
    from ..config import get_config, set_config
    from ..core import kernels_special

    dtype, call = STREAM[variant]
    row = {"family": "stream", "variant": variant, "n": n, "elements": n * n, "notes": []}
    inputs = rotated(_input(n, dtype, seed), l2)
    views = [st.strided(t) for t in inputs]
    old = get_config().min_stream_reduce_elements
    results = {}
    try:
        for arm, gate in (("kernel", 1), ("plain", 1 << 60)):
            set_config(min_stream_reduce_elements=gate)
            kernels_special.LAST_REDUCE_DISPATCH = ""
            results[arm] = st.materialize(call(views[0])).float()
            row[f"{arm}_record"] = kernels_special.LAST_REDUCE_DISPATCH
            time_arm(row, arm, call, views, {"bytes": n * n * inputs[0].element_size()})
    finally:
        set_config(min_stream_reduce_elements=old)
    a = inputs[0].float()
    tol = 1e-6 * n * a.abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * results["plain"].abs().max().item()
    err = (results["kernel"] - results["plain"]).abs().max().item()
    row.update(max_abs_err=err, tol=tol,
               ok=bool(err <= tol and row["kernel_record"] == "stream-kernel"
                       and row["plain_record"] != "stream-kernel"))
    return row


def run(families=("pair", "stream"), sizes=SIZES, variants=None, seed: int = 0) -> list:
    """Every selected variant at every size; prints each row, then the
    gates, and returns the rows."""
    from ..bench import card_label, l2_bytes

    if not torch.cuda.is_available():
        raise RuntimeError("exp_crossover measures the card; no CUDA device found")
    card = card_label()
    l2, how = l2_bytes()
    print(json.dumps({"card": card, "l2_bytes": l2, "l2": how}), flush=True)
    rows = []
    for n in sizes:
        if "pair" in families:
            for v in ("stream", *PAIR):
                if not variants or v in variants:
                    rows.append(pair_row(v, n, l2, seed))
                    print(json.dumps(rows[-1]), flush=True)
        if "stream" in families:
            for v in STREAM:
                if not variants or v in variants:
                    rows.append(stream_row(v, n, l2, seed))
                    print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"gates": gates(rows), "card": card}), flush=True)
    return rows


def read_rows(paths, key: str) -> list:
    """The rows (JSON lines holding ``key``) that earlier runs printed."""
    rows = []
    for path in paths:
        with open(path) as f:
            rows += [r for r in map(json.loads, (ln for ln in f if ln.startswith("{")))
                     if key in r]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="pair,stream")
    ap.add_argument("--sizes", default=None, help="comma-separated square sides")
    ap.add_argument("--variants", default=None, help="comma-separated subset")
    ap.add_argument("--from", dest="logs", nargs="+", default=None,
                    help="print the gates of the rows in these earlier outputs; no card needed")
    args = ap.parse_args(argv)
    if args.logs:
        print(json.dumps({"gates": gates(read_rows(args.logs, "variant"))}))
        return 0
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes else SIZES
    rows = run(args.family.split(","), sizes,
               args.variants.split(",") if args.variants else None)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
