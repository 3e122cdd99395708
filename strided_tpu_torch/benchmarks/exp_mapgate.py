"""Where K4's maps start to win on the card: the port of
``benchmarks/exp_mapgate_r5.py``, which audited the JAX package's
``pallas_map_min_elements``.

Two workloads through the public engine, each with K4 forced on (the
kernel arm: ``map_min_elements`` and ``min_kernel_elements`` at 1024) and
forced off (the plain arm: ``map_min_elements`` at 2^60):

- ``scaleT``: ``out = 0.999 * A.T`` through ``scale_into(dst, 0.999,
  transpose(v))``, f32, at the TPU script's 6144 and 8192 and at square
  sides in sqrt(2) steps from 256 to 8192 (2^16-2^26 elements);
- ``rev4``: the rank-4 reversal ``permutedims_into(out, v, (3, 2, 1, 0))``
  at D^4, D = 16, 24, 32, 48, 64 (BASELINE config 1's 32^4 and the probes'
  64^4).

Each kernel result equals the plain one bit for bit (a copy and one
multiply); each arm is timed through ``bench.rotating_ms`` (eager and
device time, inputs rotated through copies over 4x the L2), 2 passes over
the input's bytes. :func:`gates` applies ``exp_crossover.pick_gate``:
``map_min_elements`` is the larger of the two workloads' crossovers (no
map below it loses to plain), ``min_kernel_elements``, K4's floor under
every family, the smaller, never above ``map_min_elements``.

    python -m strided_tpu_torch.benchmarks.exp_mapgate [--workloads scaleT,rev4]
        [--sizes 256,6144]

prints one JSON line a (workload, size), then one line of the gates. It
needs a CUDA device. ``--from OUT [OUT ...]`` prints instead the gates of
the rows that earlier runs printed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import time_arm
from .exp_crossover import LADDER, pick_gate, read_rows

__all__ = ["SCALE_SIZES", "REV4_SIDES", "KERNEL", "PLAIN", "row", "gates", "run", "main"]

SCALE_SIZES = tuple(sorted(set(LADDER) | {6144, 8192}))
REV4_SIDES = (16, 24, 32, 48, 64)
KERNEL = dict(map_min_elements=1024, min_kernel_elements=1024)
PLAIN = dict(map_min_elements=1 << 60)


def _scale_t(x):
    import strided_tpu_torch as st

    dst = st.strided(torch.empty(x.shape[::-1], dtype=x.dtype, device=x.device))
    return st.to_array(st.scale_into(dst, 0.999, st.transpose(st.strided(x))))


def _rev4(x):
    import strided_tpu_torch as st

    out = st.permutedims_into(st.strided(torch.empty_like(x)), st.strided(x), (3, 2, 1, 0))
    return out.parent.reshape(x.shape)


WORKLOADS = {"scaleT": (_scale_t, lambda d: (d, d), SCALE_SIZES),
             "rev4": (_rev4, lambda d: (d,) * 4, REV4_SIDES)}


def row(workload: str, d: int, l2: int, seed: int = 0) -> dict:
    """Both arms of ``workload`` at side ``d``: each result and route, then
    each timed; ``ok`` when the results are equal and the kernel arm ran K4
    and the plain arm did not."""
    from ..bench import rotated
    from ..config import get_config, set_config
    from .sweeps import route_of

    fn, shape, _ = WORKLOADS[workload]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape(d), device="cuda", generator=gen)
    r = {"workload": workload, "d": d, "elements": x.numel(), "notes": []}
    inputs = rotated(x, l2)
    old = get_config()
    results = {}
    try:
        for arm, cfg in (("kernel", KERNEL), ("plain", PLAIN)):
            set_config(**cfg)
            results[arm], route = route_of(lambda: fn(x))
            r[f"{arm}_route"] = route["route"]
            time_arm(r, arm, fn, inputs, {"bytes": 2 * x.numel() * 4})
    finally:
        set_config(**{k: getattr(old, k) for k in ("map_min_elements", "min_kernel_elements")})
    r["ok"] = bool(torch.equal(results["kernel"], results["plain"])
                   and r["kernel_route"].startswith("K4") and r["plain_route"] == "plain")
    return r


def gates(rows) -> dict:
    """``map_min_elements`` and ``min_kernel_elements`` with their reasons
    from the rows of both workloads (see the module docstring)."""
    picks = {w: pick_gate([r for r in rows if r["workload"] == w])
             for w in WORKLOADS if any(r["workload"] == w for r in rows)}
    if not picks:
        return {}
    hi = max(picks, key=lambda w: picks[w][0])
    lo = min(picks, key=lambda w: picks[w][0])
    return {"map_min_elements": {"value": picks[hi][0], "from": hi, "note": picks[hi][1]},
            "min_kernel_elements": {"value": picks[lo][0], "from": lo, "note": picks[lo][1]},
            "picks": {w: g for w, (g, _) in picks.items()}}


def run(workloads=tuple(WORKLOADS), sizes=None, seed: int = 0) -> list:
    """Every selected workload at its sizes (or ``sizes``); prints each row,
    then the gates, and returns the rows."""
    from ..bench import card_label, l2_bytes

    if not torch.cuda.is_available():
        raise RuntimeError("exp_mapgate measures the card; no CUDA device found")
    card = card_label()
    l2, how = l2_bytes()
    print(json.dumps({"card": card, "l2_bytes": l2, "l2": how}), flush=True)
    rows = []
    for w in workloads:
        for d in (sizes or WORKLOADS[w][2]):
            rows.append(row(w, d, l2, seed))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"gates": gates(rows), "card": card}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--sizes", default=None, help="comma-separated sides")
    ap.add_argument("--from", dest="logs", nargs="+", default=None,
                    help="print the gates of the rows in these earlier outputs; no card needed")
    args = ap.parse_args(argv)
    if args.logs:
        print(json.dumps({"gates": gates(read_rows(args.logs, "workload"))}))
        return 0
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes else None
    rows = run(args.workloads.split(","), sizes)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
