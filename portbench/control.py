"""The readings a limit is set from: the port's over many seeds, and the
lower-precision control's, each at the cell's own size with a short
window, in one process.

    python3 -m portbench.control --workload <name> --seeds a,b,... \\
        --control-seeds c,d,e [--seconds 1.5]

prints one JSON line a run: ``{"seed", "side", "checks", ...}``, ``side``
``program`` or ``control``. The control of a cell is the
step below the precision its configuration states: for the MPC cells, the
port's own TF32 path (``matmul_precision="high"``; the configuration
states IEEE FP32 products with TF32 off); for the engine, the reference
computed in bf16 and put in the port's place (the configuration states
float32 and the expressions have no products). The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .common import Cell
from .reference import strided_readme as ref


def bf16_spellings() -> dict:
    """The README's expressions by the reference in bf16, returned in the
    input's dtype: the engine cells' control."""
    return {name: (lambda f: lambda x: f(x.bfloat16()).to(x.dtype))(f)
            for name, f in ref.EXPRESSIONS.items()}


def _control(cell: Cell) -> Cell:
    if cell.config["generator"] == "engine_mix":
        return cell
    return Cell(cell.name, dict(cell.config, matmul_precision="high"), cell.traffic, cell.chips)


def readings(cell: Cell, seeds, control_seeds, seconds: float, device="cuda"):
    """Yield one row a run: the program on ``seeds``, then the control on
    ``control_seeds``."""
    from .generators import engine_mix

    drv = __import__(f"portbench.generators.{cell.config['generator']}",
                     fromlist=["run"]).run
    for side, seeds_, c in (("program", seeds, cell), ("control", control_seeds, _control(cell))):
        for seed in seeds_:
            saved = engine_mix.spellings
            if side == "control" and c.config["generator"] == "engine_mix":
                engine_mix.spellings = bf16_spellings
            try:
                out = drv(c, seed, seconds, False, device=device)
            finally:
                engine_mix.spellings = saved
            yield {"seed": seed, "side": side, "checks": out.checks, "failed": out.failed,
                   "attempted": out.attempted, "metrics": out.metrics}


def _ints(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    from .run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.5)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("portbench.control reads the card; too few CUDA devices", file=sys.stderr)
        return 2
    for row in readings(cell, _ints(args.seeds), _ints(args.control_seeds), args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
