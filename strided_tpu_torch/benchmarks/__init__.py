"""Probe scripts of the port: the transpose-pair family's kernels, measured
on the card (``python -m strided_tpu_torch.benchmarks.exp_sym``,
``... .exp_pair_rect``)."""

import json
import sys


def cli(run, n_default: int, argv=None) -> int:
    """``[variant,names] [n]`` from ``argv``: ``run(names, n)``, one JSON line
    per variant; 0 when every variant equals its plain result."""
    argv = sys.argv[1:] if argv is None else argv
    names = argv[0].split(",") if argv else None
    rows = run(names, int(argv[1]) if len(argv) > 1 else n_default)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1
