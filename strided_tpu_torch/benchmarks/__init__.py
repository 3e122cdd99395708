"""Benchmark and probe scripts of the port, measured on the card (``python
-m strided_tpu_torch.benchmarks.exp_sym``, ``... .sweeps``, ...)."""

import json
import sys

import torch


def cli(run, n_default: int, argv=None) -> int:
    """``[variant,names] [n]`` from ``argv``: ``run(names, n)``, one JSON line
    per variant; 0 when every variant equals its plain result."""
    argv = sys.argv[1:] if argv is None else argv
    names = argv[0].split(",") if argv else None
    rows = run(names, int(argv[1]) if len(argv) > 1 else n_default)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


def check_out(what: str, x: torch.Tensor, out: torch.Tensor | None) -> None:
    """Refuse an ``out`` that is not a contiguous tensor of ``x``'s shape,
    dtype and device (the result's, for every probe kernel), or that
    overlaps ``x``."""
    if out is None:
        return
    if (not isinstance(out, torch.Tensor) or out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {x.dtype} tensor of shape "
                         f"{tuple(x.shape)} on {x.device}")
    lo, n = x.data_ptr(), x.numel() * x.element_size()
    o_lo, o_n = out.data_ptr(), out.numel() * out.element_size()
    if o_lo < lo + n and lo < o_lo + o_n:
        raise ValueError(f"{what}: out overlaps the input")


def into(out: torch.Tensor | None, result: torch.Tensor) -> torch.Tensor:
    """``result`` written into ``out`` and ``out`` returned, or ``result``
    itself when there is no ``out``: the plain versions' side of ``out=``."""
    return result if out is None else out.copy_(result)


def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit as values, NaNs in the same places."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan]))


def time_arm(row: dict, arm: str, fn, inputs, traffic: dict, operands: int = 1) -> None:
    """Time ``fn`` over the rotated ``inputs`` (``bench.rotating_ms``) into
    ``row``: ``{arm}_ms`` and ``{arm}_device_ms``, the rates of ``traffic``
    (``{"bytes": n}``: ``{arm}_gbs``, ``{arm}_device_gbs``; ``{"flops": n}``:
    ``_tflops``), ``copies``, and ``bench.rate_notes`` (or why the device
    time is missing) under ``notes``."""
    from ..bench import rate_notes, rotating_ms

    t = rotating_ms(fn, inputs, operands=operands)
    unit, per_ms = (("gbs", traffic["bytes"] / 1e6) if "bytes" in traffic
                    else ("tflops", traffic["flops"] / 1e9))
    row["copies"] = t["copies"]
    notes = row.setdefault("notes", [])
    for kind, key in (("", "eager_ms"), ("_device", "device_ms")):
        ms = row[f"{arm}{kind}_ms"] = t[key]
        if ms is None:
            notes.append(f"{arm} device time not measured: {t['device_error']}")
            continue
        rate = row[f"{arm}{kind}_{unit}"] = per_ms / ms
        notes += [f"{arm}{kind}: {n}" for n in rate_notes(**{unit: rate})]
