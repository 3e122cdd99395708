"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``: its sizes, its
generator, the limits of its checks) and a traffic mix
(``traffic/<traffic>.json``). The configuration's generator
(``generators/<generator>.py``) sets the port up, warms up every shape the mix
uses, measures for ``--seconds``, and then holds a sample of what the
timed path produced against the plain reference. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1`` the
window is followed by a profiled tail of the same calls, and the result's
metrics are the per-layer ones, each read by ``metrics/<metric>.py``.

Earlier lines of standard error give the card, its power limit and
``nvidia-smi``'s clocks, power and temperature before and after it; its last lines, each reading
beside its limit. The last line of standard output is one JSON object.
Without a CUDA device, with fewer than the cell asks for, or with JAX or
the JAX package loaded, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
# every kernel and build cache at a fixed path inside the checkout, so that
# only a checkout's first run builds; the port's nvcc library builds into
# strided_tpu_torch/_build/ by itself
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")

import torch  # noqa: E402

from .common import Cell, card_label, forbidden_modules, smi_sample  # noqa: E402


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(workload: str) -> Cell:
    """The cell named ``workload``, with its configuration and traffic read."""
    b = benchmark()
    entry = next((w for w in b["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == entry["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(workload, config, traffic, int(entry["chips"]))


def metrics_of(cell: Cell, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those listing it,
    and those with no list that move an end-to-end metric it reports."""
    b = benchmark()
    e2e = [m for m in b["end_to_end"] if cell.name in m.get("workloads", [cell.name])]
    if kind == "end_to_end":
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in b["per_layer"]
            if cell.name in m["workloads"] or ("workloads" not in m and m["moves"] in mine)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(trace) -> float | None``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_reader(cell: Cell):
    """A function of a trace giving the cell's per-layer values by name; a
    reader that finds nothing to read gives None and is left out."""
    readers = {m["name"]: reader(m["name"]) for m in metrics_of(cell, "per_layer")}

    def read(trace) -> dict:
        vals = {name: fn(trace) for name, fn in readers.items()}
        return {k: v for k, v in vals.items() if v is not None}

    return read


def generator(cell: Cell):
    return importlib.import_module(f"portbench.generators.{cell.config['generator']}")


def judge(cell: Cell, out) -> tuple:
    """``(correct, lines)``: every reading at or under its limit, every
    limit read, no failed request."""
    limits = cell.config["limits"]
    lines, ok = [], out.failed == 0 and set(out.checks) == set(limits)
    for name, limit in limits.items():
        value = out.checks.get(name, float("nan"))
        ok = ok and value <= limit
        lines.append((name, value, limit))
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_label()}", file=sys.stderr)
    want = metrics_of(cell, "per_layer" if args.trace else "end_to_end")
    read_layers = layer_reader(cell) if args.trace else None

    print(f"nvidia-smi before: {smi_sample()}", file=sys.stderr)
    print(f"set-up: process start to the generator {time.time() - PROCESS_START:.3f} s "
          f"(imports, the device's first use)", file=sys.stderr)
    out = generator(cell).run(cell, args.seed, args.seconds, bool(args.trace), read_layers)
    print(f"nvidia-smi after: {smi_sample()}", file=sys.stderr)
    if out.trace is not None:
        out.summarise_trace()

    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that no run may load: {found}", file=sys.stderr)
        return 3

    values = dict(out.metrics, setup_s=out.window_open - PROCESS_START)
    if args.trace:
        values = out.layers
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in want if m["name"] in values}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": False, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
        result["breakdown"] = out.breakdown
    correct, lines = judge(cell, out)
    result["correct"] = bool(correct)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in lines}
    for note in out.notes:
        print(note, file=sys.stderr)
    print("end-to-end: " + ", ".join(f"{k} {v!r}" for k, v in
                                     dict(out.metrics, setup_s=out.window_open
                                          - PROCESS_START).items()), file=sys.stderr)
    for n, v, lim in lines:
        print(f"check {n}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
