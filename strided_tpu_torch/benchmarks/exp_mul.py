"""The fixed cost of ``st.mul`` over a bare matmul on the card: the port of
``benchmarks/exp_mul_r5.py``.

Four spellings of ``x.T @ x`` at IEEE FP32, f32, at d = 1024 and 2048:

- ``torch``: ``torch.matmul(x.T, x)`` (the yardstick);
- ``flat_reshape``: the same on operands taken through the engine's flat
  parent (``x.reshape(-1).reshape(d, d)``; torch makes views, no copy);
- ``engine``: ``st.mul`` with a new ``C`` a call (zeros, the product,
  the write into C's new parent, ``to_array``);
- ``engine_noalloc``: ``st.mul`` into a ``C`` made once.

Each is timed through ``bench.rotating_ms`` (eager, host included, and
device time). The host overhead a call of ``st.mul`` is
``engine_noalloc``'s eager time less ``torch``'s; the device's share of
the gap is the same difference in device time.

    python -m strided_tpu_torch.benchmarks.exp_mul [d,d]

prints one JSON line a size. It needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

__all__ = ["variants", "run", "main"]


def variants(d: int, device="cuda"):
    """``{name: fn(x)}``, the four spellings at side ``d``."""
    import strided_tpu_torch as st
    from ..config import matmul_precision_scope

    ieee = matmul_precision_scope
    C_pre = st.strided(torch.zeros((d, d), device=device))

    def engine(x):
        C = st.strided(torch.zeros((d, d), dtype=x.dtype, device=x.device))
        return st.to_array(st.mul(C, st.transpose(st.strided(x)), st.strided(x)))

    return {
        "torch": ieee(lambda x: torch.matmul(x.T, x)),
        "flat_reshape": ieee(lambda x: torch.matmul(x.reshape(-1).reshape(d, d).T,
                                                    x.reshape(-1).reshape(d, d))),
        "engine": engine,
        "engine_noalloc": lambda x: st.to_array(
            st.mul(C_pre, st.transpose(st.strided(x)), st.strided(x))),
    }


def run(sizes=(1024, 2048), seed: int = 0) -> list:
    """Check each spelling against ``torch`` and time it at each size."""
    from ..bench import card_label, l2_bytes, rotated, rotating_ms

    if not torch.cuda.is_available():
        raise RuntimeError("exp_mul measures the card; no CUDA device found")
    card = card_label()
    l2, _ = l2_bytes()
    rows = []
    for d in sizes:
        x = torch.randn((d, d), device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
        V = variants(d)
        want = V["torch"](x)
        inputs = rotated(x, l2)
        row = {"d": d, "copies": len(inputs), "card": card}
        for name, fn in V.items():
            row[f"{name}_err"] = (fn(x) - want).abs().max().item()
            t = rotating_ms(fn, inputs)
            row[f"{name}_ms"], row[f"{name}_device_ms"] = t["eager_ms"], t["device_ms"]
            row[f"{name}_tflops"] = 2 * d ** 3 / t["eager_ms"] / 1e9
        row["host_overhead_ms"] = row["engine_noalloc_ms"] - row["torch_ms"]
        if row["engine_noalloc_device_ms"] and row["torch_device_ms"]:
            row["device_overhead_ms"] = row["engine_noalloc_device_ms"] - row["torch_device_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sizes = tuple(int(s) for s in argv[0].split(",")) if argv else (1024, 2048)
    run(sizes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
