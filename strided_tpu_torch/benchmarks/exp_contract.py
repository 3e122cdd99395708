"""A contraction on a lazily transposed operand copies nothing: the port of
``benchmarks/exp_contract_r5.py``.

1. **No copy** (the TPU script checked its compiled HLO for a top-level
   transpose or copy): ``contract("ab,bc->ac", transpose(v), w)`` and
   ``mul(C, transpose(v), w)`` at 1024^2 f32 are profiled on the card
   (``torch.profiler``, after a warm-up that makes cuBLAS's workspace). The
   check passes when no kernel but the product's runs before the product
   (no copy or elementwise kernel writes an operand-sized buffer first; a
   memset is not counted) and
   the allocator's peak grows by no more than the result's bytes
   (``contract``; ``mul`` also writes its result into C's new parent, one
   result more; C is made before).
2. **Timing**: the lazy spelling against ``torch.einsum`` on the dense
   transpose at 2048^2 (the TPU script's ``timing_parity``), IEEE FP32 on
   both sides, through ``bench.rotating_ms``.

    python -m strided_tpu_torch.benchmarks.exp_contract

prints the check's line and the timing's line as JSON; exit 1 when the
check fails. It needs a CUDA device.
"""

from __future__ import annotations

import json
import re
import sys

import torch

__all__ = ["GEMM", "no_copy_check", "timing", "main"]

GEMM = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)  # cuBLAS's product kernels


def _device_kernels(prof) -> list:
    """Names of the device kernels the profile saw, in launch order."""
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(ev, key=lambda e: e.time_range.start)]


def no_copy_check(d: int = 1024, seed: int = 0) -> dict:
    """Profile ``contract`` and ``mul`` on a lazily transposed f32 operand at
    ``d``^2; returns each one's kernels before the product, peak growth and
    ``ok``."""
    from torch.profiler import ProfilerActivity, profile

    import strided_tpu_torch as st

    if not torch.cuda.is_available():
        raise RuntimeError("exp_contract measures the card; no CUDA device found")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((d, d), device="cuda", generator=gen)
    b = torch.randn((d, d), device="cuda", generator=gen)
    C = torch.empty((d, d), device="cuda")
    result_bytes = d * d * 4
    calls = {
        "contract": (lambda: st.contract("ab,bc->ac", st.transpose(st.strided(a)),
                                         st.strided(b)), 1),
        "mul": (lambda: st.to_array(st.mul(st.strided(C), st.transpose(st.strided(a)),
                                           st.strided(b))), 2),
    }
    want = torch.matmul(a.T.double(), b.double())
    out = {"d": d}
    for name, (call, results) in calls.items():
        got = call()  # warm-up: cuBLAS's handle and workspace
        err = (got.double() - want).abs().max().item()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = call()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        names = _device_kernels(prof)
        first = next((i for i, n in enumerate(names) if GEMM.search(n)), None)
        # a memset (cuBLAS zeroing its workspace) moves no operand
        before = [n for n in (names if first is None else names[:first])
                  if not n.startswith("Memset")]
        out[name] = {"kernels": names, "before_product": before, "peak_growth": peak,
                     "limit": results * result_bytes, "max_abs_err_vs_f64": err,
                     "ok": bool(first is not None and not before
                                and peak <= results * result_bytes)}
        del got
    out["ok"] = all(out[n]["ok"] for n in calls)
    return out


def timing(d: int = 2048, seed: int = 0) -> dict:
    """``contract`` on ``transpose(v)`` against ``torch.einsum`` on the dense
    transpose (made once, outside the timed calls), each at IEEE FP32 and
    scaled by 1/sqrt(d) as the TPU script's; eager and device ms."""
    import strided_tpu_torch as st
    from ..bench import card_label, l2_bytes, rotated, rotating_ms
    from ..config import matmul_precision_scope

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((d, d), device="cuda", generator=gen)
    b = torch.randn((d, d), device="cuda", generator=gen)
    s = 1.0 / d ** 0.5
    l2, _ = l2_bytes()

    def lazy(x):
        return st.contract("ab,bc->ac", st.transpose(st.strided(x)), st.strided(b)) * s

    dense = matmul_precision_scope(lambda xt: torch.einsum("ab,bc->ac", xt, b) * s)
    row = {"d": d, "card": card_label()}
    for name, fn, x in (("lazy", lazy, a), ("dense", dense, a.T.contiguous())):
        t = rotating_ms(fn, rotated(x, l2))
        row[f"{name}_ms"], row[f"{name}_device_ms"] = t["eager_ms"], t["device_ms"]
    row["ratio"] = row["lazy_ms"] / row["dense_ms"]
    if row["lazy_device_ms"] and row["dense_device_ms"]:
        row["device_ratio"] = row["lazy_device_ms"] / row["dense_device_ms"]
    return row


def main(argv=None) -> int:
    check = no_copy_check()
    print(json.dumps(check), flush=True)
    print(json.dumps(timing()), flush=True)
    return 0 if check["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
