"""The QP solve's share of its roofline: ``qp_solve`` on the cell's QP and
the last period's deviations, captured alone in a CUDA graph and timed
by CUDA events over its replays. The least time is the larger of the needed FLOP over
the card's FP32 peak and the needed bytes over its HBM rate
(``counts.qp_solve``), whatever implements the solve."""

from portbench.common import FP32_OPS_PER_S, HBM_BYTES_PER_S, graph_ms
from portbench.counts import qp_solve as needed


def read(trace):
    p = trace.extra.get("qp")
    if p is None:
        return None
    from strided_tpu_torch.mpc.qp import qp_solve

    qp, dx = p["qp"], p["dx"].contiguous()
    ms = graph_ms(lambda: qp_solve(qp, dx, p["u_min"], p["u_max"], p["iters"]),
                  reps=20, replays=5)
    c = needed(dx.shape[0], qp.N, qp.n, qp.m, p["iters"])
    least_s = max(c["flops"] / FP32_OPS_PER_S, c["bytes"] / HBM_BYTES_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
