"""Operations and bytes that a piece of work needs, from its shapes alone.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; operations count the products the
algorithm needs. The numbers are the same whatever implements the work,
so a roofline share built on them reads the same work before and after a
change to the port.
"""

from __future__ import annotations


def qp_solve(batch: int, horizon: int, n: int, m: int, iters: int, itemsize: int = 4) -> dict:
    """The box-constrained condensed QP of ``batch`` states over ``horizon``
    stages by ``iters`` ADMM iterations (D = horizon * m inputs): ``g = M x``
    and the warm start ``-K x`` (2 B D n FLOP each), then one product by the
    D x D factor an iteration (2 B D^2). Bytes: the states, ``M``, ``K``,
    the factor and the bounds read once, the plan written once."""
    D = horizon * m
    flops = 2 * (2 * batch * D * n) + iters * 2 * batch * D * D
    nbytes = itemsize * (batch * n + 2 * D * n + D * D + 2 * m + batch * D)
    return {"flops": flops, "bytes": nbytes}


def elementwise_pass(numel: int, itemsize: int, inputs: int = 1) -> int:
    """Needed bytes of an expression that reads ``inputs`` arrays of
    ``numel`` elements once and writes one: the README's five expressions
    each read one array (the four-permute sum reads A four times through
    views, and needs it once) and write one."""
    return (inputs + 1) * numel * itemsize
