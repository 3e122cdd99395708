"""The five worked examples of Strided.jl's README as plain PyTorch.

Each takes the input array and returns a new one, in the input's dtype:
f64 for the reference, bf16 for the lower-precision control.
"""

from __future__ import annotations

import torch

P2, P3, P4 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)


def symmetrize(a):
    return (a + a.T) / 2


def scale_transpose(a):
    return 3 * a.T


def broadcast(a):
    return a * torch.exp(-2 * a) + torch.sin(a * a)


def permutedims(a):
    return a.permute(3, 2, 1, 0)


def permute_sum(a):
    return a + a.permute(P2) + a.permute(P3) + a.permute(P4)


EXPRESSIONS = {f.__name__: f for f in (symmetrize, scale_transpose, broadcast, permutedims,
                                       permute_sum)}


def gap(name: str, x: torch.Tensor, out: torch.Tensor, dtype=torch.float64) -> float:
    """The widest gap between ``out`` and the expression on ``x`` computed
    in ``dtype`` and rounded to ``out``'s dtype, element by element, each
    over ``|reference| + 1``: a relative gap where the value is large and
    an absolute one where it is small, so that no element is judged by
    another's size. Exact arithmetic gives 0."""
    ref = EXPRESSIONS[name](x.to(dtype)).to(out.dtype).double()
    return float(((out.double() - ref).abs() / (ref.abs() + 1)).max())
