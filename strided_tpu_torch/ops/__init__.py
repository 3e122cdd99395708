"""Public op namespace of the strided engine."""

from ..core.view import (  # noqa: F401
    StridedView,
    StridedLayoutError,
    strided,
    as_view,
    isstrided,
    permutedims,
    transpose,
    adjoint,
    conj,
    sreshape,
    sview,
    set_view,
    flip,
    broadcast_to,
)
from ..core.mapreduce import (  # noqa: F401
    smap,
    map_into,
    copy_into,
    permutedims_into,
    adjoint_into,
    conj_into,
    sreduce,
    sreduce_dims,
    mapreducedim_into,
    fused_mapreduce,
    ssum,
    sprod,
    smax,
    smin,
    smean,
)
from ..core.broadcast import sbroadcast, sbroadcast_into  # noqa: F401
from ..core.regularize import materialize  # noqa: F401
from ..api import strided_jit, to_array  # noqa: F401
from ..core.kernels_special import symmetrize, pair_axpby  # noqa: F401
from ..linalg import mul, matmul, axpy, axpby, lmul, rmul, scale_into, contract  # noqa: F401
