"""The traffic generators give the same inputs for a seed, other inputs
for another, the same sizes for every seed, and take large seeds."""

import numpy as np
import torch

from portbench.generators import engine_mix, mpc_loop
from portbench.tests.helpers import tiny

BIG = 2 ** 31 + 12345


def test_fleet_states_per_seed():
    t = tiny("quadrotor_mpc.fleet16k").traffic
    a, b, c = mpc_loop.states(t, BIG), mpc_loop.states(t, BIG), mpc_loop.states(t, BIG + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and a[1].shape == c[1].shape
    np.testing.assert_allclose(a[1].mean(axis=0), 0, atol=1e-6)  # no steady push
    assert mpc_loop.sample_periods(t, BIG) == mpc_loop.sample_periods(t, BIG)


def test_engine_operands_per_seed():
    cell = tiny("strided_readme.card_scale")
    a = engine_mix.operands(cell, BIG, "cpu", 1 << 16)
    b = engine_mix.operands(cell, BIG, "cpu", 1 << 16)
    c = engine_mix.operands(cell, 3, "cpu", 1 << 16)
    for e in a:
        assert len(a[e]) >= 2
        assert all(torch.equal(x, y) for x, y in zip(a[e], b[e]))
        assert not torch.equal(a[e][0], c[e][0])
        assert not torch.equal(a[e][0], a[e][1])  # copies differ
    assert engine_mix.sample_rounds(cell, BIG) == engine_mix.sample_rounds(cell, BIG)


def test_operands_rotate_over_four_l2():
    from portbench.common import rotation_count

    l2 = 50 * 1024 * 1024
    assert rotation_count(1000 * 1000 * 4, l2) * 1000 * 1000 * 4 > 4 * l2
    assert rotation_count(8192 * 8192 * 4, l2) == 2
