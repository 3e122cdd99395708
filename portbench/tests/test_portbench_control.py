"""The control comes out not correct, and the program correct, under each
configuration's limits: the engine's bf16 reference on the CPU and on the
card, the MPC cells' TF32 path on the card only (the CPU has no TF32)."""

import pytest

from portbench.control import readings
from portbench.tests.helpers import tiny


def _judged(cell, rows):
    limits = cell.config["limits"]
    over = {side: [any(r["checks"][k] > limits[k] for k in limits) for r in rows if r["side"] == side]
            for side in ("program", "control")}
    return over


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_engine_control_fails_and_program_passes(device, request):
    if device == "cuda":
        request.getfixturevalue("card")
    cell = tiny("strided_readme.card_scale")
    over = _judged(cell, list(readings(cell, [11, 12, 13], [21, 22, 23], 0.3, device=device)))
    assert over["program"] == [False] * 3 and over["control"] == [True] * 3


def test_fleet_control_fails_and_program_passes(card):
    cell = tiny("quadrotor_mpc.fleet16k")
    cell.traffic = dict(cell.traffic, batch=2048)
    over = _judged(cell, list(readings(cell, [11, 12, 13], [21, 22, 23], 0.5, device=card)))
    assert over["program"] == [False] * 3 and over["control"] == [True] * 3

