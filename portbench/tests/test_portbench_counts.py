"""The harness's operation and byte counts against hand counts."""

from portbench import counts


def test_qp_counts_by_hand():
    # B=2 states, N=3 stages of m=4 inputs (D=12), n=12 states, 2 iterations
    c = counts.qp_solve(2, 3, 12, 4, 2)
    g_and_warm = 2 * (2 * 2 * 12 * 12)      # M x and -K x
    iterations = 2 * (2 * 2 * 12 * 12)      # two products by the 12 x 12 factor
    assert c["flops"] == g_and_warm + iterations == 2304
    # x (2x12), M and K (12x12 each), S (12x12), bounds (2x4), z (2x12), 4 bytes each
    assert c["bytes"] == 4 * (24 + 288 + 144 + 8 + 24)


def test_qp_counts_at_the_cell():
    c = counts.qp_solve(16384, 50, 12, 4, 6)
    assert c["flops"] == 2 * 2 * 16384 * 200 * 12 + 6 * 2 * 16384 * 200 * 200
    assert abs(c["flops"] / 67e12 * 1e3 - 0.1197) < 1e-3  # ms at the FP32 peak


def test_four_permute_sum_needs_two_passes_not_five():
    n = 32 ** 4
    assert counts.elementwise_pass(n, 4) == 2 * n * 4
    assert counts.elementwise_pass(n, 4) != 5 * n * 4  # the TPU script's traffic model


def test_symmetrize_needs_two_passes():
    assert counts.elementwise_pass(8192 * 8192, 4) == 2 * 8192 * 8192 * 4
