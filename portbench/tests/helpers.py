"""Small cells for the CPU tests."""

from portbench.run import load_cell

TINY_SHAPES = {"symmetrize": [96, 96], "scale_transpose": [80, 80], "broadcast": [64, 64],
               "permutedims": [6, 7, 8, 9], "permute_sum": [8, 8, 8, 8]}


def tiny(workload: str):
    """The cell at a size the CPU runs in a second: every knob of its
    traffic kept, the sizes cut."""
    cell = load_cell(workload)
    t = dict(cell.traffic, profile_periods=5, probe_rounds=2, profile_rounds=2)
    if "batch" in t:
        t.update(batch=64, sample_span=5, samples=2)
    if "shapes" in t:
        t.update(shapes=TINY_SHAPES, sample_span=2)
    cell.traffic = t
    return cell
