"""The port's multi-process check (``strided_tpu_torch.parallel.multiproc``)
on the CPU: two gloo ranks run the dry-run surface and agree; a failing
worker and a hung one fail the spawn with their output."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from strided_tpu_torch.parallel import multiproc  # noqa: E402


def test_two_gloo_ranks_run_the_dryrun_surface(tmp_path):
    outs = multiproc.run_multiprocess_check(nproc=2, device="cpu", timeout=120,
                                            outdir=str(tmp_path))
    lines = [next(line for line in out.splitlines() if line.startswith("MULTIPROC_OK"))
             for out in outs]
    assert [line.split()[1] for line in lines] == ["rank=0", "rank=1"]
    assert all("ranks=2 backend=gloo" in line for line in lines)
    u_vals = {line.split("u=", 1)[1] for line in lines}
    assert len(u_vals) == 1, f"ranks disagree on the consensus u: {lines}"
    for r in range(2):
        res = np.load(tmp_path / f"rank{r}.npz")
        assert str(res["backend"]) == "gloo"
        assert tuple(res["coll_mm_k"]) == (1, 0, 0)  # all_reduce, all_gather, broadcast
        assert tuple(res["coll_consensus_f32"]) == (1, 0, 0)
        # the CPU runs the kernels' plain versions: no launch
        assert int(res["k1_step_f32"]) == int(res["k2_launches"]) == 0
        assert int(res["stream_launches"]) == 0
        assert "dm_n" not in res  # the ('data', 'model') case needs 4 ranks


def test_a_failing_worker_raises_with_its_output():
    """NCCL cannot run on the CPU: every worker refuses in init_distributed,
    and the parent raises with that worker's traceback."""
    with pytest.raises(RuntimeError, match="(?s)worker [01] of 2 failed.*needs CUDA devices"):
        multiproc.run_multiprocess_check(nproc=2, device="cpu", backend="nccl", timeout=120)


def test_a_hung_worker_is_killed_at_the_timeout():
    code = "import sys, time; print('rank', sys.argv[3], flush=True); time.sleep(60)"
    with pytest.raises(RuntimeError, match="(?s)still running after 5 s were killed.*rank 1"):
        multiproc.spawn(["-c", code], 2, timeout=5)


def test_a_worker_exit_stops_the_others():
    code = ("import sys, time\n"
            "if sys.argv[3] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    with pytest.raises(RuntimeError, match="worker 1 of 2 failed with exit code 3 "
                                           "\\(ranks \\[0\\] killed\\)"):
        multiproc.spawn(["-c", code], 2, timeout=60)


def test_dryrun_multichip_defaults_to_the_card():
    """Without CUDA the entry point's default device raises before any
    worker starts: the kernels cannot be built, and the run does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from strided_tpu_torch.entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="nvcc not found"):
        dryrun_multichip(2, timeout=120)


def test_spawn_passes_the_rank_and_its_arguments():
    code = "import sys; print(sys.argv[1:])"
    outs = multiproc.spawn(["-c", code], 3, ("a", "b"), timeout=60)
    for r, out in enumerate(outs):
        init, nproc, rank, *rest = eval(out.strip())
        assert init.startswith("file://") and (nproc, rank, rest) == ("3", str(r), ["a", "b"])
