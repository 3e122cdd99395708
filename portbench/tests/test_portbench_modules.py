"""No run loads JAX or the JAX package; the reference loads nothing of the
port; without a card the command prints no result."""

import subprocess
import sys
from pathlib import Path

from portbench.common import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, check=True, timeout=300).stdout.strip()


def test_check_compares_whole_top_level_names(monkeypatch):
    assert "strided_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "strided_tpu_torch_extra", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "strided_tpu.core", sys)
    assert forbidden_modules() == ["jax", "strided_tpu"]


def test_harness_and_port_load_no_jax():
    code = ("import portbench.run, portbench.control, portbench.generators.mpc_loop, "
            "portbench.generators.engine_mix, "
            "strided_tpu_torch, strided_tpu_torch.entry\n"
            "from portbench.run import load_cell, layer_reader\n"
            "import json\n"
            "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
            "    layer_reader(load_cell(w['name']))\n"
            "from portbench.common import forbidden_modules\n"
            "print(forbidden_modules())")
    assert _loaded(code).splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_port():
    code = ("import sys, portbench.reference.quadrotor_mpc, portbench.reference.strided_readme\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'strided_tpu_torch', 'strided_tpu', 'jax'}))")
    assert _loaded(code) == "[]"


def test_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "quadrotor_mpc.fleet16k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert "{" not in p.stdout
