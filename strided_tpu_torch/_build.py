"""Build the package's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled at first use (one nvcc per file, all
at once) and linked into one shared library with a plain C interface, under
``strided_tpu_torch/_build/``. The library is
named after a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "find_nvcc"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register, shared-memory and spill report, kept in the log
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``, else
    under the toolkit PyTorch itself located. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:  # pragma: no cover - torch without cpp_extension
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA toolkit is "
        "needed to build strided_tpu_torch's kernels (csrc/*.cu)"
    )


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libstrided_kernels_{h.hexdigest()[:16]}.so"
    if not lib.is_file():
        BUILD_DIR.mkdir(exist_ok=True)
        _compile_and_link(sources, lib)
    return ctypes.CDLL(str(lib))


def _compile_and_link(sources: list[Path], lib: Path) -> None:
    """One nvcc per ``.cu`` source, all started together, then one link.
    The compiler output of every step goes to the ``.log`` beside ``lib``."""
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in (p for p in sources if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{lib.stem}.{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log = []
    failed = []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = lib.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _c, o, _p in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
