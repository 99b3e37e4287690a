"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, with one ``nvcc`` process per source, all
started together, into ``gym_electric_motor_tpu_torch/_build/`` (or the
directory named by ``GEMX_TORCH_BUILD_DIR``); a library is reused while
the hash of the sources and flags is unchanged.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# -fmad=false: every multiply and add is rounded on its own, as PyTorch's
# separate ops round them, so that a kernel tracks its plain version over
# thousands of steps (with contraction, the random recorder drifted past
# rtol 1e-4 in 2% of envs by step 1024)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per-library ptxas report (registers, spills) of the last build, and the
# seconds the build took
BUILD_LOG: dict = {}
_LOADED: dict = {}


def build_dir() -> Path:
    d = os.environ.get("GEMX_TORCH_BUILD_DIR")
    return Path(d) if d else Path(__file__).resolve().parent.parent / "_build"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the CUDA "
                           "kernels of this package are built with it at first use")
    return nvcc


def _lib_path(source: Path, flags) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [source]:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir() / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one nvcc
    process per source in parallel; returns ``{name: library path}``."""
    paths = {n: _lib_path(CSRC / f"{n}.cu", NVCC_FLAGS) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, todo[n])
    BUILD_LOG["seconds"] = time.time() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]
