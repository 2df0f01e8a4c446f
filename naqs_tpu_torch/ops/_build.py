"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` compiles on first use into
`<repo>/build/naqs_tpu_torch/lib<name>.so` for sm_90a, with a plain C
interface; nothing here includes PyTorch's headers, so a build takes
seconds. A library is rebuilt when its source is newer. `build_all` starts
one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "naqs_tpu_torch")
SOURCES = ("rank_gather", "grid_engine", "sampler_step")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _start(name: str):
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, cmd


def _finish(job) -> str:
    proc, tmp, lib, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(names=SOURCES) -> dict:
    """Compile every stale kernel in parallel; returns nvcc's output by name
    (its -Xptxas -v register and shared-memory report)."""
    jobs = {n: _start(n) for n in names if _stale(n)}
    return {n: _finish(j) for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if missing or stale."""
    if name not in _loaded:
        if _stale(name):
            _finish(_start(name))
        _loaded[name] = ctypes.CDLL(_paths(name)[1])
    return _loaded[name]
