"""Build, load and launch the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each `csrc/<name>.cu` compiles on first use into
`<repo>/build/naqs_tpu_torch/lib<name>.so` for sm_90a, with a plain C
interface; nothing here includes PyTorch's headers, so a build takes
seconds. A library is rebuilt when its source, or a header of `csrc/`
(`*.cuh`, which a source may include), is newer. `build_all` starts
one nvcc per source at once. Every library exports
`<name>_error_string(int)`, bound as `lib.error_string`; `check_tensors`
(with `strided_ok`), `launch`, `launch_flat` and `zeroed_counters` are what
the kernels' wrappers share.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "naqs_tpu_torch")
SOURCES = ("rank_gather", "grid_engine", "sampler_step", "sort_lookup", "offdiag_h", "eri",
           "nade_glue", "grid_glue")
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
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    newest = max(os.path.getmtime(f) for f in [src, *headers])
    return not os.path.exists(lib) or os.path.getmtime(lib) < newest


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
        lib = ctypes.CDLL(_paths(name)[1])
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def strided_ok(t) -> bool:
    """Whether a kernel that reads or writes t at its strides takes it: the
    last stride 1 (or a last dimension of one entry) and no two entries at
    one address (ordered by stride, each dimension's stride at least the
    span of the ones inside it). A row-major or shell-major (rows, S, w), or a
    view of some of each row's entries, qualifies; an expanded or transposed
    one does not."""
    if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
        return False
    span = 1
    for stride, size in sorted((st, n) for st, n in zip(t.stride(), t.shape) if n > 1):
        if stride < span:
            return False
        span = stride * size
    return True


def check_tensors(name, anchor, want, align=1, strided=()):
    """Raise on anything a kernel does not take. `want` maps a field's name to
    (tensor, dtypes, shape); every tensor must lie on `anchor`'s device and,
    on the card, be contiguous (a field named in `strided` may instead be laid
    out as `strided_ok` allows), start at a multiple of `align` bytes (an int,
    or a dict by field, 1 for a field it does not name) and hold fewer than
    2^31 elements. The plain versions take strided CPU tensors. The checks run
    once per tensor in one expression (they sit on the host's side of every
    launch); a tensor that fails them is checked again step by step for the
    message."""
    dev = anchor.device
    cuda = dev.type == "cuda"
    if not cuda and dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    for key, (t, dtypes, shape) in want.items():
        a = align.get(key, 1) if isinstance(align, dict) else align
        try:
            ok = (t.device == dev and t.dtype in dtypes and t.shape == shape
                  and (not cuda or ((t.is_contiguous() or key in strided and strided_ok(t))
                                    and t.data_ptr() % a == 0))
                  and t.numel() < 1 << 31)
        except AttributeError:
            ok = False
        if not ok:
            _explain(name, dev, key, t, dtypes, shape, a, key in strided)


def _explain(name, dev, key, t, dtypes, shape, align, strided):
    """The step-by-step check of one tensor that failed `check_tensors`."""
    if not torch.is_tensor(t):
        raise ValueError(f"{name}: {key} must be a tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
    laid = "with a unit last stride and no overlap" if strided else "contiguous"
    dense = t.is_contiguous() or dev.type == "cpu" or strided and strided_ok(t)
    if t.dtype not in dtypes or tuple(t.shape) != shape or not dense:
        raise ValueError(
            f"{name}: {key} must be a {laid} {' or '.join(map(str, dtypes))} of "
            f"shape {shape}, got {t.dtype} of shape {tuple(t.shape)}"
            f"{'' if dense else f' (strides {tuple(t.stride())})'}")
    if dev.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}: {key} must be {align}-byte aligned")
    raise ValueError(f"{name}: {key} must hold fewer than 2^31 elements")


def zeroed_counters(cache: dict, device, n: int) -> torch.Tensor:
    """At least n int32 counters on the device's current stream, from `cache`
    (one set per device and stream), zero between launches: made zero once,
    and again only to grow; a kernel that counts on them sets each counter
    it used back to 0 before it ends."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in cache or cache[key].numel() < n:
        cache[key] = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
    return cache[key]


def launch(lib, name, args, device):
    """Launch kernel `name` of the loaded library `lib` on the device's current
    stream; tensors among `args` pass as pointers (None as a null pointer),
    ints as they are. Checks and counts nothing: the public wrappers do both."""
    launch_flat(lib, name, [a.data_ptr() if torch.is_tensor(a) else a for a in args], device)


def launch_flat(lib, name, flat, device):
    """`launch` with every argument already a pointer (an int, or None) or an
    int, for wrappers that count their host cost."""
    fn = getattr(lib, name)
    if device.index == torch.cuda.current_device():   # no device switch to pay for
        rc = fn(*flat, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*flat, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(rc).decode()} ({rc})")
