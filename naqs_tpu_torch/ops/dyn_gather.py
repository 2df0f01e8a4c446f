"""The rank engine's psi lookup: fused rank index + two-channel table gather.

`rank_gather2(spec, s, xy, la_tab, ph_tab)` returns (g_la, g_ph), each
(C, K) f32, equal to `la_tab[rank_index(spec, s[:, None] ^ xy[None, :])]`
and the same for `ph_tab`. It replaces the TPU kernel
`naqs_tpu/ops/dyn_gather.py::table_gather2` and the `rank_index` before it.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/rank_gather.cu` (built by nvcc at first use) or raises; on a CPU
tensor it runs `rank_gather2_ref`, the plain PyTorch version. There is no
fallback from one to the other. `rank_gather2.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from naqs_tpu_torch.ops.rank import RankSpec, rank_index, spec_arrays

_C_INT64 = ctypes.c_int64
_PTR = ctypes.c_void_p


def rank_gather2_ref(spec: RankSpec, s, xy, la_tab, ph_tab):
    """Plain PyTorch version: rank_index of every coupled state, then index."""
    idx = rank_index(spec, s[:, None] ^ xy[None, :])
    return la_tab[idx], ph_tab[idx]


@lru_cache(maxsize=1)
def _lib():
    from naqs_tpu_torch.ops import _build

    lib = _build.load("rank_gather")
    fn = lib.rank_gather2
    fn.argtypes = [_PTR, _C_INT64, _PTR, _C_INT64, _PTR, ctypes.c_int,
                   ctypes.c_int, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, _PTR]
    fn.restype = ctypes.c_int
    lib.rank_gather2_error_string.argtypes = [ctypes.c_int]
    lib.rank_gather2_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=16)
def _spec_device(spec: RankSpec, device: torch.device) -> torch.Tensor:
    """The packed int32 spec table the kernel stages in shared memory."""
    flat = [torch.as_tensor(a).reshape(-1) for a in spec_arrays(spec)]
    return torch.cat(flat).to(device=device, dtype=torch.int32).contiguous()


def _check(spec, s, xy, la_tab, ph_tab):
    dev = s.device
    for name, t, dtype, ndim in (("s", s, torch.int64, 1),
                                 ("xy", xy, torch.int64, 1),
                                 ("la_tab", la_tab, torch.float32, 1),
                                 ("ph_tab", ph_tab, torch.float32, 1)):
        if t.device != dev:
            raise ValueError(f"rank_gather2: {name} on {t.device}, s on {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"rank_gather2: {name} must be a contiguous {ndim}-D {dtype}, "
                f"got {t.dtype} of shape {tuple(t.shape)}")
    if la_tab.shape[0] != spec.size + 1 or ph_tab.shape[0] != spec.size + 1:
        raise ValueError(
            f"rank_gather2: tables must hold spec.size + 1 = {spec.size + 1} "
            f"rows, got {la_tab.shape[0]} and {ph_tab.shape[0]}")
    if spec.n_shells > 16:
        raise ValueError("rank_gather2: at most 32 qubits")


def rank_gather2(spec: RankSpec, s: torch.Tensor, xy: torch.Tensor,
                 la_tab: torch.Tensor, ph_tab: torch.Tensor):
    """(g_la, g_ph), each (C, K) f32, for states s (C,) and flip masks xy (K,)."""
    if s.device.type == "cpu":
        return rank_gather2_ref(spec, s, xy, la_tab, ph_tab)
    if s.device.type != "cuda":
        raise ValueError(f"rank_gather2: unsupported device {s.device}")
    _check(spec, s, xy, la_tab, ph_tab)
    n_rows, n_cols = s.shape[0], xy.shape[0]
    out_la = torch.empty((n_rows, n_cols), dtype=torch.float32, device=s.device)
    out_ph = torch.empty_like(out_la)
    total = n_rows * n_cols
    if total == 0:
        return out_la, out_ph
    lib = _lib()
    spec_t = _spec_device(spec, s.device)
    n_blocks = min(-(-total // 256), 132 * 64)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = lib.rank_gather2(
            s.data_ptr(), n_rows, xy.data_ptr(), n_cols, spec_t.data_ptr(),
            spec.n_shells, spec.size, la_tab.data_ptr(), ph_tab.data_ptr(),
            out_la.data_ptr(), out_ph.data_ptr(), n_blocks, stream)
    if rc != 0:
        msg = lib.rank_gather2_error_string(rc).decode()
        raise RuntimeError(f"rank_gather2 launch failed: {msg} ({rc})")
    rank_gather2.launches += 1
    return out_la, out_ph


rank_gather2.launches = 0
