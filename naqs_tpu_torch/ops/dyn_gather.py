"""The rank engine's psi lookup: fused rank index + packed-table gather.

Two entry points over the packed (size+1, 2) f32 value table of
`ops/rank.py::build_value_table` (column 0 log_amp, column 1 phase), for
chunk states s (C,) and flip masks xy (K,), both int64:

* `rank_gather2(spec, s, xy, table)` -> (g_la, g_ph), each (C, K) f32, equal
  to `table[rank_index(spec, s[:, None] ^ xy[None, :])]` split into its two
  columns. It replaces the TPU kernel `naqs_tpu/ops/dyn_gather.py::
  table_gather2` and the `rank_index` before it.
* `rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h)` -> (e_re, e_im),
  each (C,) f32: the off-diagonal part of a chunk's local energy,
  sum_k h[c, k] psi(s ^ xy_k) / psi(s), the gather above fused with the
  ratio and row-sum epilogue of `naqs_tpu/ops/local_energy.py::
  _local_energy_chunk`, so the (C, K) gathers never reach device memory.

On a CUDA tensor each wrapper launches its hand-written kernel in
`csrc/rank_gather.cu` (built by nvcc at first use) or raises; on a CPU tensor
it runs the plain PyTorch version (`rank_gather2_ref`, `rank_ratio_rowsum_ref`).
There is no fallback from one to the other. `<wrapper>.launches` counts
kernel launches.

The fused kernel sums each row in another order than `torch.sum` and uses
CUDA's `expf`/`sincosf`, so it agrees with its plain version per row within
ROWSUM_ATOL + ROWSUM_RTOL * sum_k |h| * |r| (`rowsum_tolerance`), not bitwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import comb

import numpy as np
import torch

from naqs_tpu_torch.ops.rank import _MISS_THRESHOLD, RankSpec, rank_index

ROWSUM_ATOL = 2e-5   # Ha: fp32 summation order over K terms
ROWSUM_RTOL = 1e-6   # of sum_k |h| |r|: expf / sincosf ulps

_INT = ctypes.c_int
_PTR = ctypes.c_void_p
_SPEC_ARGS = [_PTR, _INT, _INT, _INT, ctypes.c_uint, _INT]


def rank_gather2_ref(spec: RankSpec, s, xy, table):
    """Plain PyTorch version: rank_index of every coupled state, then index."""
    g = table[rank_index(spec, s[:, None] ^ xy[None, :])]
    return g[..., 0], g[..., 1]


def ratio_rowsum(g_la, g_ph, my_la, my_ph, h):
    """Row sums of h * psi'/psi from gathered (C, K) log-amps and phases."""
    found = g_la > _MISS_THRESHOLD
    # clip the log-ratio: psi'/psi beyond e^30 only occurs for states with
    # negligible sampling weight, and unclipped it overflows f32
    dlog = torch.clamp(g_la - my_la[:, None], -30.0, 30.0)
    dph = g_ph - my_ph[:, None]
    mag = torch.where(found, torch.exp(dlog), 0.0)
    r_re = mag * torch.cos(dph)
    r_im = mag * torch.sin(dph)
    e_re = torch.sum(h * r_re, dim=-1)
    e_im = torch.sum(h * r_im, dim=-1)
    return e_re, e_im


def rank_ratio_rowsum_ref(spec: RankSpec, s, xy, table, my_la, my_ph, h):
    """Plain PyTorch version: gather the (C, K) pairs, then `ratio_rowsum`."""
    return ratio_rowsum(*rank_gather2_ref(spec, s, xy, table), my_la, my_ph, h)


def rowsum_tolerance(g_la, my_la, h):
    """Per-row bound on |fused kernel - plain version|, from gathered log-amps."""
    mag = torch.where(g_la > _MISS_THRESHOLD,
                      torch.exp(torch.clamp(g_la - my_la[:, None], -30.0, 30.0)), 0.0)
    return ROWSUM_ATOL + ROWSUM_RTOL * torch.sum(h.abs() * mag, dim=-1)


def spec_table(spec: RankSpec):
    """(int32 array, lo_bits, qmask): the kernels' rank tables.

    Layout (csrc/rank_gather.cu): (S+1, 4) records (offset, stride,
    expected_nb, 0) per n_alpha; lo[w], the colex rank of a word w of the
    low L = ceil(S/2) bits; hi[w_h, p], the colex rank of the high S-L bits
    w_h when p bits are set below them. colex(w) = lo[w & (2^L-1)] +
    hi[w >> L, popcount(w & (2^L-1))]. qmask keeps the low 2S bits.
    """
    n = spec.n_shells
    lo_bits = (n + 1) // 2

    def colex(w, below):  # sum over set bits p (the i-th, 1-based) of C(p, i)
        out, i = 0, below
        for p in range(n):
            if w >> p & 1:
                i += 1
                out += comb(p, i)
        return out

    sect = np.zeros((n + 1, 4), np.int64)
    sect[:, 0], sect[:, 1], sect[:, 2] = spec.offset, spec.stride, spec.expected_nb
    lo = [colex(w, 0) for w in range(1 << lo_bits)]
    hi = [colex(w << lo_bits, p) for w in range(1 << (n - lo_bits))
          for p in range(lo_bits + 1)]
    flat = np.concatenate([sect.ravel(), lo, hi]).astype(np.int32)
    return flat, lo_bits, (1 << 2 * n) - 1


@lru_cache(maxsize=16)
def _spec_device(spec: RankSpec, device: torch.device):
    flat, lo_bits, qmask = spec_table(spec)
    t = torch.as_tensor(flat, device=device)
    return (t.data_ptr(), flat.size, spec.n_shells, lo_bits, qmask, spec.size), t


@lru_cache(maxsize=1)
def _lib():
    from naqs_tpu_torch.ops import _build

    lib = _build.load("rank_gather")
    lib.rank_gather2.argtypes = [_PTR, _INT, _PTR, _INT, *_SPEC_ARGS,
                                 _PTR, _PTR, _PTR, _PTR]
    lib.rank_ratio_rowsum.argtypes = [_PTR, _INT, _PTR, _INT, *_SPEC_ARGS,
                                      _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
    lib.rank_gather2.restype = lib.rank_ratio_rowsum.restype = _INT
    return lib


def _launch(name, spec: RankSpec, s, xy, tensors):
    """Launch kernel `name` of csrc/rank_gather.cu on s's current stream.
    `tensors` are the pointer arguments after the spec, in the C signature's
    order. Checks nothing and counts nothing: the public wrappers do both."""
    lib = _lib()
    spec_args, _ = _spec_device(spec, s.device)
    with torch.cuda.device(s.device):
        rc = getattr(lib, name)(
            s.data_ptr(), s.shape[0], xy.data_ptr(), xy.shape[0], *spec_args,
            *(t.data_ptr() for t in tensors),
            torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def _check(name, spec, s, xy, table, **more):
    """Raise on anything the kernels do not take: device, dtype, shape and,
    on the card, layout (a table row is loaded as one float2). The plain
    versions take strided CPU tensors."""
    if s.dim() != 1 or xy.dim() != 1:
        raise ValueError(f"{name}: s and xy must be 1-D")
    dev, n_rows, n_cols = s.device, s.shape[0], xy.shape[0]
    dense = lambda t: t.is_contiguous() or dev.type == "cpu"
    want = {"s": (s, torch.int64, (n_rows,)), "xy": (xy, torch.int64, (n_cols,)),
            "table": (table, torch.float32, (spec.size + 1, 2))}
    shapes = {"my_la": (n_rows,), "my_ph": (n_rows,), "h": (n_rows, n_cols)}
    want.update({k: (t, torch.float32, shapes[k]) for k, t in more.items()})
    for key, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, s on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not dense(t):
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    if dev.type == "cuda" and table.data_ptr() % 8:
        raise ValueError(f"{name}: table rows must be 8-byte aligned (one float2)")
    if spec.n_shells > 16:
        raise ValueError(f"{name}: at most 32 qubits")
    if n_rows * n_cols >= 1 << 31:
        raise ValueError(f"{name}: C * K = {n_rows * n_cols} must be below 2^31")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def rank_gather2(spec: RankSpec, s: torch.Tensor, xy: torch.Tensor,
                 table: torch.Tensor):
    """(g_la, g_ph), each (C, K) f32, for states s (C,) and flip masks xy (K,)."""
    _check("rank_gather2", spec, s, xy, table)
    if s.device.type == "cpu":
        return rank_gather2_ref(spec, s, xy, table)
    out_la = torch.empty((s.shape[0], xy.shape[0]), dtype=torch.float32,
                         device=s.device)
    out_ph = torch.empty_like(out_la)
    if out_la.numel() == 0:
        return out_la, out_ph
    _launch("rank_gather2", spec, s, xy, (table, out_la, out_ph))
    rank_gather2.launches += 1
    return out_la, out_ph


def rank_ratio_rowsum(spec: RankSpec, s: torch.Tensor, xy: torch.Tensor,
                      table: torch.Tensor, my_la: torch.Tensor, my_ph: torch.Tensor,
                      h: torch.Tensor):
    """(e_re, e_im), each (C,) f32: sum_k h[c, k] * psi(s[c] ^ xy[k]) / psi(s[c])
    with psi = exp(la + i ph) read from the table (0 where it holds a miss)."""
    _check("rank_ratio_rowsum", spec, s, xy, table, my_la=my_la, my_ph=my_ph, h=h)
    if s.device.type == "cpu":
        return rank_ratio_rowsum_ref(spec, s, xy, table, my_la, my_ph, h)
    e_re = torch.empty((s.shape[0],), dtype=torch.float32, device=s.device)
    e_im = torch.empty_like(e_re)
    if e_re.numel() == 0:
        return e_re, e_im
    _launch("rank_ratio_rowsum", spec, s, xy, (table, my_la, my_ph, h, e_re, e_im))
    rank_ratio_rowsum.launches += 1
    return e_re, e_im


rank_gather2.launches = 0
rank_ratio_rowsum.launches = 0
