"""The sort engine's psi lookup: a search in the sorted sample buffer.

Where no RankSpec exists (over 32 qubits, or a sector of more than 2^26
states) there is no dense value table, and psi(s') is looked up in the sorted,
SENTINEL-padded sample buffer itself, as `naqs_tpu/ops/local_energy.py`'s
`pack_table` and `_lookup` do with a sort-based searchsorted. The table is
the buffer (U,) int64 with its log-amps and phases (U,) f32 beside it
(`pack_table`); a coupled state q is found when the last of the first n_valid
states that is <= q equals q. For chunk states s (C,) and flip masks xy (K,):

* `sorted_ratio_rowsum(states, la, ph, n_valid, s, xy, my_la, my_ph, h)` ->
  (e_re, e_im), each (C,) f32: sum_k h[c, k] psi(s ^ xy_k) / psi(s), the
  lookup fused with the ratio and row-sum epilogue of `_local_energy_chunk`,
  so no (C, K) array reaches device memory (the sort engine's E_loc chunk);
* `sorted_gather2(states, la, ph, n_valid, s, xy, live)` -> (g_la, g_ph), each
  (C, K) f32: la and ph of every coupled state found from a live row, else
  (-200, 0), `_quadratic_energy_chunk`'s lookup (quadratic_energy).

`n_valid` is a 0-d int64 tensor on the states' device: the kernels read it
there, so the chunk loop never waits for the host. On a CUDA tensor each
wrapper launches its hand-written kernel in `csrc/sort_lookup.cu` (built by
nvcc at first use) or raises; on a CPU tensor it runs the plain PyTorch
version (`torch.searchsorted`, then gathers: `lookup`). There is no fallback
from one to the other. `<wrapper>.launches` counts kernel launches.

`sorted_gather2` equals its plain version bitwise. `sorted_ratio_rowsum` sums
each row in another order than `torch.sum` and uses CUDA's `expf`/`sincosf`,
so it agrees with its plain version per row within `rowsum_tolerance`
(ROWSUM_ATOL + ROWSUM_RTOL * sum_k |h| |r|, as `rank_ratio_rowsum`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.ops.dyn_gather import ratio_rowsum
from naqs_tpu_torch.ops.rank import _MISS

QUAD_MISS = -200.0   # quadratic_energy's log-amp of a miss: exp(-200 + la) is 0 in f32

_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def pack_table(states, log_amp, phase):
    """(states, la, ph): the lookup's table, the sorted buffer (U,) int64 with
    its log-amps and phases (U,) as contiguous f32."""
    return (states.contiguous(), log_amp.to(torch.float32).contiguous(),
            phase.to(torch.float32).contiguous())


def lookup(states, la, ph, n_valid, queries):
    """Plain lookup, JAX's `_lookup`: (found, g_la, g_ph), each the shape of
    `queries`, by `torch.searchsorted` in the whole buffer; found needs the
    position below n_valid and the state there equal to the query."""
    n = states.shape[0]
    pos = torch.searchsorted(states, queries.reshape(-1)).reshape(queries.shape)
    found = pos < n_valid
    pos = torch.clamp(pos, max=n - 1)
    found &= states[pos] == queries
    return found, la[pos], ph[pos]


def sorted_ratio_rowsum_ref(states, la, ph, n_valid, s, xy, my_la, my_ph, h):
    """Plain PyTorch version: `lookup` of the (C, K) coupled states, a miss
    marked as the rank table marks it, then `ratio_rowsum`."""
    found, g_la, g_ph = lookup(states, la, ph, n_valid, s[:, None] ^ xy[None, :])
    return ratio_rowsum(torch.where(found, g_la, _MISS), g_ph, my_la, my_ph, h)


def sorted_gather2_ref(states, la, ph, n_valid, s, xy, live):
    """Plain PyTorch version: `lookup`, then (la, ph) where found from a live
    row and (QUAD_MISS, 0) elsewhere."""
    found, g_la, g_ph = lookup(states, la, ph, n_valid, s[:, None] ^ xy[None, :])
    found &= live[:, None]
    return torch.where(found, g_la, QUAD_MISS), torch.where(found, g_ph, 0.0)


def sorted_log_amps(states, la, n_valid, s, xy):
    """(C, K) log-amps of the coupled states, -1e30 for a miss: what
    `rowsum_tolerance` reads."""
    found, g_la, _ = lookup(states, la, la, n_valid, s[:, None] ^ xy[None, :])
    return torch.where(found, g_la, _MISS)


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("sort_lookup")
    lib.sorted_ratio_rowsum.argtypes = [_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _PTR,
                                        _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
    lib.sorted_gather2.argtypes = [_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _INT,
                                   _PTR, _PTR, _PTR, _PTR]
    lib.sorted_ratio_rowsum.restype = lib.sorted_gather2.restype = _INT
    return lib


def _check(name, states, la, ph, n_valid, s, xy, **more):
    u, n_rows, n_cols = states.shape[0], s.shape[0], xy.shape[0]
    shapes = {"my_la": (n_rows,), "my_ph": (n_rows,), "h": (n_rows, n_cols),
              "live": (n_rows,)}
    i64, f32 = (torch.int64,), (torch.float32,)
    want = {"states": (states, i64, (u,)), "la": (la, f32, (u,)), "ph": (ph, f32, (u,)),
            "n_valid": (n_valid, i64, ()), "s": (s, i64, (n_rows,)),
            "xy": (xy, i64, (n_cols,))}
    want.update({k: (t, (torch.bool,) if k == "live" else f32, shapes[k])
                 for k, t in more.items()})
    _build.check_tensors(name, s, want)
    if n_rows * n_cols >= 1 << 31:
        raise ValueError(f"{name}: C * K = {n_rows * n_cols} must be below 2^31")


def sorted_ratio_rowsum(states, la, ph, n_valid, s, xy, my_la, my_ph, h):
    """(e_re, e_im), each (C,) f32: sum_k h[c, k] * psi(s[c] ^ xy[k]) / psi(s[c])
    with psi = exp(la + i ph) read from the sorted table (0 where not found)."""
    _check("sorted_ratio_rowsum", states, la, ph, n_valid, s, xy, my_la=my_la, my_ph=my_ph,
           h=h)
    if s.device.type == "cpu":
        return sorted_ratio_rowsum_ref(states, la, ph, n_valid, s, xy, my_la, my_ph, h)
    e_re = torch.empty((s.shape[0],), dtype=torch.float32, device=s.device)
    e_im = torch.empty_like(e_re)
    if e_re.numel() == 0:
        return e_re, e_im
    _build.launch(_lib(), "sorted_ratio_rowsum",
                  (states, states.shape[0], la, ph, n_valid, s, s.shape[0], xy, xy.shape[0],
                   my_la, my_ph, h, e_re, e_im), s.device)
    sorted_ratio_rowsum.launches += 1
    return e_re, e_im


def sorted_gather2(states, la, ph, n_valid, s, xy, live):
    """(g_la, g_ph), each (C, K) f32: la and ph of s[c] ^ xy[k] where it is
    found and row c is live, (QUAD_MISS, 0) elsewhere."""
    _check("sorted_gather2", states, la, ph, n_valid, s, xy, live=live)
    if s.device.type == "cpu":
        return sorted_gather2_ref(states, la, ph, n_valid, s, xy, live)
    out_la = torch.empty((s.shape[0], xy.shape[0]), dtype=torch.float32, device=s.device)
    out_ph = torch.empty_like(out_la)
    if out_la.numel() == 0:
        return out_la, out_ph
    _build.launch(_lib(), "sorted_gather2",
                  (states, states.shape[0], la, ph, n_valid, s, s.shape[0], xy, xy.shape[0],
                   live, out_la, out_ph), s.device)
    sorted_gather2.launches += 1
    return out_la, out_ph


sorted_ratio_rowsum.launches = 0
sorted_gather2.launches = 0
