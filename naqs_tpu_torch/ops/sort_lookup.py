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

* `sorted_local_energy(states, la, ph, n_valid, q_states, q_la, q_ph,
  xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff)` ->
  (e_re, e_im), each (U_q,) f64: the whole E_loc of the query rows in one
  launch, the diagonal in f64 plus sum_k h[c, k] psi(s ^ xy_k) / psi(s) with
  h summed per flip mask from the grouped terms (`ops/offdiag_h.py`) only
  where the coupled state is found: what `local_energy` computes on the sort
  engine, with a dense A or without. SENTINEL query rows get their diagonal and an
  off-diagonal part of 0, as every other computation of them does (flip
  masks and live states below 2^62: at most 62 qubits).
* `sorted_quadratic_energy(states, la, ph, n_valid, xy_unique, ...)` ->
  (num, w), each (U,) f64: the whole `quadratic_energy` call, with a dense
  A or without, in one launch, row m's w_m = exp(2 la_m) and num_m = w_m diag_m + sum_k h_mk
  exp(la_k + la_m) cos(ph_k - ph_m) over found k (fp32 row sum) below
  n_valid, (0, 0) beyond; the caller returns sum num / sum w.

Both are `csrc/row_energy.cuh`'s one kernel body with this module's search
as its lookup (`rank_local_energy` and `rank_quadratic_energy` in
`ops/dyn_gather.py` are the same body with the rank lookup); their plain
versions are `dyn_gather.local_energy_rows_ref` and `quadratic_rows_ref` with
the sort lookup. The kernels search only the coupled states that pass a
filter of the n_valid live keys (`ops/live_filter.py`), which passes every
live key: the plain versions search every pair and find the same states.

`sorted_gather2` equals its plain version bitwise. `sorted_ratio_rowsum` sums
each row in another order than `torch.sum` and uses CUDA's `expf`/`sincosf`,
so it agrees with its plain version per row within `rowsum_tolerance`
(ROWSUM_ATOL + ROWSUM_RTOL * sum_k |h| |r|, as `rank_ratio_rowsum`).
`sorted_local_energy` computes h with `offdiag_h_terms`' adds and sums the
row as `sorted_ratio_rowsum` does, so against the plain version
(`sorted_local_energy_ref`, whose h comes from `index_add_`) it agrees per row
within `sorted_local_energy_tolerance`: that bound, plus sum_k |r_k| times
`offdiag_tolerance`_k for the H entries, plus DIAG_RTOL * sum_d
|diag_coeff_d| for the f64 diagonal (its 768 adds in another order than
`torch.sum`'s: each order errs by at most (Kd - 1) 2^-53 sum_d |diag_coeff_d|,
1.7e-13 of it for both at Kd = 768). Against `offdiag_h_terms` +
`sorted_ratio_rowsum` composed (`h_exact=True`) the h bits are the same, and
only the first and last terms remain. `sorted_quadratic_energy` is held to
`sorted_quadratic_energy_tolerance` (`dyn_gather.quadratic_rows_tolerance`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.ops.dyn_gather import (DIAG_RTOL, QUAD_MISS, _terms_check,  # noqa: F401
                                           local_energy_rows_ref, local_energy_rows_tolerance,
                                           quadratic_rows_ref, quadratic_rows_tolerance,
                                           ratio_rowsum)
from naqs_tpu_torch.ops.rank import _MISS

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


def _sorted_gather(states, la, ph, n_valid, xy):
    """The sort lookup as `local_energy_rows_ref` reads it: s -> (g_la, g_ph),
    a miss marked as the rank table marks it."""
    def gather(s):
        found, g_la, g_ph = lookup(states, la, ph, n_valid, s[:, None] ^ xy[None, :])
        return torch.where(found, g_la, _MISS), g_ph
    return gather


def sorted_local_energy_ref(states, la, ph, n_valid, q_states, q_la, q_ph, xy_unique, *terms,
                            chunk_rows=None):
    """Plain PyTorch version, per chunk of `chunk_rows` query rows (all at
    once if None): `local_energy_rows_ref` with the sort lookup, the
    diagonal's parity fold in f64, `offdiag_h_terms_ref` and
    `sorted_ratio_rowsum_ref`'s steps."""
    return local_energy_rows_ref(_sorted_gather(states, la, ph, n_valid, xy_unique), q_states,
                                 q_la, q_ph, xy_unique, *terms, chunk_rows=chunk_rows)


def sorted_local_energy_tolerance(states, la, n_valid, q_states, q_la, xy_unique, xy_ptr,
                                  term_yz, yz_unique, term_coeff, diag_coeff,
                                  chunk_rows=None, h_exact=False):
    """(U_q,) f64 bound on |sorted_local_energy - its plain version| per row;
    h_exact: against a composition whose h has the kernel's bits."""
    return local_energy_rows_tolerance(
        lambda s: sorted_log_amps(states, la, n_valid, s, xy_unique), q_states, q_la, xy_ptr,
        term_yz, yz_unique, term_coeff, diag_coeff, chunk_rows=chunk_rows, h_exact=h_exact)


def sorted_quadratic_energy_ref(states, la, ph, n_valid, xy_unique, *terms, chunk_rows=None):
    """Plain version of `sorted_quadratic_energy`: `quadratic_rows_ref` with
    `sorted_gather2_ref`'s lookup."""
    return quadratic_rows_ref(
        lambda s, live: sorted_gather2_ref(states, la, ph, n_valid, s, xy_unique, live),
        states, la, ph, n_valid, xy_unique, *terms, chunk_rows=chunk_rows)


def sorted_quadratic_energy_tolerance(states, la, ph, n_valid, xy_unique, xy_ptr, term_yz,
                                      yz_unique, term_coeff, diag_coeff, chunk_rows=None,
                                      h_exact=False):
    """((U,), (U,)) f64 bounds on |sorted_quadratic_energy - its plain
    version| per row, of num and of w."""
    return quadratic_rows_tolerance(
        lambda s, live: sorted_gather2_ref(states, la, ph, n_valid, s, xy_unique, live),
        states, la, n_valid, xy_ptr, term_yz, yz_unique, term_coeff, diag_coeff,
        chunk_rows=chunk_rows, h_exact=h_exact)


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
    lib.sorted_local_energy.argtypes = [_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR,
                                        _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT,
                                        _PTR, _PTR, _PTR]
    lib.sorted_quadratic_energy.argtypes = [_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT,
                                            _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR,
                                            _PTR]
    for name in ("sorted_ratio_rowsum", "sorted_gather2", "sorted_local_energy",
                 "sorted_quadratic_energy"):
        getattr(lib, name).restype = _INT
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


def sorted_local_energy(states, la, ph, n_valid, q_states, q_la, q_ph, xy_unique, xy_ptr,
                        term_yz, yz_unique, term_coeff, diag_yz, diag_coeff, chunk_rows=None):
    """(e_re, e_im), each (U_q,) f64: the local energy of every query row
    q_states (U_q,) with psi(s) = exp(q_la + i q_ph), psi(s') read from the
    sorted table (0 where not found). `chunk_rows` bounds the plain version's
    (chunk, K) intermediates on a CPU tensor; the kernel has none."""
    u, n_rows, n_cols = states.shape[0], q_states.shape[0], xy_unique.shape[0]
    i64, f32 = (torch.int64,), (torch.float32,)
    _build.check_tensors("sorted_local_energy", q_states, _terms_check({
        "states": (states, i64, (u,)), "la": (la, f32, (u,)), "ph": (ph, f32, (u,)),
        "n_valid": (n_valid, i64, ()), "q_states": (q_states, i64, (n_rows,)),
        "q_la": (q_la, f32, (n_rows,)), "q_ph": (q_ph, f32, (n_rows,))}, n_cols, xy_unique,
        xy_ptr, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff))
    if q_states.device.type == "cpu":
        return sorted_local_energy_ref(states, la, ph, n_valid, q_states, q_la, q_ph,
                                       xy_unique, xy_ptr, term_yz, yz_unique, term_coeff,
                                       diag_yz, diag_coeff, chunk_rows=chunk_rows)
    e_re = torch.empty((n_rows,), dtype=torch.float64, device=q_states.device)
    e_im = torch.empty_like(e_re)
    if n_rows == 0:
        return e_re, e_im
    _build.launch(_lib(), "sorted_local_energy",
                  (states, u, la, ph, n_valid, q_states, n_rows, q_la, q_ph, xy_unique, xy_ptr,
                   n_cols, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff,
                   diag_yz.shape[0], e_re, e_im), q_states.device)
    sorted_local_energy.launches += 1
    return e_re, e_im


def sorted_quadratic_energy(states, la, ph, n_valid, xy_unique, xy_ptr, term_yz, yz_unique,
                            term_coeff, diag_yz, diag_coeff, chunk_rows=None):
    """(num, w), each (U,) f64: row m's terms of quadratic_energy's sum num /
    sum w for the sorted buffer states (U,) with the shifted log-amps la
    (QUAD_MISS beyond n_valid) and phases ph (U,) f32, psi(s') read from the
    same buffer (0 where not found); n_valid a 0-d int64 tensor on their
    device. `chunk_rows` bounds the plain version's intermediates."""
    u, n_cols = states.shape[0], xy_unique.shape[0]
    i64, f32 = (torch.int64,), (torch.float32,)
    _build.check_tensors("sorted_quadratic_energy", states, _terms_check({
        "states": (states, i64, (u,)), "la": (la, f32, (u,)), "ph": (ph, f32, (u,)),
        "n_valid": (n_valid, i64, ())}, n_cols, xy_unique, xy_ptr, term_yz, yz_unique,
        term_coeff, diag_yz, diag_coeff))
    if states.device.type == "cpu":
        return sorted_quadratic_energy_ref(states, la, ph, n_valid, xy_unique, xy_ptr, term_yz,
                                           yz_unique, term_coeff, diag_yz, diag_coeff,
                                           chunk_rows=chunk_rows)
    num = torch.empty((u,), dtype=torch.float64, device=states.device)
    w = torch.empty_like(num)
    if u == 0:
        return num, w
    _build.launch(_lib(), "sorted_quadratic_energy",
                  (states, u, la, ph, n_valid, xy_unique, xy_ptr, n_cols, term_yz, yz_unique,
                   term_coeff, diag_yz, diag_coeff, diag_yz.shape[0], num, w), states.device)
    sorted_quadratic_energy.launches += 1
    return num, w


sorted_ratio_rowsum.launches = 0
sorted_gather2.launches = 0
sorted_local_energy.launches = 0
sorted_quadratic_energy.launches = 0
