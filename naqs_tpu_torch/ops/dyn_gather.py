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

Both ran in the rank engine's chunk loop with a dense A; no path runs them
now (the one-launch kernels below take those calls), and they stay beside
their plain versions.

On a CUDA tensor each wrapper launches its hand-written kernel in
`csrc/rank_gather.cu` (built by nvcc at first use) or raises; on a CPU tensor
it runs the plain PyTorch version (`rank_gather2_ref`, `rank_ratio_rowsum_ref`).
There is no fallback from one to the other. `<wrapper>.launches` counts
kernel launches.

The fused kernel sums each row in another order than `torch.sum` and uses
CUDA's `expf`/`sincosf`, so it agrees with its plain version per row within
ROWSUM_ATOL + ROWSUM_RTOL * sum_k |h| * |r| (`rowsum_tolerance`), not bitwise.

A whole call of the rank engine, with a dense A or without, is one launch
over query rows (`csrc/row_energy.cuh`'s body with the rank lookup; its
search-lookup instantiations are in `ops/sort_lookup.py`), H summed term by
term only for the pairs whose coupled state is found:

* `rank_local_energy(spec, table, states, n_valid, q_states, q_la, q_ph,
  xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff)` ->
  (e_re, e_im), each (U_q,) f64: the E_loc of every query row, what
  `local_energy` computes on the rank engine, with `table` built from the
  first n_valid of `states` (`build_value_table(spec, states, ..., n_valid)`).
  A SENTINEL row gets its diagonal and an
  imaginary part of 0, as the sort engine's rows do; JAX's rank engine
  computes such a padding row from the low bits of SENTINEL, which is
  garbage, and every caller masks it.
* `rank_quadratic_energy(spec, table, n_valid, states, la, ph, xy_unique,
  ...)` -> (num, w), each (U,) f64: row m's terms of `quadratic_energy`'s
  sum num / sum w, table built with `miss_log_amp=QUAD_MISS` from the
  shifted log-amps la.

The kernels keep a filter of the table's live keys (`states`, n_valid; the
plain version is `ops/live_filter.py`) and rank and read the table only for
a coupled state it passes; it passes every state the table holds, so the
table alone decides what is found, and the plain versions read the table
alone (they take `states` and n_valid and do not read them).

Their plain versions (`local_energy_rows_ref`, `quadratic_rows_ref`, each
with a lookup's gather) run per chunk of rows: the diagonal's parity fold in
f64, `offdiag_h_terms_ref` and the epilogue. The kernels compute h with
`offdiag_h_terms`' adds and sum each row as `rank_ratio_rowsum` does, so they
agree per row within `local_energy_rows_tolerance` /
`quadratic_rows_tolerance`: the row sum's bound, plus sum_k |r_k| times
`offdiag_tolerance`_k for the H entries (left out with `h_exact=True`, against
a composition whose h has the kernel's bits), plus DIAG_RTOL * sum_d
|diag_coeff_d| (times w for the quadratic form) for the f64 diagonal's add
order (each order of Kd adds errs by at most (Kd - 1) 2^-53 sum_d
|diag_coeff_d|: 1.7e-13 of it for both at Kd = 768), plus W_RTOL * w for the
f64 `exp` of w.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms_ref, offdiag_tolerance
from naqs_tpu_torch.ops.rank import _MISS_THRESHOLD, RankSpec, _spec_device, rank_index_ref
from naqs_tpu_torch.utils.bits import SENTINEL, parity_pm1

ROWSUM_ATOL = 2e-5   # Ha: fp32 summation order over K terms
ROWSUM_RTOL = 1e-6   # of sum_k |h| |r|: expf / sincosf ulps
QUAD_MISS = -200.0   # quadratic_energy's log-amp of a miss: exp(-200 + la) is 0 in f32
DIAG_RTOL = 1e-12    # of sum_d |diag_coeff_d|: the f64 diagonal's add order
W_RTOL = 1e-15       # of w = exp(2 la): CUDA's and torch's f64 exp, 1 ulp each

_INT = ctypes.c_int
_PTR = ctypes.c_void_p
_SPEC_ARGS = [_PTR, _INT, _INT, _INT, ctypes.c_uint, _INT]


def rank_gather2_ref(spec: RankSpec, s, xy, table):
    """Plain PyTorch version: the rank index of every coupled state, then index."""
    g = table[rank_index_ref(spec, s[:, None] ^ xy[None, :])]
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


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("rank_gather")
    lib.rank_gather2.argtypes = [_PTR, _INT, _PTR, _INT, *_SPEC_ARGS,
                                 _PTR, _PTR, _PTR, _PTR]
    lib.rank_ratio_rowsum.argtypes = [_PTR, _INT, _PTR, _INT, *_SPEC_ARGS,
                                      _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
    terms = [_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR]
    lib.rank_local_energy.argtypes = [*_SPEC_ARGS, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _PTR,
                                      _PTR, *terms]
    lib.rank_quadratic_energy.argtypes = [*_SPEC_ARGS, _PTR, ctypes.c_float, _PTR, _PTR, _INT,
                                          _PTR, _PTR, *terms]
    for name in ("rank_gather2", "rank_ratio_rowsum", "rank_local_energy",
                 "rank_quadratic_energy"):
        getattr(lib, name).restype = _INT
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


# ------------------------------------------------------ one launch over query rows

def _row_chunks(n_rows, chunk_rows):
    c = max(chunk_rows or n_rows, 1)
    return [slice(i, i + c) for i in range(0, n_rows, c)] or [slice(0, 0)]


def _diag(s, diag_yz, diag_coeff):
    """The f64 diagonal of states s (C,): the parity fold of `diagonal_energy`."""
    return torch.sum(parity_pm1(s[:, None] & diag_yz).to(torch.float64) * diag_coeff, dim=-1)


def local_energy_rows_ref(gather, q_states, q_la, q_ph, xy_unique, xy_ptr, term_yz, yz_unique,
                          term_coeff, diag_yz, diag_coeff, chunk_rows=None):
    """Plain version of the one-launch E_loc, per chunk of `chunk_rows` query
    rows (all at once if None): the diagonal in f64, `offdiag_h_terms_ref` and
    `ratio_rowsum` on `gather(s)` = (g_la, g_ph) (C, K), a miss at log-amp
    -1e30 (rank_gather2_ref's table, or the sort lookup's). A SENTINEL row
    gets its diagonal and 0."""
    e_re, e_im = [], []
    for rows in _row_chunks(q_states.shape[0], chunk_rows):
        s = q_states[rows]
        h = offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff)
        r, i = ratio_rowsum(*gather(s), q_la[rows], q_ph[rows], h)
        pad = s == SENTINEL
        e_re.append(_diag(s, diag_yz, diag_coeff) + torch.where(pad, 0.0, r).to(torch.float64))
        e_im.append(torch.where(pad, 0.0, i).to(torch.float64))
    return torch.cat(e_re), torch.cat(e_im)


def local_energy_rows_tolerance(gather_la, q_states, q_la, xy_ptr, term_yz, yz_unique,
                                term_coeff, diag_coeff, chunk_rows=None, h_exact=False):
    """(U_q,) f64 bound on |one-launch E_loc - local_energy_rows_ref| per row,
    gather_la(s) the (C, K) log-amps (-1e30 for a miss); h_exact: against a
    composition whose h has the kernel's bits."""
    h_tol = offdiag_tolerance(xy_ptr, term_coeff)
    diag = DIAG_RTOL * float(diag_coeff.abs().sum())
    out = []
    for rows in _row_chunks(q_states.shape[0], chunk_rows):
        s, my_la = q_states[rows], q_la[rows]
        g_la = gather_la(s)
        h = offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff)
        tol = rowsum_tolerance(g_la, my_la, h).to(torch.float64) + diag
        if not h_exact:
            mag = torch.where(g_la > _MISS_THRESHOLD,
                              torch.exp(torch.clamp(g_la - my_la[:, None], -30.0, 30.0)), 0.0)
            tol += torch.sum(mag.to(torch.float64) * h_tol, dim=-1)
        out.append(tol)
    return torch.cat(out)


def quadratic_rows_ref(gather, states, la, ph, n_valid, xy_unique, xy_ptr, term_yz, yz_unique,
                       term_coeff, diag_yz, diag_coeff, chunk_rows=None):
    """Plain version of the one-launch quadratic form, per chunk of rows:
    (num, w), each (U,) f64, w_m = exp(2 la_m) and num_m = w_m diag_m +
    sum_k h_mk exp(la_k + la_m) cos(ph_k - ph_m) (fp32 row sum) for the rows
    below n_valid, (0, 0) beyond; gather(s, live) = (g_la, g_ph) (C, K) with
    QUAD_MISS for a miss. The steps of JAX's _quadratic_energy_chunk."""
    num, wts = [], []
    for rows in _row_chunks(states.shape[0], chunk_rows):
        s, my_la, my_ph = states[rows], la[rows], ph[rows]
        live = torch.arange(rows.start, rows.start + s.shape[0], device=s.device) < n_valid
        w = torch.where(live, torch.exp(2.0 * my_la.to(torch.float64)), 0.0)
        g_la, g_ph = gather(s, live)
        amp = torch.where(live[:, None], torch.exp(g_la + my_la[:, None]), 0.0)
        h = offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff)
        off = torch.sum(h * (amp * torch.cos(g_ph - my_ph[:, None])), dim=-1)
        num.append(torch.where(live, w * _diag(s, diag_yz, diag_coeff) + off.to(torch.float64),
                               0.0))
        wts.append(w)
    return torch.cat(num), torch.cat(wts)


def quadratic_rows_tolerance(gather, states, la, n_valid, xy_ptr, term_yz, yz_unique,
                             term_coeff, diag_coeff, chunk_rows=None, h_exact=False):
    """((U,) bound on num, (U,) bound on w), f64: |one-launch quadratic form -
    quadratic_rows_ref| per row; h_exact as in `local_energy_rows_tolerance`."""
    h_tol = offdiag_tolerance(xy_ptr, term_coeff)
    diag = DIAG_RTOL * float(diag_coeff.abs().sum())
    t_num, t_w = [], []
    for rows in _row_chunks(states.shape[0], chunk_rows):
        s, my_la = states[rows], la[rows]
        live = torch.arange(rows.start, rows.start + s.shape[0], device=s.device) < n_valid
        w = torch.where(live, torch.exp(2.0 * my_la.to(torch.float64)), 0.0)
        g_la = gather(s, live)[0]
        amp = torch.where(live[:, None] & (g_la > QUAD_MISS),
                          torch.exp(g_la + my_la[:, None]), 0.0).to(torch.float64)
        h = offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff).to(torch.float64)
        tol = w * diag + torch.where(live, ROWSUM_ATOL, 0.0) + ROWSUM_RTOL * torch.sum(
            h.abs() * amp, dim=-1)
        if not h_exact:
            tol += torch.sum(amp * h_tol, dim=-1)
        t_num.append(tol)
        t_w.append(W_RTOL * w)
    return torch.cat(t_num), torch.cat(t_w)


def rank_local_energy_ref(spec: RankSpec, table, states, n_valid, q_states, q_la, q_ph,
                          xy_unique, *terms, chunk_rows=None):
    """Plain version of `rank_local_energy`: `local_energy_rows_ref` with the
    rank table's gather (`rank_gather2_ref`); `states` and n_valid, the
    kernel's filter keys, are not read."""
    return local_energy_rows_ref(lambda s: rank_gather2_ref(spec, s, xy_unique, table),
                                 q_states, q_la, q_ph, xy_unique, *terms, chunk_rows=chunk_rows)


def rank_local_energy_tolerance(spec: RankSpec, table, q_states, q_la, xy_unique, xy_ptr,
                                term_yz, yz_unique, term_coeff, diag_coeff, chunk_rows=None,
                                h_exact=False):
    """(U_q,) f64 bound on |rank_local_energy - its plain version| per row."""
    return local_energy_rows_tolerance(
        lambda s: rank_gather2_ref(spec, s, xy_unique, table)[0], q_states, q_la, xy_ptr,
        term_yz, yz_unique, term_coeff, diag_coeff, chunk_rows=chunk_rows, h_exact=h_exact)


def rank_quadratic_energy_ref(spec: RankSpec, table, n_valid, states, la, ph, xy_unique, *terms,
                              chunk_rows=None):
    """Plain version of `rank_quadratic_energy`: `quadratic_rows_ref` with the
    rank table's gather (a miss holds QUAD_MISS)."""
    return quadratic_rows_ref(lambda s, live: rank_gather2_ref(spec, s, xy_unique, table),
                              states, la, ph, n_valid, xy_unique, *terms, chunk_rows=chunk_rows)


def rank_quadratic_energy_tolerance(spec: RankSpec, table, n_valid, states, la, xy_unique,
                                    xy_ptr, term_yz, yz_unique, term_coeff, diag_coeff,
                                    chunk_rows=None, h_exact=False):
    """((U,), (U,)) f64 bounds on |rank_quadratic_energy - its plain version|
    per row, of num and of w."""
    return quadratic_rows_tolerance(
        lambda s, live: rank_gather2_ref(spec, s, xy_unique, table), states, la, n_valid,
        xy_ptr, term_yz, yz_unique, term_coeff, diag_coeff, chunk_rows=chunk_rows,
        h_exact=h_exact)


def _terms_check(want, n_cols, xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz,
                 diag_coeff):
    i64, i32 = (torch.int64,), (torch.int32,)
    want.update({
        "xy_unique": (xy_unique, i64, (n_cols,)), "xy_ptr": (xy_ptr, i32, (n_cols + 1,)),
        "term_yz": (term_yz, i32, (term_yz.shape[0],)),
        "yz_unique": (yz_unique, i64, (yz_unique.shape[0],)),
        "term_coeff": (term_coeff, (torch.float32,), (term_yz.shape[0],)),
        "diag_yz": (diag_yz, i64, (diag_yz.shape[0],)),
        "diag_coeff": (diag_coeff, (torch.float64,), (diag_yz.shape[0],))})
    return want


def _rank_rows_check(name, spec, table, anchor, want):
    _build.check_tensors(name, anchor, want)
    # a table row is loaded as one float2
    _build.check_tensors(name, anchor, {"table": (table, (torch.float32,), (spec.size + 1, 2))},
                         align=8)
    if spec.n_shells > 16:
        raise ValueError(f"{name}: at most 32 qubits")


def rank_local_energy(spec: RankSpec, table, states, n_valid, q_states, q_la, q_ph, xy_unique,
                      xy_ptr, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff,
                      chunk_rows=None):
    """(e_re, e_im), each (U_q,) f64: the local energy of every query row
    q_states (U_q,) with psi(s) = exp(q_la + i q_ph), psi(s') read from the
    rank table (0 where it holds a miss), built from the first n_valid (a 0-d
    int64 tensor on their device) of `states` (U,) int64, the kernel's filter
    keys. `chunk_rows` bounds the plain version's (chunk, K) intermediates on
    a CPU tensor; the kernel has none."""
    n_rows, n_cols = q_states.shape[0], xy_unique.shape[0]
    f32, i64 = (torch.float32,), (torch.int64,)
    want = _terms_check({"states": (states, i64, (states.shape[0],)),
                         "n_valid": (n_valid, i64, ()),
                         "q_states": (q_states, i64, (n_rows,)),
                         "q_la": (q_la, f32, (n_rows,)), "q_ph": (q_ph, f32, (n_rows,))},
                        n_cols, xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz,
                        diag_coeff)
    _rank_rows_check("rank_local_energy", spec, table, q_states, want)
    if q_states.device.type == "cpu":
        return rank_local_energy_ref(spec, table, states, n_valid, q_states, q_la, q_ph,
                                     xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz,
                                     diag_coeff, chunk_rows=chunk_rows)
    e_re = torch.empty((n_rows,), dtype=torch.float64, device=q_states.device)
    e_im = torch.empty_like(e_re)
    if n_rows == 0:
        return e_re, e_im
    spec_args, _ = _spec_device(spec, q_states.device)
    _build.launch(_lib(), "rank_local_energy",
                  (*spec_args, table, states, states.shape[0], n_valid, q_states, n_rows, q_la,
                   q_ph, xy_unique, xy_ptr, n_cols, term_yz, yz_unique, term_coeff, diag_yz,
                   diag_coeff, diag_yz.shape[0], e_re, e_im), q_states.device)
    rank_local_energy.launches += 1
    return e_re, e_im


def rank_quadratic_energy(spec: RankSpec, table, n_valid, states, la, ph, xy_unique, xy_ptr,
                          term_yz, yz_unique, term_coeff, diag_yz, diag_coeff,
                          chunk_rows=None):
    """(num, w), each (U,) f64: row m's terms of quadratic_energy's sum num /
    sum w for the sorted buffer states (U,) with the shifted log-amps la and
    phases ph (U,) f32, n_valid live rows (a 0-d int64 tensor on their device),
    psi(s') read from `table` (built with miss_log_amp=QUAD_MISS)."""
    u, n_cols = states.shape[0], xy_unique.shape[0]
    f32 = (torch.float32,)
    want = _terms_check({"n_valid": (n_valid, (torch.int64,), ()),
                         "states": (states, (torch.int64,), (u,)), "la": (la, f32, (u,)),
                         "ph": (ph, f32, (u,))},
                        n_cols, xy_unique, xy_ptr, term_yz, yz_unique, term_coeff, diag_yz,
                        diag_coeff)
    _rank_rows_check("rank_quadratic_energy", spec, table, states, want)
    if states.device.type == "cpu":
        return rank_quadratic_energy_ref(spec, table, n_valid, states, la, ph, xy_unique,
                                         xy_ptr, term_yz, yz_unique, term_coeff, diag_yz,
                                         diag_coeff, chunk_rows=chunk_rows)
    num = torch.empty((u,), dtype=torch.float64, device=states.device)
    w = torch.empty_like(num)
    if u == 0:
        return num, w
    spec_args, _ = _spec_device(spec, states.device)
    _build.launch(_lib(), "rank_quadratic_energy",
                  (*spec_args, table, QUAD_MISS, n_valid, states, u, la, ph, xy_unique,
                   xy_ptr, n_cols, term_yz, yz_unique, term_coeff, diag_yz, diag_coeff,
                   diag_yz.shape[0], num, w), states.device)
    rank_quadratic_energy.launches += 1
    return num, w


rank_gather2.launches = 0
rank_ratio_rowsum.launches = 0
rank_local_energy.launches = 0
rank_quadratic_energy.launches = 0
