"""The grid and rank engines' E_loc glue: the value grid or table scatter and
the readout, around the accumulations of `ops/grid_kernels.py`.

For the rank indices of a buffer's states (`ops/rank.py::rank_index`, whose
kernel lives in the same library) and its (log_amp, phase) of one float type:

* `grid_scatter(mode, cells, log_amp, phase, n_valid, sa, sb, miss)` ->
  (out, ref). Mode "grid" (the dense and factored engines): cells the (U,)
  rank indices of an (Sa, Sb) sector; out the (Sa+1, Sb+1, 2) f32 grid of
  psi / max|psi| (re, im) at [idx // Sb, idx % Sb] for every live row (below
  n_valid, inside the sector), zero elsewhere; ref the live maximum of
  log_amp. Mode "xl" (the staircase engine): cells the (a_hat, b_hat) pair of
  the restricted rectangle (Sa*, Sb*), every row below n_valid live for ref,
  set where both lie inside. Mode "table" (the rank engine): out the (size+1,
  2) f32 table of `build_value_table`, (log_amp, phase) at each live row's
  index, (miss, 0) elsewhere and at the sentinel row size = sa; ref None.
* `grid_readout(mode, num, e_diag, cells, ref, q_la, q_ph, sa, sb, ...)` ->
  (e_re, e_im), each (U_q,) f64, the E_loc of the query rows: ratio =
  exp(clamp(ref - q_la, -30, 30)), the numerator n read at the row's cell
  (mode "dense": the (Sb, Sa, 2) grid at [rb, ra]; "rows": the factored
  engine's (U_q, 2) rows; "xl": the packed (n_cells, 2) staircase at
  cells_off[a_hat] + b_hat where b_hat < width[a_hat]), e_re = diag +
  ratio (n_re cos q_ph + n_im sin q_ph), e_im = ratio (n_im cos - n_re sin).
  The diagonal is e_diag at the cell (the sentinel's 0 outside); in mode
  "xl" with `diag_yz`/`diag_coeff`, a row outside the staircase gets its true
  diagonal sum_k diag_coeff[k] (-1)^popcount(q_state & diag_yz[k]) instead.

They port XLA-lowered glue of `naqs_tpu/ops/dense_engine.py` (the value
grids :250-268, :477-493, :860-875; the readouts :294-310, :526-541,
:940-956) and `naqs_tpu/ops/rank.py::build_value_table`; no TPU kernel. On a
CUDA tensor each wrapper launches its hand-written kernel in
`csrc/grid_glue.cu` (built by nvcc at first use) or raises; on a CPU tensor
it runs the plain PyTorch version (`grid_scatter_ref`, `grid_readout_ref`:
the engines' chains as they were). There is no fallback from one to the
other. `<wrapper>.launches` counts kernel launches: two a scatter (the fill,
which also takes ref's key for a grid, then the scatter), one a readout.

The kernels compute what the chains compute, operation for operation in the
same types with the same libdevice functions (no contraction into fma), so
on the card they give the chains' bits, except the XL true diagonal, whose
f64 sum runs in term order: within DIAG_ATOL of `torch.sum`'s.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.utils.bits import parity_pm1

# Ha: the XL true diagonal's f64 add order against torch.sum's; each order of
# Kd adds errs by at most (Kd - 1) 2^-53 sum_k |diag_coeff_k| (Li2O STO-3G:
# Kd = 466 terms, a few 1e-12 Ha)
DIAG_ATOL = 1e-10

_SCATTER = {"grid": 0, "xl": 1, "table": 2}   # csrc/grid_glue.cu's kGrid, kXl, kTable
_READOUT = {"dense": 0, "rows": 1, "xl": 2}   # kDense, kRows, kStair

_INT = ctypes.c_int
_PTR = ctypes.c_void_p
_F32, _F64, _I32, _I64 = (torch.float32,), (torch.float64,), (torch.int32,), (torch.int64,)


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("grid_glue")
    lib.rank_index.argtypes = [_PTR, _INT, _INT, _INT, ctypes.c_uint, _INT, _PTR, _INT, _PTR,
                               _PTR, _INT, _INT, _PTR, _PTR, _PTR]
    lib.grid_scatter.argtypes = [_INT, _INT, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT,
                                 ctypes.c_float, _PTR, ctypes.c_longlong, _PTR, _PTR, _PTR]
    lib.grid_readout.argtypes = [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                 _INT, _INT, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _INT, _PTR,
                                 _PTR, _PTR]
    for name in ("rank_index", "grid_scatter", "grid_readout"):
        getattr(lib, name).restype = _INT
    return lib


def _count(n, device) -> torch.Tensor:
    """A row count as the 0-d int64 device tensor the kernels read: a tensor
    as it is (moved if it must be), a Python int by a fill on the device,
    which needs no host-to-device copy."""
    if torch.is_tensor(n):
        return n.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(n), dtype=torch.int64, device=device)


def _cell(idx, sa: int, sb: int):
    """(ra, rb) of rank indices; the sentinel Sa*Sb maps to the pad row (Sa, 0)."""
    ra = torch.clamp(idx // sb, max=sa)
    rb = torch.where(idx >= sa * sb, 0, idx % sb)
    return ra, rb


def _unit(w, phase):
    """(U, 2) f32 (w cos phase, w sin phase), the transcendentals in phase's type."""
    return torch.stack([w * torch.cos(phase).to(torch.float32),
                        w * torch.sin(phase).to(torch.float32)], dim=-1)


def grid_scatter_ref(mode: str, cells, log_amp, phase, n_valid, sa: int, sb: int = 0,
                     miss: float = 0.0):
    """Plain PyTorch version of `grid_scatter`: the engines' chains."""
    dev = log_amp.device
    live = torch.arange(log_amp.shape[0], device=dev) < n_valid
    if mode == "table":
        idx = torch.where(live, cells, sa)
        table = torch.zeros((sa + 1, 2), dtype=torch.float32, device=dev)
        table[:, 0] = miss
        table[idx] = torch.stack([log_amp.to(torch.float32), phase.to(torch.float32)], dim=1)
        # one-row slices: a fill on the device (a single element set from a Python
        # number is copied from the host, a sync)
        table[sa:, 0] = miss
        table[sa:, 1] = 0.0
        return table, None
    grid = torch.zeros((sa + 1, sb + 1, 2), dtype=torch.float32, device=dev)
    if mode == "grid":
        # rows at or beyond n_valid, and rows outside the sector, carry the value
        # 0 and land on the pad row, so it stays zero
        live = live & (cells < sa * sb)
        ref = torch.max(torch.where(live, log_amp, -torch.inf))
        w = torch.where(live, torch.exp(log_amp - ref), 0.0).to(torch.float32)
        ra, rb = _cell(cells, sa, sb)
        grid[ra, rb] = _unit(w, phase)
        return grid, ref
    ref = torch.max(torch.where(live, log_amp, -torch.inf))
    w = torch.where(live, torch.exp(log_amp - ref), 0.0).to(torch.float32)
    ah = torch.where(live, cells[0], sa)
    bh = torch.where(live, cells[1], sb)
    grid[ah, bh] = _unit(w, phase)
    grid[sa] = 0.0       # the pad row and column read as psi = 0 (SENTINEL rows land there)
    grid[:, sb] = 0.0
    return grid, ref


def grid_scatter(mode: str, cells, log_amp: torch.Tensor, phase: torch.Tensor, n_valid,
                 sa: int, sb: int = 0, miss: float = 0.0):
    """(out, ref): the value grid of mode "grid" or "xl", or the value table of
    mode "table" (ref None), as the module's docstring says. cells: (U,) int64
    rank indices, or for "xl" the (a_hat, b_hat) pair of (U,) int64; log_amp
    and phase (U,), both float32 or both float64; n_valid an int or a 0-d
    int64 tensor; for "table", sa is the table's size and miss the log-amp of
    its empty rows."""
    if mode not in _SCATTER:
        raise ValueError(f"grid_scatter: mode {mode!r} is not one of {sorted(_SCATTER)}")
    c0, c1 = cells if mode == "xl" else (cells, None)
    u = log_amp.shape[0] if log_amp.dim() == 1 else -1
    want = {"cells": (c0, _I64, (u,)), "log_amp": (log_amp, (torch.float32, torch.float64), (u,)),
            "phase": (phase, (log_amp.dtype,), (u,))}
    if c1 is not None:
        want["b_hat"] = (c1, _I64, (u,))
    _build.check_tensors("grid_scatter", log_amp, want)
    if (mode != "table" and sb < 1) or sa < 0:
        raise ValueError(f"grid_scatter: a grid of ({sa}, {sb}) cells")
    if log_amp.device.type == "cpu":
        return grid_scatter_ref(mode, cells, log_amp, phase, n_valid, sa, sb, miss)
    dev = log_amp.device
    shape = (sa + 1, 2) if mode == "table" else (sa + 1, sb + 1, 2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    key = None if mode == "table" else torch.empty(1, dtype=torch.int64, device=dev)
    ref = None if mode == "table" else torch.empty((), dtype=log_amp.dtype, device=dev)
    _build.launch(_lib(), "grid_scatter",
                  (_SCATTER[mode], int(log_amp.dtype == torch.float64), c0, c1, u,
                   _count(n_valid, dev), log_amp, phase, sa, sb, miss, out, out.numel() // 2,
                   key, ref), dev)
    grid_scatter.launches += 2
    return out, ref


def _rotate(n_s, ref, q_la, q_ph):
    """(e_re, e_im) f64 without the diagonal: psi_max / psi(s) * n[s], the
    log-ratio clipped per row to +-30."""
    ratio = torch.exp(torch.clamp(ref - q_la, -30.0, 30.0)).to(torch.float32)
    c, s_ = torch.cos(q_ph).to(torch.float32), torch.sin(q_ph).to(torch.float32)
    e_re = (ratio * (n_s[:, 0] * c + n_s[:, 1] * s_)).to(torch.float64)
    e_im = (ratio * (n_s[:, 1] * c - n_s[:, 0] * s_)).to(torch.float64)
    return e_re, e_im


def grid_readout_ref(mode: str, num, e_diag, cells, ref, q_la, q_ph, sa: int, sb: int,
                     width=None, cells_off=None, q_states=None, diag_yz=None, diag_coeff=None):
    """Plain PyTorch version of `grid_readout`: the engines' chains."""
    if mode == "xl":
        ahq, bhq = cells
        row = torch.clamp(ahq, max=sa)
        valid = (ahq < sa) & (bhq < width[row])
        n_cells = num.shape[0]
        cell = torch.where(valid, cells_off[row] + bhq, n_cells)
        n_s = torch.cat([num, num.new_zeros((1, 2))])[cell]
        e_re, e_im = _rotate(n_s, ref, q_la, q_ph)
        diag = e_diag[cell]
        if diag_yz is not None:
            par = parity_pm1(q_states[:, None] & diag_yz).to(torch.float64)
            diag = torch.where(valid, diag, torch.sum(par * diag_coeff, dim=-1))
        return diag + e_re, e_im
    idx = cells
    if mode == "dense":
        ra, rb = _cell(idx, sa, sb)
        flat = torch.where(idx >= sa * sb, sb * sa, rb * sa + ra)
        n_s = torch.cat([num.reshape(-1, 2), num.new_zeros((1, 2))])[flat]
    else:
        n_s = num
    e_re, e_im = _rotate(n_s, ref, q_la, q_ph)
    return e_diag[torch.clamp(idx, max=sa * sb)] + e_re, e_im


def grid_readout(mode: str, num, e_diag, cells, ref, q_la, q_ph, sa: int, sb: int,
                 width=None, cells_off=None, q_states=None, diag_yz=None, diag_coeff=None):
    """(e_re, e_im), each (U_q,) f64: the readout of the module's docstring.
    cells: (U_q,) int64 rank indices, or for "xl" the (a_hat, b_hat) pair;
    ref a 0-d tensor and q_la, q_ph (U_q,), all float32 or all float64;
    e_diag f64, (Sa*Sb + 1,) or for "xl" (n_cells + 1,); for "xl" also width
    and cells_off ((Sa*+1,) int32) and, for the true diagonal, q_states (U_q,)
    int64 with diag_yz (Kd,) int64 and diag_coeff (Kd,) f64."""
    if mode not in _READOUT:
        raise ValueError(f"grid_readout: mode {mode!r} is not one of {sorted(_READOUT)}")
    c0, c1 = cells if mode == "xl" else (cells, None)
    u = q_la.shape[0] if q_la.dim() == 1 else -1
    real = (q_la.dtype,)
    want = {"cells": (c0, _I64, (u,)), "q_la": (q_la, (torch.float32, torch.float64), (u,)),
            "q_ph": (q_ph, real, (u,)), "ref": (ref, real, ())}
    n_cells = num.shape[0]
    if mode == "xl":
        want.update(b_hat=(c1, _I64, (u,)), num=(num, _F32, (n_cells, 2)),
                    e_diag=(e_diag, _F64, (n_cells + 1,)), width=(width, _I32, (sa + 1,)),
                    cells_off=(cells_off, _I32, (sa + 1,)))
        if diag_yz is not None:
            kd = diag_yz.shape[0]
            want.update(q_states=(q_states, _I64, (u,)), diag_yz=(diag_yz, _I64, (kd,)),
                        diag_coeff=(diag_coeff, _F64, (kd,)))
    else:
        want.update(num=(num, _F32, (sb, sa, 2) if mode == "dense" else (u, 2)),
                    e_diag=(e_diag, _F64, (sa * sb + 1,)))
    # a numerator is loaded as one float2
    _build.check_tensors("grid_readout", q_la, want, align={"num": 8})
    if q_la.device.type == "cpu":
        return grid_readout_ref(mode, num, e_diag, cells, ref, q_la, q_ph, sa, sb, width,
                                cells_off, q_states, diag_yz, diag_coeff)
    dev = q_la.device
    out = torch.empty((2, u), dtype=torch.float64, device=dev)
    if u:
        diag = (q_states, diag_yz, diag_coeff, diag_yz.shape[0]) if diag_yz is not None \
            else (None, None, None, 0)
        _build.launch(_lib(), "grid_readout",
                      (_READOUT[mode], int(q_la.dtype == torch.float64), u, c0, c1, q_la, q_ph,
                       ref, num, e_diag, sa, sb, width, cells_off, n_cells if mode == "xl" else 0,
                       *diag, out[0], out[1]), dev)
        grid_readout.launches += 1
    return out[0], out[1]


grid_scatter.launches = 0
grid_readout.launches = 0
