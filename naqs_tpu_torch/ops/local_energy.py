"""Local-energy engine: E_loc(s) = sum_s' H_{ss'} psi(s')/psi(s).

Port of `naqs_tpu/ops/local_energy.py`. No sparse matrix is materialized:
coupled states are `s XOR flip_mask`, signs are popcount parities, and psi(s')
is read from the sampled set (psi = 0 for unsampled states, the truncated
estimator).

`DeviceTerms.from_terms(terms, hilbert=...)` picks the engine as the JAX
package does: on a single-sector space it builds a grid program
(`ops/dense_engine.py`: `DenseTerms` if the static H tensor fits, else
`FactorTerms`, else, for an n_exc_max-filtered sector, the staircase program
`FactorTermsXL`), and `local_energy` then computes the numerator for the
whole grid, or staircase, at once; otherwise, and for `quadratic_energy`, a
membership engine below runs: the rank engine where the space has a RankSpec,
else the sort engine. `dataclasses.replace(dt, dense=None)` forces the rank
engine, `dataclasses.replace(dt, rank_spec=None, dense=None)` the sort engine.

The sort engine, for spaces with no RankSpec (over 32 qubits, or a sector
of more than 2^26 states), runs the whole call in one launch over the query
rows, with or without a dense A: the diagonal, a binary search of each
coupled state in the sorted sample buffer, and H summed term by term only for
the found pairs (ops/sort_lookup.py::sorted_local_energy), and so does its
`quadratic_energy` (sorted_quadratic_energy). On this card that beats the
chunk loop's (C, Kyz) x (Kyz, Kxy) fp32 product for the H row, which the JAX
package keeps because the TPU's matrix unit makes it cheap (PERF.md). The
rank engine does the same where there is no dense A (over 2^26 entries:
N2 6-31G with its 1s core frozen, 287 M; ops/dyn_gather.py::
rank_local_energy, rank_quadratic_energy). With a dense A, per chunk of C
sampled states, the rank engine computes:

  * the diagonal, sum_k coeff_k (-1)^popcount(s & yz_k), in f64;
  * the H row h as parity(s & yz) @ A, a (C, Kyz) x (Kyz, Kxy) fp32 matmul
    with TF32 off (TF32 costs ~1e-3 Ha);
  * sum_k h psi(s ^ xy_k)/psi(s) in one kernel that reads psi(s') from the
    dense rank-indexed (size+1, 2) value table and sums the ratios, writing
    only (C,) sums (ops/dyn_gather.py::rank_ratio_rowsum).

The sort engine's chunk kernels (ops/sort_lookup.py::sorted_ratio_rowsum,
sorted_gather2) stay beside their plain versions, on no path.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from naqs_tpu_torch.hamiltonian import PauliTerms
from naqs_tpu_torch.ops.dense_engine import (DenseTerms, FactorTerms, FactorTermsXL, _count,
                                             dense_local_energy, factored_local_energy,
                                             factored_xl_local_energy)
from naqs_tpu_torch.ops.dyn_gather import (QUAD_MISS, rank_gather2, rank_local_energy,
                                           rank_quadratic_energy, rank_ratio_rowsum)
from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms, term_groups
from naqs_tpu_torch.ops.rank import RankSpec, build_value_table
from naqs_tpu_torch.ops.sort_lookup import (pack_table, sorted_local_energy,
                                            sorted_quadratic_energy)
from naqs_tpu_torch.utils.bits import SENTINEL, parity_pm1
from naqs_tpu_torch.utils.device import resolve_device

# full-fp32 products: TF32 passes put ~1e-3 Ha of error on E_loc
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# target elements per (chunk x term) intermediate; bounds peak memory
_CHUNK_BUDGET = 1 << 25
# above this many dense A entries, sum the H row term by term instead
_DENSE_A_MAX = 1 << 26


@dataclass(frozen=True)
class DeviceTerms:
    """PauliTerms on the device, the masks and diagonal terms zero-padded to `pad_to`.

    Pad entries are exact no-ops: xy=0 couples the diagonal with
    coefficient 0, yz=0 has parity +1 and coefficient 0. The off-diagonal
    terms are kept grouped by flip mask (`ops/offdiag_h.py::term_groups`),
    for the H row where there is no dense A.
    """

    diag_yz: torch.Tensor     # (Kd,) int64
    diag_coeff: torch.Tensor  # (Kd,) float64
    xy_unique: torch.Tensor   # (Kxy,) int64
    yz_unique: torch.Tensor   # (Kyz,) int64
    xy_ptr: torch.Tensor      # (Kxy + 1,) int32: group g's terms at xy_ptr[g] .. xy_ptr[g+1]-1
    term_yz: torch.Tensor     # (K,) int32 sign-mask index of each grouped term
    term_coeff: torch.Tensor  # (K,) float32 coefficient of each grouped term
    a_mat: torch.Tensor | None  # (Kyz, Kxy) f32 dense coupling matrix, or None
    rank_spec: RankSpec | None = None
    dense: DenseTerms | FactorTerms | FactorTermsXL | None = None  # None: rank or sort engine

    @staticmethod
    def from_terms(
        terms: PauliTerms,
        dense_a: bool | None = None,
        hilbert=None,
        pad_to: int = 256,
        device=None,
    ) -> "DeviceTerms":
        dev = resolve_device(device)

        def pad(arr, n, dtype):
            out = np.zeros((n,), dtype=arr.dtype)
            out[: len(arr)] = arr
            return torch.as_tensor(out.astype(dtype), device=dev)

        up = lambda n: max(pad_to, -(-n // pad_to) * pad_to)
        kyz, kxy = up(len(terms.yz_unique)), up(len(terms.xy_unique))
        kd = up(len(terms.diag_yz))
        if dense_a is None:
            dense_a = kyz * kxy <= _DENSE_A_MAX
        a_mat = None
        if dense_a:
            a = np.zeros((kyz, kxy), dtype=np.float32)
            np.add.at(a, (terms.gyz, terms.gxy), terms.coeff)
            a_mat = torch.as_tensor(a, device=dev)
        rank_spec = RankSpec.for_hilbert(hilbert) if hilbert is not None else None
        dense = None
        # NAQS_TPU_DENSE=0 (read at each call, as the JAX package reads it)
        # builds no grid program: the rank engine, or the sort engine, runs
        if rank_spec is not None and os.environ.get("NAQS_TPU_DENSE", "1") != "0":
            if DenseTerms.supported(terms, hilbert):
                dense = DenseTerms.build(terms, hilbert, device=dev)
            elif FactorTerms.supported(terms, hilbert):
                dense = FactorTerms.build(terms, hilbert, device=dev)
            elif FactorTermsXL.supported(terms, hilbert):
                dense = FactorTermsXL.build(terms, hilbert, device=dev)
        xy_ptr, term_yz, term_coeff = term_groups(terms.gxy, kxy, terms.gyz, terms.coeff)
        return DeviceTerms(
            diag_yz=pad(terms.diag_yz, kd, np.int64),
            diag_coeff=pad(terms.diag_coeff, kd, np.float64),
            xy_unique=pad(terms.xy_unique, kxy, np.int64),
            yz_unique=pad(terms.yz_unique, kyz, np.int64),
            xy_ptr=torch.as_tensor(xy_ptr.astype(np.int32), device=dev),
            term_yz=torch.as_tensor(term_yz.astype(np.int32), device=dev),
            term_coeff=torch.as_tensor(term_coeff.astype(np.float32), device=dev),
            a_mat=a_mat,
            rank_spec=rank_spec,
            dense=dense,
        )


def _chunk_rows(n_xy: int, n_yz: int) -> int:
    c = max(64, _CHUNK_BUDGET // max(6 * n_xy + n_yz, 1))
    return 1 << int(math.floor(math.log2(c)))


def diagonal_energy(dt: DeviceTerms, states: torch.Tensor) -> torch.Tensor:
    """<s|H|s> in f64 for packed states (any shape)."""
    par = parity_pm1(states[..., None] & dt.diag_yz).to(torch.float64)
    return torch.sum(par * dt.diag_coeff, dim=-1)


def _offdiag_h(dt: DeviceTerms, s: torch.Tensor) -> torch.Tensor:
    """(C, Kxy) f32 off-diagonal H row entries for chunk states s (the rank
    engine's chunk loop runs it with a dense A; without one it is the per-term
    H row)."""
    if dt.a_mat is not None:
        par = parity_pm1(s[:, None] & dt.yz_unique[None, :]).to(torch.float32)
        return torch.matmul(par, dt.a_mat)
    return offdiag_h_terms(s, dt.yz_unique, dt.xy_ptr, dt.term_yz, dt.term_coeff)


def _local_energy_chunk(dt, s, table, my_log_amp, my_phase):
    """(e_re, e_im) f64 of chunk states s on the rank engine with a dense A:
    psi(s') from the rank value table `table`."""
    e_diag = diagonal_energy(dt, s)
    e_re, e_im = rank_ratio_rowsum(dt.rank_spec, s, dt.xy_unique, table, my_log_amp, my_phase,
                                   _offdiag_h(dt, s))
    return e_diag + e_re.to(torch.float64), e_im.to(torch.float64)


def _chunks(dt, u, chunk_rows):
    c = chunk_rows or _chunk_rows(int(dt.xy_unique.shape[0]),
                                  int(dt.yz_unique.shape[0]))
    return min(c, u)


@torch.no_grad()
def local_energy(
    dt: DeviceTerms,
    states: torch.Tensor,
    log_amp: torch.Tensor,
    phase: torch.Tensor,
    n_valid,
    chunk_rows: int | None = None,
    queries: Tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local energies (re, im) f64 for a sorted, SENTINEL-padded state buffer.

    Rows beyond n_valid produce garbage values; callers mask by weight. The
    factored engine gives such a row its diagonal alone (it sums no
    numerator there), and so do the one-launch kernels (a SENTINEL row: its
    diagonal and 0); the chunk loops compute it as they do a live row, from
    whatever state the row holds.
    Dispatches to the grid engine (ops/dense_engine.py) when the terms carry
    a grid program; the rank engine below handles everything else that has a
    RankSpec, in one launch where there is no dense A (`rank_local_energy`),
    else chunk by chunk; the sort engine what has none, in one launch
    (`sorted_local_energy`) whether or not there is a dense A.
    `queries=(q_states, q_la, q_ph)` computes E_loc only for those rows,
    while psi(s') is still resolved against the full (states, log_amp,
    phase, n_valid) table.
    """
    if isinstance(dt.dense, FactorTermsXL):
        # the staircase's diagonal table covers only its own cells: states
        # outside it (the model masks per spin, so the sampler emits them)
        # get their true diagonal from the terms
        return factored_xl_local_energy(dt.dense, dt.rank_spec, states, log_amp, phase,
                                        n_valid, queries=queries,
                                        diag=(dt.diag_yz, dt.diag_coeff))
    if dt.dense is not None:
        impl = (factored_local_energy if isinstance(dt.dense, FactorTerms)
                else dense_local_energy)
        return impl(dt.dense, dt.rank_spec, states, log_amp, phase, n_valid,
                    queries=queries)
    q_states, q_la, q_ph = (states, log_amp, phase) if queries is None else queries
    u = q_states.shape[0]
    c = _chunks(dt, u, chunk_rows)
    terms = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff, dt.diag_yz,
             dt.diag_coeff)
    if dt.rank_spec is None:
        table = pack_table(states, log_amp, phase)
        return sorted_local_energy(*table, _count(n_valid, states.device),
                                   *pack_table(q_states, q_la, q_ph), *terms, chunk_rows=c)
    table = build_value_table(dt.rank_spec, states, log_amp, phase, n_valid)
    if dt.a_mat is None:
        return rank_local_energy(dt.rank_spec, table, *pack_table(q_states, q_la, q_ph),
                                 *terms, chunk_rows=c)
    e_re, e_im = [], []
    for i in range(0, u, c):
        s = q_states[i:i + c]
        la = q_la[i:i + c].to(torch.float32)
        ph = q_ph[i:i + c].to(torch.float32)
        n = s.shape[0]
        if n < c:  # the JAX engine pads the last chunk with SENTINEL rows
            pad = c - n
            s = torch.cat([s, s.new_full((pad,), SENTINEL)])
            la = torch.cat([la, la.new_zeros(pad)])
            ph = torch.cat([ph, ph.new_zeros(pad)])
        r, im = _local_energy_chunk(dt, s, table, la, ph)
        e_re.append(r[:n])
        e_im.append(im[:n])
    return torch.cat(e_re), torch.cat(e_im)


@torch.no_grad()
def quadratic_energy(
    dt: DeviceTerms,
    states: torch.Tensor,
    log_amp: torch.Tensor,
    phase: torch.Tensor,
    n_valid,
    chunk_rows: int | None = None,
) -> torch.Tensor:
    """Exact <psi|H|psi> / <psi|psi> over a sorted state buffer (f64).

    Symmetric product form exp(la_m + la_k) cos(ph_k - ph_m) with log-amps
    shifted so the largest is 0: overflow-free for any amplitude range. Miss
    slots hold la = -200, so unsampled pairs contribute exactly 0 (the sort
    engine's lookup returns -200 for a miss). The imaginary part cancels by
    Hermiticity and is not computed. One launch gives every row's numerator
    and weight where there is no dense A (`rank_quadratic_energy`) or no
    RankSpec (`sorted_quadratic_energy`), and their sums' quotient is the
    result; the rank engine with a dense A goes chunk by chunk: the gather
    kernel, the eager epilogue and P @ A.
    """
    u = states.shape[0]
    live = torch.arange(u, device=states.device) < n_valid
    ref = torch.max(torch.where(live, log_amp, -torch.inf))
    la = torch.where(live, log_amp - ref, QUAD_MISS).to(torch.float32)
    ph = phase.to(torch.float32)
    c = _chunks(dt, u, chunk_rows)
    if dt.rank_spec is not None:
        table = build_value_table(dt.rank_spec, states, la, ph, n_valid,
                                  miss_log_amp=QUAD_MISS)
    else:
        table = pack_table(states, la, ph)
    n_valid = _count(n_valid, states.device)
    if dt.a_mat is None or dt.rank_spec is None:
        terms = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff,
                 dt.diag_yz, dt.diag_coeff)
        if dt.rank_spec is not None:
            num, w = rank_quadratic_energy(dt.rank_spec, table, n_valid, states, la, ph,
                                           *terms, chunk_rows=c)
        else:
            num, w = sorted_quadratic_energy(*table, n_valid, *terms, chunk_rows=c)
        return torch.sum(num) / torch.sum(w)
    num = torch.zeros((), dtype=torch.float64, device=states.device)
    den = torch.zeros((), dtype=torch.float64, device=states.device)
    for i in range(0, u, c):
        s, my_la, my_ph, my_live = (states[i:i + c], la[i:i + c],
                                    ph[i:i + c], live[i:i + c])
        w_m = torch.where(my_live, torch.exp(2.0 * my_la.to(torch.float64)), 0.0)
        num += torch.sum(w_m * diagonal_energy(dt, s))
        g_la, g_ph = rank_gather2(dt.rank_spec, s, dt.xy_unique, table)
        amp = torch.where(my_live[:, None], torch.exp(g_la + my_la[:, None]), 0.0)
        r_re = amp * torch.cos(g_ph - my_ph[:, None])
        num_off = torch.sum(_offdiag_h(dt, s) * r_re, dim=-1)
        num += torch.sum(num_off.to(torch.float64))
        den += torch.sum(w_m)
    return num / den


@torch.no_grad()
def expectation_energy(
    dt: DeviceTerms,
    states: torch.Tensor,
    log_amp: torch.Tensor,
    phase: torch.Tensor,
    weights: torch.Tensor,
    n_valid,
    chunk_rows: int | None = None,
):
    """Weighted <E_loc>, its variance and per-state E_loc. weights sum to 1."""
    e_re, e_im = local_energy(dt, states, log_amp, phase, n_valid, chunk_rows)
    live = torch.arange(states.shape[0], device=states.device) < n_valid
    e_re = torch.where(live, e_re, 0.0)
    e_im = torch.where(live, e_im, 0.0)
    e_mean = torch.sum(weights * e_re)
    e_var = torch.sum(weights * (e_re - e_mean) ** 2)
    return e_mean, e_var, (e_re, e_im)
