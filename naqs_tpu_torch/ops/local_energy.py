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

Both membership engines run the whole call in one launch over the query
rows, with or without a dense A: the diagonal, the lookup of each coupled
state that passes a filter of the sampled states (`ops/live_filter.py`), and
H summed term by term only for the found pairs. The sort engine,
for spaces with no RankSpec (over 32 qubits, or a sector of more than 2^26
states), looks up by a binary search of the sorted sample buffer
(ops/sort_lookup.py::sorted_local_energy, sorted_quadratic_energy); the rank
engine by the rank index into the dense value table of `build_value_table`
(ops/dyn_gather.py::rank_local_energy, rank_quadratic_energy). On this card
that beats the JAX package's chunk loop, whose H row is a (C, Kyz) x (Kyz,
Kxy) fp32 product with the dense A, cheap on the TPU's matrix unit
(PERF.md). The chunk kernels that loop ran (ops/dyn_gather.py::
rank_ratio_rowsum, rank_gather2; ops/sort_lookup.py::sorted_ratio_rowsum,
sorted_gather2) stay beside their plain versions, on no path.
`DeviceTerms.a_mat` is still built as the JAX package builds it, and no
engine reads it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from naqs_tpu_torch.hamiltonian import PauliTerms
from naqs_tpu_torch.ops.dense_engine import (DenseTerms, FactorTerms, FactorTermsXL,
                                             dense_local_energy, factored_local_energy,
                                             factored_xl_local_energy)
from naqs_tpu_torch.ops.dyn_gather import QUAD_MISS, rank_local_energy, rank_quadratic_energy
from naqs_tpu_torch.ops.grid_glue import _count
from naqs_tpu_torch.ops.offdiag_h import term_groups
from naqs_tpu_torch.ops.rank import RankSpec, build_value_table
from naqs_tpu_torch.ops.sort_lookup import (pack_table, sorted_local_energy,
                                            sorted_quadratic_energy)
from naqs_tpu_torch.utils.bits import parity_pm1
from naqs_tpu_torch.utils.device import resolve_device

# full-fp32 products: TF32 passes put ~1e-3 Ha of error on E_loc
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# target elements per (chunk x term) intermediate; bounds peak memory
_CHUNK_BUDGET = 1 << 25
# above this many entries no dense A is built, as in the JAX package (no
# engine of the port reads A: the H row is summed term by term)
_DENSE_A_MAX = 1 << 26


@dataclass(frozen=True)
class DeviceTerms:
    """PauliTerms on the device, the masks and diagonal terms zero-padded to `pad_to`.

    Pad entries are exact no-ops: xy=0 couples the diagonal with
    coefficient 0, yz=0 has parity +1 and coefficient 0. The off-diagonal
    terms are kept grouped by flip mask (`ops/offdiag_h.py::term_groups`),
    for the one-launch kernels' H row; `a_mat` is built as the JAX package
    builds it and read by no engine.
    """

    diag_yz: torch.Tensor     # (Kd,) int64
    diag_coeff: torch.Tensor  # (Kd,) float64
    xy_unique: torch.Tensor   # (Kxy,) int64
    yz_unique: torch.Tensor   # (Kyz,) int64
    xy_ptr: torch.Tensor      # (Kxy + 1,) int32: group g's terms at xy_ptr[g] .. xy_ptr[g+1]-1
    term_yz: torch.Tensor     # (K,) int32 sign-mask index of each grouped term
    term_coeff: torch.Tensor  # (K,) float32 coefficient of each grouped term
    a_mat: torch.Tensor | None  # (Kyz, Kxy) f32 dense coupling matrix, or None (unread)
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
    diagonal and 0).
    Dispatches to the grid engine (ops/dense_engine.py) when the terms carry
    a grid program; everything else is one launch, whether or not there is a
    dense A: the rank engine where there is a RankSpec (`rank_local_energy`),
    else the sort engine (`sorted_local_energy`).
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
    return rank_local_energy(dt.rank_spec, table, states.contiguous(),
                             _count(n_valid, states.device), *pack_table(q_states, q_la, q_ph),
                             *terms, chunk_rows=c)


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
    and weight, whether or not there is a dense A: `rank_quadratic_energy`
    where there is a RankSpec, else `sorted_quadratic_energy`; their sums'
    quotient is the result.
    """
    u = states.shape[0]
    live = torch.arange(u, device=states.device) < n_valid
    ref = torch.max(torch.where(live, log_amp, -torch.inf))
    la = torch.where(live, log_amp - ref, QUAD_MISS).to(torch.float32)
    ph = phase.to(torch.float32)
    c = _chunks(dt, u, chunk_rows)
    terms = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff, dt.diag_yz,
             dt.diag_coeff)
    nv = _count(n_valid, states.device)
    if dt.rank_spec is not None:
        table = build_value_table(dt.rank_spec, states, la, ph, n_valid,
                                  miss_log_amp=QUAD_MISS)
        num, w = rank_quadratic_energy(dt.rank_spec, table, nv, states, la, ph, *terms,
                                       chunk_rows=c)
    else:
        num, w = sorted_quadratic_energy(*pack_table(states, la, ph), nv, *terms, chunk_rows=c)
    return torch.sum(num) / torch.sum(w)


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
