"""Arithmetic restricted-basis addressing via combinadic (colex) ranking.

The index of a packed state inside its (n_alpha, n_beta) sector is

    idx(s) = offset[n_a(s)] + colex(alpha bits of s) * C(S, n_b) + colex(beta bits)

where colex is the colexicographic combination rank ``sum_i C(p_i, i+1)``
over the i-th lowest set bit p_i. Membership lookups then become direct
reads of a dense |basis|-sized value table. Port of `naqs_tpu/ops/rank.py`.

`rank_index` and `build_value_table` launch hand-written kernels of
`csrc/grid_glue.cu` on a CUDA tensor (`rank_index`: one thread a state, the
colex rank of `csrc/rank.cuh` from the tables of `spec_table`, staged in
shared memory; the table: `ops/grid_glue.py::grid_scatter`) and run their
plain versions on a CPU tensor: `rank_index_ref`, which reads its binomials
from a small table instead of unrolling them as constants, with the same
integer results, and the scatter's chain. There is no fallback from one to
the other; `rank_index.launches` counts kernel launches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from math import comb
from typing import Tuple

import numpy as np
import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.ops.grid_glue import _lib, grid_scatter

# dense (|basis|+1, 2) f32 value table: 8 B * 2^26 = 537 MB. Read at import
# from NAQS_TPU_RANK_MAX, the JAX package's switch (a smaller cap sends a space
# to the sort engine). Its NAQS_TPU_GATHER and NAQS_TPU_PALLAS_TABLE_MAX
# choose among TPU lowerings of the gather and have no counterpart here.
RANK_SIZE_MAX = int(os.environ.get("NAQS_TPU_RANK_MAX", 1 << 26))

_MISS = -1.0e30         # log-amp stored in empty / sentinel slots
_MISS_THRESHOLD = -1.0e29


@dataclass(frozen=True)
class RankSpec:
    """Static description of a multi-sector restricted space.

    offset/stride/expected_nb are indexed by n_alpha in [0, n_shells]:
      * offset[na]: start of the (na, nb) sector block in the dense table
      * stride[na]: C(n_shells, nb) (the beta-rank stride inside the block)
      * expected_nb[na]: the nb paired with this na, or -1 if no such sector
    """

    n_qubits: int
    n_shells: int
    size: int
    offset: Tuple[int, ...]
    stride: Tuple[int, ...]
    expected_nb: Tuple[int, ...]

    @staticmethod
    def for_hilbert(hilbert) -> "RankSpec | None":
        """Build a RankSpec for a Hilbert space, or None if unsupported."""
        s = hilbert.n_shells
        if hilbert.n_qubits > 32 or hilbert.sector_size > RANK_SIZE_MAX:
            return None
        nas = [na for (na, _) in hilbert.sectors]
        if len(set(nas)) != len(nas):
            return None  # duplicate n_alpha across sectors: ambiguous paging
        offset = [0] * (s + 1)
        stride = [0] * (s + 1)
        expected_nb = [-1] * (s + 1)
        pos = 0
        for (na, nb) in hilbert.sectors:
            offset[na] = pos
            stride[na] = comb(s, nb)
            expected_nb[na] = nb
            pos += comb(s, na) * comb(s, nb)
        assert pos == hilbert.sector_size
        return RankSpec(
            n_qubits=hilbert.n_qubits,
            n_shells=s,
            size=hilbert.sector_size,
            offset=tuple(offset),
            stride=tuple(stride),
            expected_nb=tuple(expected_nb),
        )


def spec_arrays(spec: RankSpec) -> Tuple[np.ndarray, ...]:
    """(binom (S, S+2), offset, stride, expected_nb (S+2,)) int32 arrays.

    binom[j, m] = C(j, m) (0 for m > j). The lookup vectors carry one extra
    slot, index S+1, that marks a count beyond any sector invalid.
    """
    s = spec.n_shells
    binom = np.array([[comb(j, m) if m <= j else 0 for m in range(s + 2)]
                      for j in range(s)], dtype=np.int32).reshape(s, s + 2)
    off = np.asarray(spec.offset + (0,), np.int32)
    stride = np.asarray(spec.stride + (0,), np.int32)
    exp_nb = np.asarray(spec.expected_nb + (-1,), np.int32)
    return binom, off, stride, exp_nb


@lru_cache(maxsize=16)
def _spec_tensors(spec: RankSpec, device: torch.device):
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in spec_arrays(spec))


def spec_table(spec: RankSpec):
    """(int32 array, lo_bits, qmask): the kernels' rank tables.

    Layout (csrc/rank.cuh): (S+1, 4) records (offset, stride, expected_nb,
    0) per n_alpha; lo[w], the colex rank of a word w of the low L =
    ceil(S/2) bits; hi[w_h, p], the colex rank of the high S-L bits w_h when
    p bits are set below them. colex(w) = lo[w & (2^L-1)] + hi[w >> L,
    popcount(w & (2^L-1))]. qmask keeps the low 2S bits.
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
    """The kernels' spec arguments (pointer, n_spec, n_shells, lo_bits, qmask,
    size) and the device table they point into, cached per device."""
    flat, lo_bits, qmask = spec_table(spec)
    t = torch.as_tensor(flat, device=device)
    return (t.data_ptr(), flat.size, spec.n_shells, lo_bits, qmask, spec.size), t


def rank_index_ref(spec: RankSpec, states: torch.Tensor, perm=None):
    """Plain version of `rank_index`: a loop over the shells."""
    s = spec.n_shells
    binom, off, stride, exp_nb = _spec_tensors(spec, states.device)
    x = states.to(torch.int64)
    c_a = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    c_b, r_a, r_b = c_a.clone(), c_a.clone(), c_a.clone()
    for j in range(s):
        b_a = (x >> (2 * j)) & 1
        b_b = (x >> (2 * j + 1)) & 1
        c_a += b_a
        c_b += b_b
        r_a += b_a * binom[j][c_a]
        r_b += b_b * binom[j][c_b]
    na = torch.clamp(c_a, max=s + 1)
    e = exp_nb[na]
    valid = (e >= 0) & (e == c_b)
    idx = off[na] + r_a * stride[na] + r_b
    idx = torch.where(valid, idx, spec.size)
    if perm is None:
        return idx
    perm_a, perm_b = perm
    sa_full, sb_full = perm_a.shape[0] - 1, perm_b.shape[0] - 1
    ra = torch.clamp(idx // sb_full, max=sa_full)
    rb = torch.where(idx >= sa_full * sb_full, sb_full, idx % sb_full)
    return perm_a[ra].long(), perm_b[rb].long()


def rank_index(spec: RankSpec, states: torch.Tensor, perm=None):
    """Dense-table index (int64, states' shape) of packed int64 states;
    spec.size for invalid ones.

    Only the low spec.n_qubits bits are read. Invalid states (electron counts
    matching no sector) map to the sentinel slot spec.size. With
    `perm=(perm_a, perm_b)`, the staircase engine's int32 maps from a
    single sector's alpha and beta colex ranks to its blocked indices
    (`FactorTermsXL.perm_a`, `.perm_b`, Sa_full + 1 and Sb_full + 1 long), it
    returns instead the pair (a_hat, b_hat) of (U,) int64 for 1-D states:
    perm_a[min(idx // Sb_full, Sa_full)] and perm_b[idx % Sb_full, or Sb_full
    for the sentinel]."""
    want = {"states": (states, (torch.int64,), tuple(states.shape))}
    if perm is not None:
        perm_a, perm_b = perm
        if states.dim() != 1 or perm_a.dim() != 1 or perm_b.dim() != 1 or perm_b.shape[0] < 2:
            raise ValueError("rank_index: the blocked pair takes 1-D states and 1-D maps of "
                             "at least 2 entries")
        want.update(perm_a=(perm_a, (torch.int32,), (perm_a.shape[0],)),
                    perm_b=(perm_b, (torch.int32,), (perm_b.shape[0],)))
    _build.check_tensors("rank_index", states, want)
    if spec.n_shells > 16:
        raise ValueError("rank_index: at most 32 qubits")
    if states.device.type == "cpu":
        return rank_index_ref(spec, states, perm)
    n = states.numel()
    out = torch.empty((1 if perm is None else 2, n), dtype=torch.int64, device=states.device)
    if n:
        spec_args, _ = _spec_device(spec, states.device)
        maps = (None, None, 0, 0) if perm is None else (
            perm_a, perm_b, perm_a.shape[0] - 1, perm_b.shape[0] - 1)
        _build.launch(_lib(), "rank_index", (*spec_args, states, n, *maps, out[0],
                                             None if perm is None else out[1]), states.device)
        rank_index.launches += 1
    return out[0].view(states.shape) if perm is None else (out[0], out[1])


def np_rank_index(spec: RankSpec, states: np.ndarray) -> np.ndarray:
    """Host oracle for rank_index (same semantics, numpy)."""
    states = np.asarray(states, dtype=np.int64)
    s = spec.n_shells
    binom, off, stride, exp_nb = (a.astype(np.int64) for a in spec_arrays(spec))
    c_a = np.zeros(states.shape, np.int64)
    c_b = np.zeros(states.shape, np.int64)
    r_a = np.zeros(states.shape, np.int64)
    r_b = np.zeros(states.shape, np.int64)
    for j in range(s):
        b_a = (states >> (2 * j)) & 1
        b_b = (states >> (2 * j + 1)) & 1
        c_a += b_a
        c_b += b_b
        r_a += b_a * binom[j][c_a]
        r_b += b_b * binom[j][c_b]
    na = np.minimum(c_a, s + 1)
    valid = (exp_nb[na] >= 0) & (exp_nb[na] == c_b)
    idx = off[na] + r_a * stride[na] + r_b
    return np.where(valid, idx, spec.size).astype(np.int64)


def build_value_table(
    spec: RankSpec,
    states: torch.Tensor,
    log_amp: torch.Tensor,
    phase: torch.Tensor,
    n_valid,
    miss_log_amp: float = _MISS,
) -> torch.Tensor:
    """Scatter sampled (log_amp, phase) into the dense rank-indexed table.

    Returns (size+1, 2) f32, column 0 log_amp and column 1 phase; empty
    slots and the sentinel slot hold (miss_log_amp, 0). Rows at or beyond
    n_valid, and states outside every sector, write nothing. The rank index,
    then `grid_scatter` in its table mode (on the card two launches: the
    fill, the scatter)."""
    table, _ = grid_scatter("table", rank_index(spec, states), log_amp, phase, n_valid,
                            spec.size, miss=miss_log_amp)
    return table


def lookup(spec: RankSpec, table: torch.Tensor, queries: torch.Tensor):
    """(found, log_amp, phase) of packed query states via direct addressing."""
    g = table[rank_index(spec, queries)]
    g_la = g[..., 0]
    g_ph = g[..., 1]
    return g_la > _MISS_THRESHOLD, g_la, g_ph


rank_index.launches = 0
