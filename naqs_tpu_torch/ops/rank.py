"""Arithmetic restricted-basis addressing via combinadic (colex) ranking.

The index of a packed state inside its (n_alpha, n_beta) sector is

    idx(s) = offset[n_a(s)] + colex(alpha bits of s) * C(S, n_b) + colex(beta bits)

where colex is the colexicographic combination rank ``sum_i C(p_i, i+1)``
over the i-th lowest set bit p_i. Membership lookups then become direct
reads of a dense |basis|-sized value table. Port of `naqs_tpu/ops/rank.py`;
the torch `rank_index` reads its binomials from a small table instead of
unrolling them as constants, with the same integer results.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from math import comb
from typing import Tuple

import numpy as np
import torch

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


def rank_index(spec: RankSpec, states: torch.Tensor) -> torch.Tensor:
    """Dense-table index (int64) of packed int64 states; spec.size for invalid.

    Only the low spec.n_qubits bits are read. Invalid states (electron counts
    matching no sector) map to the sentinel slot spec.size.
    """
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
    return torch.where(valid, idx, spec.size)


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
    n_valid land on the sentinel slot, which is restored afterwards.
    """
    n = states.shape[0]
    idx = rank_index(spec, states)
    live = torch.arange(n, device=states.device) < n_valid
    idx = torch.where(live, idx, spec.size)
    table = torch.zeros((spec.size + 1, 2), dtype=torch.float32, device=states.device)
    table[:, 0] = miss_log_amp
    table[idx] = torch.stack([log_amp.to(torch.float32), phase.to(torch.float32)], dim=1)
    # one-row slices: a fill on the device (a single element set from a Python
    # number is copied from the host, a sync)
    table[spec.size:, 0] = miss_log_amp
    table[spec.size:, 1] = 0.0
    return table


def lookup(spec: RankSpec, table: torch.Tensor, queries: torch.Tensor):
    """(found, log_amp, phase) of packed query states via direct addressing."""
    g = table[rank_index(spec, queries)]
    g_la = g[..., 0]
    g_ph = g[..., 1]
    return g_la > _MISS_THRESHOLD, g_la, g_ph
