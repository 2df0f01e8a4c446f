"""Sector-grid local-energy engines: gathers become static permutations.

Port of `DenseTerms` / `dense_local_energy` and `FactorTerms` /
`factored_local_energy` of `naqs_tpu/ops/dense_engine.py`. The rank engine
(ops/local_energy.py) resolves psi(s ^ xy_k) with one table lookup per
(state, flip mask) pair. Inside one (n_alpha, n_beta) sector the dense index
of ops/rank.py factors as

    idx(s) = rank_a(alpha(s)) * Sb + rank_b(beta(s)),      an Sa x Sb grid

and a flip mask xy = (xa, xb) acts on the two factors independently:

    idx(s ^ xy) = pi_a[xa][ra] * Sb + pi_b[xb][rb]

with static partial permutation maps pi_a, pi_b (molecular Jordan-Wigner
Hamiltonians conserve n_alpha and n_beta; a mask that changes a count has no
valid image). So E_loc's numerator is computed for every cell of the grid at
once, sum_k H_k(rb, ra) U[pi_a(ra), pi_b(rb)], where U holds psi / max|psi|
per cell: unsampled states and invalid images are plain zeros (the truncated
estimator psi(unsampled) = 0) with no miss markers, and the cost does not
depend on the sample count.

* `DenseTerms` keeps the per-mask Hamiltonian values H_k over the grid as a
  static (Kxy, Sb, Sa) f32 tensor: small single-sector spaces (STO-3G).
* `FactorTerms` stores nothing of size Kxy x grid: H_k is rebuilt from its
  rank-1 parity factors sum_r coeff_r par_a[ya_r] (x) par_b[yb_r]: mid-size
  single-sector spaces (H2O 6-31G).

The accumulation over masks is the hand-written part
(ops/grid_kernels.py -> csrc/grid_engine.cu); the scatter into the grid and
the readout are single PyTorch indexing calls, as in the JAX package.
`FactorTermsXL` (n_exc-filtered sectors) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from math import comb
from typing import Tuple

import numpy as np
import torch

from naqs_tpu_torch.ops.grid_kernels import CHUNK_TERMS as _CHUNK_TERMS
from naqs_tpu_torch.ops.grid_kernels import FACT_CHUNK_PAIRS as _FACT_CHUNK_PAIRS
from naqs_tpu_torch.ops.grid_kernels import dense_grid_accumulate, factored_grid_accumulate
from naqs_tpu_torch.ops.rank import rank_index
from naqs_tpu_torch.utils.bits import np_parity_pm1
from naqs_tpu_torch.utils.device import resolve_device

# dense-mode caps: sector grid cells and static H tensor bytes. 2^17 cells
# covers the closed-shell STO-3G molecules through LiCl (286^2 = 81,796)
DENSE_SIZE_MAX = 1 << 17
DENSE_H_BYTES_MAX = 1 << 30
# factored-mode caps: grid cells, and the bytes of the (Ka, Sb+1, Sa, 2)
# alpha-permuted buffer that the plain version materialises. 2^21 cells
# covers H2O 6-31G (1287^2 = 1.66M) and the water dimer (1001^2 = 1.00M)
FACT_SIZE_MAX = 1 << 21
FACT_R1_BYTES_MAX = 6 << 30
_FACT_R = 64  # rank-1 factor slots per flip mask (padded)


def _colex_ranks(s: int, n: int) -> np.ndarray:
    """Packed shell bits of all C(s, n) combinations, in the colex order of
    ops/rank.py: rank = sum_i C(p_i, i+1) over the i-th lowest set bit p_i
    (which is ascending order of the packed word)."""
    packed = np.zeros((comb(s, n),), np.int64)
    for pos in combinations(range(s), n):
        r = sum(comb(p, i + 1) for i, p in enumerate(pos))
        packed[r] = sum(1 << p for p in pos)
    return packed


def _perm_map(packed: np.ndarray, flip: int, invalid: int) -> np.ndarray:
    """rank -> rank of (combo ^ flip), or `invalid` if the count changes."""
    q = packed ^ np.int64(flip)
    j = np.minimum(np.searchsorted(packed, q), len(packed) - 1)
    return np.where(packed[j] == q, j, invalid).astype(np.int32)


def _split_spin(masks: np.ndarray, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Qubit-space masks -> (alpha, beta) shell-space words (alpha = even bits)."""
    masks = np.asarray(masks, np.int64)
    a = np.zeros(len(masks), np.int64)
    b = np.zeros(len(masks), np.int64)
    for j in range(s):
        a |= ((masks >> (2 * j)) & 1) << j
        b |= ((masks >> (2 * j + 1)) & 1) << j
    return a, b


def _expand_qubits(shell_packed: np.ndarray, spin: int, s: int) -> np.ndarray:
    """Shell-space bit pattern -> qubit-space int64 (alpha = even bits)."""
    out = np.zeros(shell_packed.shape, np.int64)
    for j in range(s):
        out |= ((shell_packed >> j) & 1) << (2 * j + spin)
    return out


def _sector(hilbert) -> Tuple[int, int, int]:
    (na, nb), = set(hilbert.sectors)
    return hilbert.n_shells, na, nb


def _flip_maps(terms, hilbert):
    """What both grid programs share: the spin combinations in rank order,
    the (Ka, Sa) alpha image map and the (Kxy, Sb) combined row map
    row_map[k, rb] = ka * (Sb+1) + beta image of rb (Sb = none)."""
    s, na, nb = _sector(hilbert)
    alpha_packed, beta_packed = _colex_ranks(s, na), _colex_ranks(s, nb)
    sa, sb = len(alpha_packed), len(beta_packed)
    xa, xb = _split_spin(terms.xy_unique, s)
    ua, ga = np.unique(xa, return_inverse=True)
    ub, gb = np.unique(xb, return_inverse=True)
    pa_idx = np.stack([_perm_map(alpha_packed, int(f), invalid=sa) for f in ua])
    pb_idx = np.stack([_perm_map(beta_packed, int(f), invalid=sb) for f in ub])
    row_map = (ga[:, None] * (sb + 1) + pb_idx[gb]).astype(np.int32)
    return s, alpha_packed, beta_packed, pa_idx, row_map


def _grid_diagonal(terms, alpha_packed, beta_packed, s) -> np.ndarray:
    """(Sa*Sb + 1,) f64: <s|H|s> per cell in rank order ([ra, rb] flat), 0 at
    the sentinel. A diagonal term's sign factors over the two spins, so the
    grid of sums is one (Sa, Kd) x (Kd, Sb) product."""
    ya, yb = _split_spin(terms.diag_yz, s)
    par_a = np_parity_pm1(alpha_packed[:, None] & ya[None, :]).astype(np.float64)
    par_b = np_parity_pm1(beta_packed[None, :] & yb[:, None]).astype(np.float64)
    e_diag = (par_a * terms.diag_coeff[None, :]) @ par_b
    return np.concatenate([e_diag.reshape(-1), [0.0]])


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad axis 0 to a multiple (pad masks are exact no-ops: H = 0)."""
    pad = -len(arr) % multiple
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)]) if pad else arr


@dataclass(frozen=True)
class DenseTerms:
    """Static dense-mode program for one (na, nb) sector."""

    r1_idx: torch.Tensor    # (Ka, Sa) int32 into grid rows [0, Sa]; Sa = pad row
    row_map: torch.Tensor   # (Kxy_pad, Sb) int32: ka * (Sb+1) + rb'
    h_dense: torch.Tensor   # (Kxy_pad, Sb, Sa) f32  H_k(s) in [rb, ra] layout
    e_diag: torch.Tensor    # (Sa*Sb + 1,) f64  <s|H|s>, 0 at the sentinel
    sa: int
    sb: int

    @staticmethod
    def supported(terms, hilbert) -> bool:
        if len(set(hilbert.sectors)) != 1 or hilbert.sector_size > DENSE_SIZE_MAX:
            return False
        s, na, nb = _sector(hilbert)
        return len(terms.xy_unique) * comb(s, na) * comb(s, nb) * 4 <= DENSE_H_BYTES_MAX

    @staticmethod
    def build(terms, hilbert, device=None) -> "DenseTerms":
        if not DenseTerms.supported(terms, hilbert):
            raise ValueError("DenseTerms does not support this space")
        dev = resolve_device(device)
        s, alpha_packed, beta_packed, r1_idx, row_map = _flip_maps(terms, hilbert)
        sa, sb = len(alpha_packed), len(beta_packed)
        state_grid = (_expand_qubits(alpha_packed, 0, s)[None, :]
                      | _expand_qubits(beta_packed, 1, s)[:, None])   # (Sb, Sa)
        h_dense = np.zeros((len(terms.xy_unique), sb, sa), np.float32)
        for x, yz, c in zip(terms.gxy, terms.yz_unique[terms.gyz], terms.coeff):
            h_dense[x] += (c * np_parity_pm1(state_grid & yz).astype(np.float64)
                           ).astype(np.float32)
        put = lambda a: torch.as_tensor(a, device=dev)
        return DenseTerms(
            r1_idx=put(r1_idx), row_map=put(_pad_rows(row_map, _CHUNK_TERMS)),
            h_dense=put(_pad_rows(h_dense, _CHUNK_TERMS)),
            e_diag=put(_grid_diagonal(terms, alpha_packed, beta_packed, s)),
            sa=sa, sb=sb)


@dataclass(frozen=True)
class FactorTerms:
    """Factored grid program for mid-size single-sector spaces: the maps of
    DenseTerms, and per flip mask its flat terms as rank-1 factors
    H_k = sum_r fcoeff[k, r] * par_a[fa_idx[k, r]] (x) par_b[fb_idx[k, r]]."""

    pa_idx: torch.Tensor    # (Ka, Sa) int32 into grid rows [0, Sa]
    row_map: torch.Tensor   # (Kxy_pad, Sb) int32: ka * (Sb+1) + rb'
    par_a: torch.Tensor     # (Kya, Sa) f32 +-1 alpha parity rows
    par_b: torch.Tensor     # (Kyb, Sb) f32 +-1 beta parity rows
    fa_idx: torch.Tensor    # (Kxy_pad, R) int32 rows of par_a
    fb_idx: torch.Tensor    # (Kxy_pad, R) int32 rows of par_b
    fcoeff: torch.Tensor    # (Kxy_pad, R) f32 flat-term coefficients (0 pad)
    e_diag: torch.Tensor    # (Sa*Sb + 1,) f64
    # beside the JAX package's fields, for the kernel:
    n_fact: torch.Tensor    # (Kxy_pad,) int32 filled slots per mask (the factor loop's end)
    alpha_words: torch.Tensor  # (Sa,) int32 shell bits of alpha combination ra
    ya_words: torch.Tensor  # (Kya,) int32 alpha sign masks: par_a[j, ra] =
    #                         (-1)^popcount(alpha_words[ra] & ya_words[j])
    sa: int
    sb: int

    @staticmethod
    def supported(terms, hilbert) -> bool:
        if len(set(hilbert.sectors)) != 1 or hilbert.sector_size > FACT_SIZE_MAX:
            return False
        s, na, nb = _sector(hilbert)
        if int(np.bincount(terms.gxy).max()) > _FACT_R:
            return False
        ka = len(np.unique(_split_spin(terms.xy_unique, s)[0]))
        return ka * comb(s, na) * (comb(s, nb) + 1) * 8 <= FACT_R1_BYTES_MAX

    @staticmethod
    def build(terms, hilbert, device=None) -> "FactorTerms":
        if not FactorTerms.supported(terms, hilbert):
            raise ValueError("FactorTerms does not support this space")
        dev = resolve_device(device)
        s, alpha_packed, beta_packed, pa_idx, row_map = _flip_maps(terms, hilbert)
        ya, yb = _split_spin(terms.yz_unique[terms.gyz], s)
        uya, ja = np.unique(ya, return_inverse=True)
        uyb, jb = np.unique(yb, return_inverse=True)
        par_a = np_parity_pm1(alpha_packed[None, :] & uya[:, None]).astype(np.float32)
        par_b = np_parity_pm1(beta_packed[None, :] & uyb[:, None]).astype(np.float32)

        # slot of each flat term inside its mask: its position among the
        # terms of that mask, in term order
        kxy = len(terms.xy_unique)
        gxy = terms.gxy.astype(np.int64)
        order = np.argsort(gxy, kind="stable")
        n_fact = np.bincount(gxy, minlength=kxy)
        slot = np.empty(len(gxy), np.int64)
        slot[order] = np.arange(len(gxy)) - np.repeat(np.cumsum(n_fact) - n_fact, n_fact)
        fa_idx = np.zeros((kxy, _FACT_R), np.int32)
        fb_idx = np.zeros((kxy, _FACT_R), np.int32)
        fcoeff = np.zeros((kxy, _FACT_R), np.float32)
        fa_idx[gxy, slot], fb_idx[gxy, slot], fcoeff[gxy, slot] = ja, jb, terms.coeff

        put = lambda a: torch.as_tensor(a, device=dev)
        pad = lambda a: put(_pad_rows(a, _FACT_CHUNK_PAIRS))
        return FactorTerms(
            pa_idx=put(pa_idx), row_map=pad(row_map), par_a=put(par_a), par_b=put(par_b),
            fa_idx=pad(fa_idx), fb_idx=pad(fb_idx), fcoeff=pad(fcoeff),
            e_diag=put(_grid_diagonal(terms, alpha_packed, beta_packed, s)),
            n_fact=pad(n_fact.astype(np.int32)), alpha_words=put(alpha_packed.astype(np.int32)),
            ya_words=put(uya.astype(np.int32)), sa=len(alpha_packed), sb=len(beta_packed))


def value_grid(rank_spec, states, log_amp, phase, n_valid, sa: int, sb: int):
    """The sampled set on the sector grid. Returns (grid, ref, idx): grid
    (Sa+1, Sb+1, 2) f32 holds psi / max|psi| (re, im) at [ra, rb] and zeros
    elsewhere, pad row Sa and pad column Sb included; ref is the live
    maximum of log_amp; idx the rank index of every buffer row (Sa*Sb for
    SENTINEL rows).

    Rows at or beyond n_valid, and rows outside the sector, carry the value
    0 and land on the pad row, so it stays zero."""
    idx = rank_index(rank_spec, states)
    live = (torch.arange(states.shape[0], device=states.device) < n_valid) & (idx < sa * sb)
    ref = torch.max(torch.where(live, log_amp, -torch.inf))
    w = torch.where(live, torch.exp(log_amp - ref), 0.0).to(torch.float32)
    u = torch.stack([w * torch.cos(phase).to(torch.float32),
                     w * torch.sin(phase).to(torch.float32)], dim=-1)
    ra, rb = _cell(idx, sa, sb)
    grid = torch.zeros((sa + 1, sb + 1, 2), dtype=torch.float32, device=states.device)
    grid[ra, rb] = u
    return grid, ref, idx


def _cell(idx, sa: int, sb: int):
    """(ra, rb) of rank indices; the sentinel Sa*Sb maps to the pad row (Sa, 0)."""
    ra = torch.clamp(idx // sb, max=sa)
    rb = torch.where(idx >= sa * sb, 0, idx % sb)
    return ra, rb


def _readout(n, e_diag, idx, ref, q_la, q_ph, sa: int, sb: int):
    """E_loc (re, im) f64 of the rows with rank indices idx from the numerator
    grid n (Sb, Sa, 2): psi_max / psi(s) * n[s], the log-ratio clipped per row
    to +-30, plus the f64 diagonal."""
    ra, rb = _cell(idx, sa, sb)
    flat = torch.where(idx >= sa * sb, sb * sa, rb * sa + ra)
    n_s = torch.cat([n.reshape(-1, 2), n.new_zeros((1, 2))])[flat]
    ratio = torch.exp(torch.clamp(ref - q_la, -30.0, 30.0)).to(torch.float32)
    c, s_ = torch.cos(q_ph).to(torch.float32), torch.sin(q_ph).to(torch.float32)
    e_re = (ratio * (n_s[:, 0] * c + n_s[:, 1] * s_)).to(torch.float64)
    e_im = (ratio * (n_s[:, 1] * c - n_s[:, 0] * s_)).to(torch.float64)
    return e_diag[torch.clamp(idx, max=sa * sb)] + e_re, e_im


def _grid_local_energy(accumulate, prog, rank_spec, states, log_amp, phase, n_valid,
                       queries):
    sa, sb = prog.sa, prog.sb
    grid, ref, idx = value_grid(rank_spec, states, log_amp, phase, n_valid, sa, sb)
    n = accumulate(prog, grid)
    if queries is None:
        return _readout(n, prog.e_diag, idx, ref, log_amp, phase, sa, sb)
    q_states, q_la, q_ph = queries
    return _readout(n, prog.e_diag, rank_index(rank_spec, q_states), ref, q_la, q_ph, sa, sb)


@torch.no_grad()
def dense_local_energy(dn: DenseTerms, rank_spec, states, log_amp, phase, n_valid,
                       queries=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """E_loc (re, im) f64 rows for the sorted SENTINEL-padded buffer, dense-grid
    algorithm.

    Semantics match ops/local_energy.local_energy: psi = 0 outside the
    sampled set, rows past n_valid are garbage, and amplitude ratios beyond
    e^30 are clipped (here per row rather than per pair: states that far
    below the peak carry negligible sampling weight either way).
    `queries=(q_states, q_la, q_ph)` restricts the readout to those rows; the
    grid is built from the full buffer, and its cost does not depend on the
    sample count."""
    return _grid_local_energy(dense_grid_accumulate, dn, rank_spec, states, log_amp,
                              phase, n_valid, queries)


@torch.no_grad()
def factored_local_energy(fn: FactorTerms, rank_spec, states, log_amp, phase, n_valid,
                          queries=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """E_loc (re, im) f64 via the factored grid program (see FactorTerms);
    semantics and `queries=` as in dense_local_energy."""
    return _grid_local_energy(factored_grid_accumulate, fn, rank_spec, states, log_amp,
                              phase, n_valid, queries)
