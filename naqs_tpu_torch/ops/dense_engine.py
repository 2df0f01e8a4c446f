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
  single-sector spaces (H2O 6-31G). Its numerator is computed only at the
  cells the readout reads (the live rows, or the queries), not over the
  whole grid: the JAX package's scan read at those cells.
* `FactorTermsXL` is the factored program on the staircase of an
  n_exc_max-filtered sector (Li2O STO-3G CISDTQ: 644,365 cells of a 41.4 M
  sector grid): alpha and beta combinations ordered by (excitations, colex),
  so the kept cells form a staircase of alpha blocks, each over a beta prefix.

The accumulation over masks is the hand-written part of
ops/grid_kernels.py (csrc/grid_engine.cu); the rank index, the scatter into
the grid and the readout are the hand-written glue of ops/rank.py and
ops/grid_glue.py (csrc/grid_glue.cu): one E_loc call is the rank index (two
with `queries=`), the scatter's two launches, the accumulation and the
readout, where the JAX package leaves the glue to XLA.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from itertools import combinations
from math import comb
from typing import Tuple

import numpy as np
import torch

from naqs_tpu_torch.ops.grid_kernels import CHUNK_TERMS as _CHUNK_TERMS
from naqs_tpu_torch.ops.grid_kernels import FACT_CHUNK_PAIRS as _FACT_CHUNK_PAIRS
from naqs_tpu_torch.ops.grid_kernels import XL_CHUNK_INT4 as _XL_CHUNK_INT4
from naqs_tpu_torch.ops.grid_kernels import XL_TILE_CELLS as _XL_TILE_CELLS
from naqs_tpu_torch.ops.grid_kernels import (dense_grid_accumulate, factored_cells_accumulate,
                                             xl_grid_accumulate)
from naqs_tpu_torch.ops.grid_glue import _count, grid_readout, grid_scatter
from naqs_tpu_torch.ops.rank import rank_index
from naqs_tpu_torch.utils.bits import np_parity_pm1
from naqs_tpu_torch.utils.device import resolve_device

# The caps below are read at import from the JAX package's environment
# variables, with its defaults, so that one environment picks one engine in
# both packages (NAQS_TPU_DENSE=0, read by DeviceTerms.from_terms, turns the
# grid programs off).
# dense-mode caps: sector grid cells and static H tensor bytes. 2^17 cells
# covers the closed-shell STO-3G molecules through LiCl (286^2 = 81,796)
DENSE_SIZE_MAX = int(os.environ.get("NAQS_TPU_DENSE_MAX", 1 << 17))
DENSE_H_BYTES_MAX = int(os.environ.get("NAQS_TPU_DENSE_H_MAX", 1 << 30))
# factored-mode caps: grid cells, and the bytes of the (Ka, Sb+1, Sa, 2)
# alpha-permuted buffer that the plain version materialises. 2^21 cells
# covers H2O 6-31G (1287^2 = 1.66M) and the water dimer (1001^2 = 1.00M)
FACT_SIZE_MAX = int(os.environ.get("NAQS_TPU_FACT_MAX", 1 << 21))
FACT_R1_BYTES_MAX = int(os.environ.get("NAQS_TPU_FACT_R1_MAX", 6 << 30))
_FACT_R = 64  # rank-1 factor slots per flip mask (padded)
# XL caps: staircase cells, and the bytes of the (Sa*+1, Sb*+1, 2) f32 value
# grid. They cover Li2O CISDTQ (644,365 cells; 5,056^2 * 8 B = 204.5 MB)
XL_CELLS_MAX = int(os.environ.get("NAQS_TPU_XL_CELLS_MAX", 1 << 23))
XL_U_BYTES_MAX = int(os.environ.get("NAQS_TPU_XL_U_MAX", 1 << 28))
_XL_CHUNK = 64  # masks per chunk of the plain version's scan


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
    row_map[k, rb] = ka * (Sb+1) + beta image of rb (Sb = none); and the
    row map's parts, each mask's rows (ga, gb) of the alpha map and of the
    (Kb, Sb) beta image map pb_idx."""
    s, na, nb = _sector(hilbert)
    alpha_packed, beta_packed = _colex_ranks(s, na), _colex_ranks(s, nb)
    sa, sb = len(alpha_packed), len(beta_packed)
    xa, xb = _split_spin(terms.xy_unique, s)
    ua, ga = np.unique(xa, return_inverse=True)
    ub, gb = np.unique(xb, return_inverse=True)
    pa_idx = np.stack([_perm_map(alpha_packed, int(f), invalid=sa) for f in ua])
    pb_idx = np.stack([_perm_map(beta_packed, int(f), invalid=sb) for f in ub])
    row_map = (ga[:, None] * (sb + 1) + pb_idx[gb]).astype(np.int32)
    return s, alpha_packed, beta_packed, pa_idx, row_map, (ga, gb, pb_idx)


def _grid_diagonal(terms, alpha_packed, beta_packed, s) -> np.ndarray:
    """(Sa*Sb + 1,) f64: <s|H|s> per cell in rank order ([ra, rb] flat), 0 at
    the sentinel. A diagonal term's sign factors over the two spins, so the
    grid of sums is one (Sa, Kd) x (Kd, Sb) product."""
    ya, yb = _split_spin(terms.diag_yz, s)
    par_a = np_parity_pm1(alpha_packed[:, None] & ya[None, :]).astype(np.float64)
    par_b = np_parity_pm1(beta_packed[None, :] & yb[:, None]).astype(np.float64)
    e_diag = (par_a * terms.diag_coeff[None, :]) @ par_b
    return np.concatenate([e_diag.reshape(-1), [0.0]])


def _flat_factors(terms, s):
    """Each mask's flat terms as rank-1 factors, slots in term order:
    (fa_idx, fb_idx, fcoeff) of shape (Kxy, R), n_fact (Kxy,), and the
    unique alpha and beta sign masks (uya, uyb) the factor rows point to."""
    ya, yb = _split_spin(terms.yz_unique[terms.gyz], s)
    uya, ja = np.unique(ya, return_inverse=True)
    uyb, jb = np.unique(yb, return_inverse=True)
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
    return fa_idx, fb_idx, fcoeff, n_fact, uya, uyb


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
        s, alpha_packed, beta_packed, r1_idx, row_map, _ = _flip_maps(terms, hilbert)
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
    H_k = sum_r fcoeff[k, r] * par_a[fa_idx[k, r]] (x) par_b[fb_idx[k, r]].

    Beside the JAX package's fields it keeps what the cells kernel
    (`grid_kernels.factored_cells_accumulate`) reads: the row map's parts
    (ga, gb, pb_idx), both image maps transposed so that one cell's alpha
    images and beta images are each one row, the beta words, and the factor
    lists packed as (alpha sign word, beta sign word, coefficient bits, 0) per
    filled slot, mask k's at slots[slot_off[k]:slot_off[k + 1]]."""

    pa_idx: torch.Tensor    # (Ka, Sa) int32 into grid rows [0, Sa]
    row_map: torch.Tensor   # (Kxy_pad, Sb) int32: ka * (Sb+1) + rb'
    par_a: torch.Tensor     # (Kya, Sa) f32 +-1 alpha parity rows
    par_b: torch.Tensor     # (Kyb, Sb) f32 +-1 beta parity rows
    fa_idx: torch.Tensor    # (Kxy_pad, R) int32 rows of par_a
    fb_idx: torch.Tensor    # (Kxy_pad, R) int32 rows of par_b
    fcoeff: torch.Tensor    # (Kxy_pad, R) f32 flat-term coefficients (0 pad)
    e_diag: torch.Tensor    # (Sa*Sb + 1,) f64
    # beside the JAX package's fields, for the kernel:
    n_fact: torch.Tensor    # (Kxy_pad,) int32 filled slots per mask
    alpha_words: torch.Tensor  # (Sa,) int32 shell bits of alpha combination ra
    ya_words: torch.Tensor  # (Kya,) int32 alpha sign masks: par_a[j, ra] =
    #                         (-1)^popcount(alpha_words[ra] & ya_words[j])
    beta_words: torch.Tensor   # (Sb,) int32 shell bits of beta combination rb
    yb_words: torch.Tensor  # (Kyb,) int32 beta sign masks, as ya_words
    ga: torch.Tensor        # (Kxy_pad,) int32 row of pa_idx of each mask (0 pad)
    gb: torch.Tensor        # (Kxy_pad,) int32 row of pb_idx (0 pad)
    pb_idx: torch.Tensor    # (Kb, Sb) int32 into grid columns [0, Sb]
    pa_t: torch.Tensor      # (Sa, Ka4) int32 pa_idx transposed, rows padded with Sa
    #                         to whole 16-byte pieces (Ka4 = Ka rounded up to 4)
    pb_t: torch.Tensor      # (Sb, Kb4) int32 pb_idx transposed, padded with Sb
    slot_off: torch.Tensor  # (Kxy_pad + 1,) int32 each mask's first packed slot
    slots: torch.Tensor     # (n_fact.sum(), 4) int32 packed factors, mask by mask
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
        s, alpha_packed, beta_packed, pa_idx, row_map, (ga, gb, pb_idx) = _flip_maps(terms,
                                                                                     hilbert)
        fa_idx, fb_idx, fcoeff, n_fact, uya, uyb = _flat_factors(terms, s)
        par_a = np_parity_pm1(alpha_packed[None, :] & uya[:, None]).astype(np.float32)
        par_b = np_parity_pm1(beta_packed[None, :] & uyb[:, None]).astype(np.float32)
        sa, sb = len(alpha_packed), len(beta_packed)
        ya_words, yb_words = uya.astype(np.int32), uyb.astype(np.int32)
        filled = np.arange(_FACT_R)[None, :] < n_fact[:, None]      # mask-major, slot order
        slots = np.zeros((int(n_fact.sum()), 4), np.int32)
        slots[:, 0] = ya_words[fa_idx[filled]]
        slots[:, 1] = yb_words[fb_idx[filled]]
        slots[:, 2] = np.ascontiguousarray(fcoeff[filled]).view(np.int32)
        n_fact = _pad_rows(n_fact.astype(np.int32), _FACT_CHUNK_PAIRS)
        slot_off = np.concatenate([[0], np.cumsum(n_fact)]).astype(np.int32)

        def transposed(idx, invalid):
            t = np.full((idx.shape[1], -(-idx.shape[0] // 4) * 4), invalid, np.int32)
            t[:, :idx.shape[0]] = idx.T
            return t

        put = lambda a: torch.as_tensor(a, device=dev)
        pad = lambda a: put(_pad_rows(a, _FACT_CHUNK_PAIRS))
        return FactorTerms(
            pa_idx=put(pa_idx), row_map=pad(row_map), par_a=put(par_a), par_b=put(par_b),
            fa_idx=pad(fa_idx), fb_idx=pad(fb_idx), fcoeff=pad(fcoeff),
            e_diag=put(_grid_diagonal(terms, alpha_packed, beta_packed, s)),
            n_fact=put(n_fact), alpha_words=put(alpha_packed.astype(np.int32)),
            ya_words=put(ya_words), beta_words=put(beta_packed.astype(np.int32)),
            yb_words=put(yb_words), ga=pad(ga.astype(np.int32)), gb=pad(gb.astype(np.int32)),
            pb_idx=put(pb_idx), pa_t=put(transposed(pa_idx, sa)), pb_t=put(transposed(pb_idx, sb)),
            slot_off=put(slot_off), slots=put(slots), sa=sa, sb=sb)


def _blocked(s: int, n_occ: int, e_max: int):
    """One spin's combinations in the (excitations, colex) order of the XL
    staircase: (packed shell bits in colex order, the kept colex ranks in
    blocked order, perm: colex rank -> blocked index (n kept for dropped
    ranks and for the sentinel rank C(s, n_occ)), kept count per excitation
    level 0..e_max). Excitations: bits outside the lowest n_occ shells."""
    packed = _colex_ranks(s, n_occ)
    hf = (1 << n_occ) - 1
    exc = np.bitwise_count((packed & ~hf).astype(np.uint64)).astype(np.int64)
    order = np.lexsort((np.arange(len(packed)), exc))
    order = order[exc[order] <= e_max]
    perm = np.full(len(packed) + 1, len(order), np.int32)
    perm[order] = np.arange(len(order), dtype=np.int32)
    return packed, order, perm, np.bincount(exc[order], minlength=e_max + 1)


def _xl_tiles(width: np.ndarray, b_cum: np.ndarray, e_max: int, tile_cells: int):
    """The kernel's blocks: (n_tiles, 4) int32 rows (orientation, p, q_lo,
    q_hi), each covering at most tile_cells staircase cells, every cell once.
    Orientation 0, a column: p = rb, the threads over ra in [q_lo, q_hi);
    orientation 1, a row: p = ra, the threads over rb. Columns of at most
    e_max // 2 beta excitations run as columns (their alpha extent is at
    least the prefix of e_max - e_max // 2 alpha excitations), the rest of
    the staircase as rows (at most e_max - e_max // 2 - 1 alpha
    excitations): no program serves a short run of cells."""
    rows = []

    def cut(orient, p, lo, hi):
        n = hi - lo
        t = -(-n // tile_cells)
        rows.extend((orient, p, lo + i * n // t, lo + (i + 1) * n // t) for i in range(t))

    w = width[:-1]
    cb = int(b_cum[e_max // 2])
    extent = np.searchsorted(-w, -np.arange(cb), side="left")    # #ra with width > rb
    for rb in range(cb):
        cut(0, rb, 0, int(extent[rb]))
    for ra in np.flatnonzero(w > cb):
        cut(1, int(ra), cb, int(w[ra]))
    return np.asarray(rows, np.int32).reshape(-1, 4)


def _xl_program(ga, gb, fa_idx, fb_idx, fcoeff, n_fact, ya_words, yb_words, max_run):
    """The kernel's static factor program for both tile orientations: (prog
    (P, 4) int32, chunks (C, 4) int32, the number of column chunks, which come
    first). Per orientation the masks with factors run in the order (row of
    the fixed spin's image map, mask): gb for column tiles (rb fixed), ga for
    row tiles (ra fixed), so masks that share an image of the fixed index are
    neighbours. They are cut into chunks of one map row and at most max_run
    int4s, (row, start, masks, the first mask's row of the cells' map). A
    chunk holds its masks' headers (row of the cells' image map, factor
    count, mask, offset of its factors from the header), then their factors
    (the cells' spin's sign word, the fixed spin's sign word, the
    coefficient's bits, 0): H_k at (ra, rb) is the sum of the coefficients,
    each with its sign flipped by the parity of both words against the
    cell's."""
    coef = np.ascontiguousarray(fcoeff).view(np.int32)
    blocks, chunks, n_col, pos = [], [], 0, 0
    orients = ((gb, ga, fa_idx, ya_words, fb_idx, yb_words),   # column tiles
               (ga, gb, fb_idx, yb_words, fa_idx, ya_words))   # row tiles

    def close(cur):
        row, masks = cur
        heads = np.zeros((len(masks), 4), np.int32)
        facs = []
        off = len(masks)
        for i, (g_q, k, f) in enumerate(masks):
            heads[i] = g_q, len(f), k, off - i
            facs.append(f)
            off += len(f)
        blocks.extend([heads] + facs)
        chunks.append((row, pos, len(masks), masks[0][0]))
        return pos + off

    for orient, (g_fix, g_cell, f_cell, y_cell, f_fix, y_fix) in enumerate(orients):
        cur, used = None, 0
        for k in np.lexsort((np.arange(len(g_fix)), g_fix)):
            nf = int(n_fact[k])
            if nf == 0:
                continue
            f = np.zeros((nf, 4), np.int32)
            f[:, 0] = y_cell[f_cell[k, :nf]]
            f[:, 1] = y_fix[f_fix[k, :nf]]
            f[:, 2] = coef[k, :nf]
            if cur is None or cur[0] != g_fix[k] or used + 1 + nf > max_run:
                if cur is not None:
                    pos = close(cur)
                cur, used = (int(g_fix[k]), []), 0
            cur[1].append((int(g_cell[k]), int(k), f))
            used += 1 + nf
        if cur is not None:
            pos = close(cur)
        if orient == 0:
            n_col = len(chunks)
    prog = np.concatenate(blocks) if blocks else np.zeros((0, 4), np.int32)
    return prog, np.asarray(chunks, np.int32).reshape(-1, 4), n_col


@dataclass(frozen=True)
class FactorTermsXL:
    """Factored grid program on the staircase of an n_exc_max-filtered sector.

    The excitation count is separable, exc(s) = exc_a(alpha) + exc_b(beta),
    so with alpha combinations ordered by (exc_a, colex) and beta ones by
    (exc_b, colex) the kept cells form a staircase: alpha block ka sees the
    beta prefix of width P[E - ka]. The numerator is computed on those cells
    only, packed row by row (`cells_off`), reading psi from the restricted
    rectangle's (Sa*+1, Sb*+1, 2) value grid. An image outside the rectangle
    reads the zero pad row or column (psi = 0 there); a sampled state inside
    the rectangle but outside the staircase is read as sampled, as the JAX
    package does. Fields as in JAX's FactorTermsXL; beside them the flat
    program (masks' image rows, factor lists, word tables), the kernel's
    tiles and its static program built from the flat one (`_xl_program`)."""

    perm_a: torch.Tensor     # (Sa_full+1,) int32 colex rank -> blocked idx | Sa*
    perm_b: torch.Tensor     # (Sb_full+1,) int32
    width: torch.Tensor      # (Sa*+1,) int32 staircase row width (0 at the sentinel)
    cells_off: torch.Tensor  # (Sa*+1,) int32 packed row offset (n_cells at the sentinel)
    pa_idx: torch.Tensor     # (Ka, Sa*) int32 alpha image under each flip | Sa*
    pb_idx: torch.Tensor     # (Kb, Sb*) int32
    par_a: torch.Tensor      # (Kya, Sa*) f32 +-1 parities, blocked order
    par_b: torch.Tensor      # (Kyb, Sb*) f32
    e_diag: torch.Tensor     # (n_cells + 1,) f64, 0 at the sentinel
    # the plain version's scan inputs per bucket of chunks (each stacked (G, ...)):
    b_pa_row: tuple          # (G,) int32 row of pa_idx of the chunk's alpha flip
    b_pb_row: tuple          # (G, gsz) int32 rows of pb_idx (0 pad)
    b_fa: tuple              # (G, gsz, R) int32 rows of par_a (0 pad)
    b_fb: tuple              # (G, gsz, R) int32 rows of par_b (0 pad)
    b_fc: tuple              # (G, gsz, R) f32 coefficients (0 pad: no-op)
    b_pneed: tuple           # per bucket, per alpha block: the beta prefix its reads need
    # beside the JAX package's fields, the flat program the kernel's is built from:
    ga: torch.Tensor         # (Kxy,) int32 row of pa_idx of each mask
    gb: torch.Tensor         # (Kxy,) int32 row of pb_idx
    fa_idx: torch.Tensor     # (Kxy, R) int32 rows of par_a / ya_words
    fb_idx: torch.Tensor     # (Kxy, R) int32 rows of par_b / yb_words
    fcoeff: torch.Tensor     # (Kxy, R) f32 flat-term coefficients (0 pad)
    n_fact: torch.Tensor     # (Kxy,) int32 filled slots per mask
    alpha_words: torch.Tensor  # (Sa*,) int32 shell bits of blocked alpha row ra
    beta_words: torch.Tensor   # (Sb*,) int32
    ya_words: torch.Tensor   # (Kya,) int32: par_a[j, ra] = (-1)^popc(alpha_words[ra] & ya_words[j])
    yb_words: torch.Tensor   # (Kyb,) int32
    tiles: torch.Tensor      # (n_tiles, 4) int32 the kernel's tiles (`_xl_tiles`)
    prog: torch.Tensor       # (P, 4) int32 the kernel's static factor program (`_xl_program`)
    chunks: torch.Tensor     # (C, 4) int32 its chunks: (image row, start, masks, first g)
    n_col_chunks: int        # chunks of column tiles (the first ones)
    sa: int                  # Sa* (kept alpha combinations)
    sb: int                  # Sb*
    sa_full: int
    sb_full: int
    blocks: tuple            # ((a_off, a_cnt, p_width), ...) per alpha excitation block
    n_cells: int

    @staticmethod
    def supported(terms, hilbert) -> bool:
        if hilbert.n_exc_max is None or len(set(hilbert.sectors)) != 1:
            return False
        if int(np.bincount(terms.gxy).max()) > _FACT_R:
            return False
        s, na, nb = _sector(hilbert)
        e = hilbert.n_exc_max
        a_cnt = [comb(na, k) * comb(s - na, k) for k in range(min(e, na, s - na) + 1)]
        b_cnt = [comb(nb, k) * comb(s - nb, k) for k in range(min(e, nb, s - nb) + 1)]
        cells = sum(ca * sum(b_cnt[: max(0, e - k + 1)]) for k, ca in enumerate(a_cnt))
        return (cells <= XL_CELLS_MAX
                and (sum(a_cnt) + 1) * (sum(b_cnt) + 1) * 8 <= XL_U_BYTES_MAX)

    @staticmethod
    def build(terms, hilbert, device=None) -> "FactorTermsXL":
        if not FactorTermsXL.supported(terms, hilbert):
            raise ValueError("FactorTermsXL does not support this space")
        dev = resolve_device(device)
        s, na, nb = _sector(hilbert)
        e = hilbert.n_exc_max
        alpha_packed, a_sel, perm_a, a_cnt = _blocked(s, na, e)
        beta_packed, b_sel, perm_b, b_cnt = _blocked(s, nb, e)
        sa, sb = len(a_sel), len(b_sel)
        b_cum = np.cumsum(b_cnt)
        p_of_k = b_cum[e - np.arange(e + 1)]          # beta prefix of alpha block k

        width = np.zeros(sa + 1, np.int32)
        width[:sa] = p_of_k[np.repeat(np.arange(e + 1), a_cnt)]
        cells_off = np.zeros(sa + 1, np.int32)
        cells_off[1:] = np.cumsum(width[:sa])
        n_cells = int(cells_off[sa])
        a_off = np.concatenate([[0], np.cumsum(a_cnt)])
        blocks = tuple((int(a_off[k]), int(a_cnt[k]), int(p_of_k[k]))
                       for k in range(e + 1) if a_cnt[k] > 0)

        xa, xb = _split_spin(terms.xy_unique, s)
        ua, ga = np.unique(xa, return_inverse=True)
        ub, gb = np.unique(xb, return_inverse=True)
        pa_idx = np.stack([perm_a[_perm_map(alpha_packed, int(f), len(alpha_packed))][a_sel]
                           for f in ua])
        pb_idx = np.stack([perm_b[_perm_map(beta_packed, int(f), len(beta_packed))][b_sel]
                           for f in ub])
        a_words, b_words = alpha_packed[a_sel], beta_packed[b_sel]
        fa_idx, fb_idx, fcoeff, n_fact, uya, uyb = _flat_factors(terms, s)
        prog, chunks, n_col_chunks = _xl_program(ga, gb, fa_idx, fb_idx, fcoeff, n_fact,
                                                 uya.astype(np.int32), uyb.astype(np.int32),
                                                 _XL_CHUNK_INT4)
        par_a = np_parity_pm1(a_words[None, :] & uya[:, None]).astype(np.float32)
        par_b = np_parity_pm1(b_words[None, :] & uyb[:, None]).astype(np.float32)

        # the plain version's scan: masks grouped by alpha flip, groups cut
        # into chunks of at most _XL_CHUNK masks, chunks bucketed by (padded
        # size, beta excursion): a spin-conserving flip of db beta bits moves
        # exc_b by at most db / 2, so alpha block k's reads stay inside the
        # beta prefix P[E - k + excursion]
        db = np.bitwise_count(ub.astype(np.uint64)).astype(np.int64)
        buckets = {}
        for g in range(len(ua)):
            masks = np.flatnonzero(ga == g)
            for i in range(0, len(masks), _XL_CHUNK):
                ms = masks[i:i + _XL_CHUNK]
                gsz = 1 << int(np.ceil(np.log2(len(ms))))
                dbmax = int(((db[gb[ms]] + 1) // 2).max())
                buckets.setdefault((max(1, gsz), min(dbmax, e)), []).append((g, ms))
        put = lambda a: torch.as_tensor(a, device=dev)
        b_pa_row, b_pb_row, b_fa, b_fb, b_fc, b_pneed = [], [], [], [], [], []
        for (gsz, dbmax), entries in sorted(buckets.items()):
            b_pneed.append(tuple(int(p_of_k[max(0, k - dbmax)])
                                 for k in range(e + 1) if a_cnt[k] > 0))
            shape = (len(entries), gsz, _FACT_R)
            pb_row = np.zeros(shape[:2], np.int32)
            fa, fb = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
            fc = np.zeros(shape, np.float32)
            for i, (_, ms) in enumerate(entries):
                n = len(ms)
                pb_row[i, :n], fa[i, :n], fb[i, :n], fc[i, :n] = (gb[ms], fa_idx[ms], fb_idx[ms],
                                                                  fcoeff[ms])
            b_pa_row.append(put(np.array([g for g, _ in entries], np.int32)))
            b_pb_row.append(put(pb_row))
            b_fa.append(put(fa))
            b_fb.append(put(fb))
            b_fc.append(put(fc))

        # f64 diagonal over the staircase cells in packed order; the sign
        # factors over the spins, so each block is one product
        dya, dyb = _split_spin(terms.diag_yz, s)
        da = np_parity_pm1(a_words[:, None] & dya[None, :]).astype(np.float64) * terms.diag_coeff
        d_b = np_parity_pm1(b_words[None, :] & dyb[:, None]).astype(np.float64)
        e_diag = np.concatenate([(da[off:off + cnt] @ d_b[:, :pw]).reshape(-1)
                                 for off, cnt, pw in blocks] + [[0.0]])
        return FactorTermsXL(
            perm_a=put(perm_a), perm_b=put(perm_b), width=put(width), cells_off=put(cells_off),
            pa_idx=put(pa_idx), pb_idx=put(pb_idx), par_a=put(par_a), par_b=put(par_b),
            e_diag=put(e_diag), b_pa_row=tuple(b_pa_row), b_pb_row=tuple(b_pb_row),
            b_fa=tuple(b_fa), b_fb=tuple(b_fb), b_fc=tuple(b_fc), b_pneed=tuple(b_pneed),
            ga=put(ga.astype(np.int32)), gb=put(gb.astype(np.int32)), fa_idx=put(fa_idx),
            fb_idx=put(fb_idx), fcoeff=put(fcoeff), n_fact=put(n_fact.astype(np.int32)),
            alpha_words=put(a_words.astype(np.int32)), beta_words=put(b_words.astype(np.int32)),
            ya_words=put(uya.astype(np.int32)), yb_words=put(uyb.astype(np.int32)),
            tiles=put(_xl_tiles(width, b_cum, e, _XL_TILE_CELLS)), prog=put(prog),
            chunks=put(chunks), n_col_chunks=n_col_chunks,
            sa=sa, sb=sb, sa_full=len(alpha_packed), sb_full=len(beta_packed),
            blocks=blocks, n_cells=n_cells)


def value_grid(rank_spec, states, log_amp, phase, n_valid, sa: int, sb: int):
    """The sampled set on the sector grid. Returns (grid, ref, idx): grid
    (Sa+1, Sb+1, 2) f32 holds psi / max|psi| (re, im) at [ra, rb] and zeros
    elsewhere, pad row Sa and pad column Sb included; ref is the live
    maximum of log_amp; idx the rank index of every buffer row (Sa*Sb for
    SENTINEL rows). Rows at or beyond n_valid, and rows outside the sector,
    set nothing (`grid_scatter`'s mode "grid")."""
    idx = rank_index(rank_spec, states)
    grid, ref = grid_scatter("grid", idx, log_amp, phase, n_valid, sa, sb)
    return grid, ref, idx


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
    sa, sb = dn.sa, dn.sb
    grid, ref, idx = value_grid(rank_spec, states, log_amp, phase, n_valid, sa, sb)
    n = dense_grid_accumulate(dn, grid)
    q_la, q_ph = log_amp, phase
    if queries is not None:
        q_states, q_la, q_ph = queries
        idx = rank_index(rank_spec, q_states)
    return grid_readout("dense", n, dn.e_diag, idx, ref, q_la, q_ph, sa, sb)


@torch.no_grad()
def factored_local_energy(fn: FactorTerms, rank_spec, states, log_amp, phase, n_valid,
                          queries=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """E_loc (re, im) f64 via the factored grid program (see FactorTerms);
    semantics and `queries=` as in dense_local_energy. The numerator is
    computed only at the cells the readout reads: the first n_valid buffer
    rows, or every query row (rows past n_valid read 0, their E_loc is
    their diagonal)."""
    grid, ref, idx = value_grid(rank_spec, states, log_amp, phase, n_valid, fn.sa, fn.sb)
    q_la, q_ph, n_rows = log_amp, phase, n_valid
    if queries is not None:
        q_states, q_la, q_ph = queries
        idx, n_rows = rank_index(rank_spec, q_states), q_states.shape[0]
    n_s = factored_cells_accumulate(fn, grid, idx, _count(n_rows, grid.device))
    return grid_readout("rows", n_s, fn.e_diag, idx, ref, q_la, q_ph, fn.sa, fn.sb)


def _xl_blocked_idx(fn: FactorTermsXL, rank_spec, states):
    """(a_hat, b_hat) blocked combination indices of packed states: Sa* and
    Sb* for states outside the restricted rectangle, the sector or the
    buffer (SENTINEL). One `rank_index` call with the maps perm_a, perm_b."""
    return rank_index(rank_spec, states, perm=(fn.perm_a, fn.perm_b))


def xl_value_grid(fn: FactorTermsXL, rank_spec, states, log_amp, phase, n_valid,
                  blocked=None):
    """The sampled set on the restricted rectangle: (grid, ref), grid
    (Sa*+1, Sb*+1, 2) f32 psi / max|psi| (re, im) at [a_hat, b_hat], zero
    elsewhere and on the pad row and column; ref the live maximum of log_amp.
    Every live state inside the rectangle is set, inside the staircase or
    not, as in the JAX package. `blocked`: the states' (a_hat, b_hat), if
    already computed (`_xl_blocked_idx`)."""
    if blocked is None:
        blocked = _xl_blocked_idx(fn, rank_spec, states)
    return grid_scatter("xl", blocked, log_amp, phase, n_valid, fn.sa, fn.sb)


@torch.no_grad()
def factored_xl_local_energy(fn: FactorTermsXL, rank_spec, states, log_amp, phase, n_valid,
                             queries=None, diag=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """E_loc (re, im) f64 via the staircase program (see FactorTermsXL).

    Semantics as in dense_local_energy: psi = 0 outside the sampled set and
    outside the restricted rectangle, rows past n_valid are garbage.
    `diag=(diag_yz, diag_coeff)`: queries outside the staircase get their
    true diagonal (their off-diagonal sum stays 0); without it, 0. Without
    `queries`, the buffer's blocked index serves the grid and the readout
    (the JAX package computes it twice, to the same result)."""
    blocked = _xl_blocked_idx(fn, rank_spec, states)
    grid, ref = xl_value_grid(fn, rank_spec, states, log_amp, phase, n_valid, blocked)
    n = xl_grid_accumulate(fn, grid)                                 # (n_cells, 2)
    if queries is None:
        q_states, q_la, q_ph = states, log_amp, phase
    else:
        q_states, q_la, q_ph = queries
        blocked = _xl_blocked_idx(fn, rank_spec, q_states)
    diag_yz, diag_coeff = (None, None) if diag is None else diag
    return grid_readout("xl", n, fn.e_diag, blocked, ref, q_la, q_ph, fn.sa, fn.sb,
                        width=fn.width, cells_off=fn.cells_off, q_states=q_states,
                        diag_yz=diag_yz, diag_coeff=diag_coeff)
