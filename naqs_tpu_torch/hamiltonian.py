"""Jordan-Wigner Pauli-string Hamiltonian compiled to flat term arrays.

A qubit Hamiltonian is a dict {((qubit, 'X'|'Y'|'Z'), ...): coeff}. Each
Pauli string P_k acting on basis state |s> (s a packed occupation bitstring)
gives exactly one coupled state |s ^ xy_k> with matrix element

    <s ^ xy_k| P_k |s> = c_k * (-1)^{popcount(s & yz_k)}

where xy_k has bits at X/Y sites (the flip mask), yz_k has bits at Y/Z sites
(the sign mask), and c_k = (i^{n_Y} * coeff), real for Hermitian
Hamiltonians with real orbitals. Masks are int64 (see utils/bits.py).
Mirrors `naqs_tpu/hamiltonian.py`: `compile_pauli_terms` term for term, its
numpy host oracles `diagonal_energy_np` and `local_energy_np`, the host
assembly of H over a sorted basis (dense, sparse CSR by row blocks through the
native C++ assembler of `naqs_tpu_torch/native.py` or numpy, and a scipy
LinearOperator over the blocks), and `freeze_core`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from naqs_tpu_torch.utils.bits import np_parity_pm1

PauliTermDict = Dict[Tuple[Tuple[int, str], ...], complex]


@dataclass(frozen=True)
class PauliTerms:
    """Compiled Pauli-string Hamiltonian (host numpy).

    Diagonal terms (xy == 0, including the identity) are kept apart so the
    local-energy engine can sum them in f64 (they carry |E| ~ 1e2 Ha) while
    the off-diagonal correlation part runs in f32.
    """

    n_qubits: int
    diag_yz: np.ndarray      # (Kd,) int64
    diag_coeff: np.ndarray   # (Kd,) float64
    xy: np.ndarray           # (K,) int64 flip masks (never 0)
    yz: np.ndarray           # (K,) int64 sign masks
    coeff: np.ndarray        # (K,) float64
    xy_unique: np.ndarray    # (Kxy,) int64 sorted unique flip masks
    gxy: np.ndarray          # (K,) int32: index of term k's flip mask in xy_unique
    yz_unique: np.ndarray    # (Kyz,) int64 sorted unique sign masks (off-diag)
    gyz: np.ndarray          # (K,) int32

    @property
    def n_terms(self) -> int:
        return int(len(self.coeff) + len(self.diag_coeff))

    @property
    def n_unique_xy(self) -> int:
        return int(len(self.xy_unique))


def compile_pauli_terms(
    terms: PauliTermDict,
    n_qubits: int,
    n_excitations_max: Optional[int] = None,
    imag_tol: float = 1e-10,
) -> PauliTerms:
    """Compile a qubit-operator term dict into flat (xy, yz, coeff) arrays.

    n_excitations_max: drop terms with more than this many X/Y sites.
    """
    if n_qubits > 62:
        raise ValueError(f"int64 packed states hold at most 62 qubits, got {n_qubits}")
    xys, yzs, coeffs = [], [], []
    for term, coupling in terms.items():
        xy = yz = 0
        n_y = n_exc = 0
        valid = True
        for qubit, pauli in term:
            if qubit >= n_qubits:
                raise ValueError(f"term {term} touches qubit {qubit} >= {n_qubits}")
            bit = 1 << qubit
            if pauli in ("X", "Y"):
                xy |= bit
                n_exc += 1
                if pauli == "Y":
                    n_y += 1
                    yz |= bit
                if n_excitations_max is not None and n_exc > n_excitations_max:
                    valid = False
                    break
            elif pauli == "Z":
                yz |= bit
            else:
                raise ValueError(f"unknown Pauli '{pauli}' in term {term}")
        if not valid:
            continue
        if n_y % 2 == 1:
            # odd-Y strings are anti-Hermitian noise from imperfect integrals
            if abs(coupling) > 1e-5:
                raise ValueError(
                    f"large odd-Y (non-Hermitian) term {term}: {coupling}")
            continue
        c = (1j ** n_y) * complex(coupling)
        if abs(c.imag) > imag_tol * max(1.0, abs(c.real)):
            raise ValueError(f"non-Hermitian coupling {c} for term {term}")
        xys.append(xy)
        yzs.append(yz)
        coeffs.append(c.real)

    xys = np.asarray(xys, dtype=np.int64)
    yzs = np.asarray(yzs, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=np.float64)

    is_diag = xys == 0
    diag_yz, diag_coeff = yzs[is_diag], coeffs[is_diag]
    xy, yz, coeff = xys[~is_diag], yzs[~is_diag], coeffs[~is_diag]

    # merge duplicate diagonal sign-masks
    diag_yz, inv = np.unique(diag_yz, return_inverse=True)
    diag_coeff = np.bincount(inv, weights=diag_coeff, minlength=len(diag_yz))

    # merge duplicate (xy, yz) off-diagonal pairs
    order = np.lexsort((yz, xy))
    xy, yz, coeff = xy[order], yz[order], coeff[order]
    same = np.zeros(len(xy), dtype=bool)
    if len(xy) > 1:
        same[1:] = (xy[1:] == xy[:-1]) & (yz[1:] == yz[:-1])
    group = np.cumsum(~same) - 1
    n_groups = group[-1] + 1 if len(group) else 0
    first = np.flatnonzero(~same)
    coeff = np.bincount(group, weights=coeff, minlength=n_groups)
    xy, yz = xy[first], yz[first]

    xy_unique, gxy = np.unique(xy, return_inverse=True)
    yz_unique, gyz = np.unique(yz, return_inverse=True)

    return PauliTerms(
        n_qubits=n_qubits,
        diag_yz=diag_yz.astype(np.int64),
        diag_coeff=diag_coeff.astype(np.float64),
        xy=xy.astype(np.int64),
        yz=yz.astype(np.int64),
        coeff=coeff.astype(np.float64),
        xy_unique=xy_unique.astype(np.int64),
        gxy=gxy.astype(np.int32),
        yz_unique=yz_unique.astype(np.int64),
        gyz=gyz.astype(np.int32),
    )


# --------------------------------------------------------------- host oracle

def diagonal_energy_np(terms: PauliTerms, states: np.ndarray) -> np.ndarray:
    """<s|H|s> for packed states (float64)."""
    states = np.asarray(states, dtype=np.int64)
    par = np_parity_pm1(states[:, None] & terms.diag_yz[None, :]).astype(np.float64)
    return par @ terms.diag_coeff


def local_energy_np(terms: PauliTerms, states: np.ndarray, psi: np.ndarray) -> np.ndarray:
    """Host-oracle local energy E_loc(s) = sum_s' H_{s s'} psi(s') / psi(s),
    complex128, independent of every device engine.

    `states` must be sorted ascending, psi aligned. States outside the sample
    contribute zero (the truncated estimator), and a row with psi == 0 has
    ratio 0 by definition.
    """
    states = np.asarray(states, dtype=np.int64)
    e = diagonal_energy_np(terms, states).astype(np.complex128)
    denom = np.where(psi == 0, 1.0, psi)
    for j, xy in enumerate(terms.xy_unique):
        sel = terms.gxy == j
        coupled = states ^ xy
        pos = np.minimum(np.searchsorted(states, coupled), len(states) - 1)
        found = (states[pos] == coupled) & (psi != 0)
        if not found.any():
            continue
        h = np.zeros(len(states), dtype=np.float64)
        for yz, c in zip(terms.yz[sel], terms.coeff[sel]):
            h += c * np_parity_pm1(states & yz)
        e += h * np.where(found, psi[pos] / denom, 0.0)
    return e


# ---------------------------------------------------------- host assembly

def assemble_dense_hamiltonian_np(terms: PauliTerms, basis: np.ndarray) -> np.ndarray:
    """Dense H over a sorted packed-state basis (an oracle for tests and small
    solves). Couplings to states outside `basis` are dropped."""
    basis = np.asarray(basis, dtype=np.int64)
    n = len(basis)
    H = np.zeros((n, n), dtype=np.float64)
    H[np.arange(n), np.arange(n)] = diagonal_energy_np(terms, basis)
    for xy, yz, c in zip(terms.xy, terms.yz, terms.coeff):
        coupled = basis ^ xy
        pos_c = np.minimum(np.searchsorted(basis, coupled), n - 1)
        found = basis[pos_c] == coupled
        sign = np_parity_pm1(basis & yz).astype(np.float64)
        rows = np.flatnonzero(found)
        H[rows, pos_c[rows]] += c * sign[rows]
    return H


def _assemble_rows_np(terms: PauliTerms, basis: np.ndarray, r0: int, r1: int):
    """numpy COO (rows, cols, vals) of H rows [r0, r1) of a sorted basis; rows
    are absolute indices, columns search the whole basis."""
    n = len(basis)
    blk = basis[r0:r1]
    rows = [np.arange(r0, r1, dtype=np.int64)]
    cols = [np.arange(r0, r1, dtype=np.int64)]
    vals = [diagonal_energy_np(terms, blk)]
    for xy in terms.xy_unique:
        sel = terms.xy == xy
        coupled = blk ^ xy
        pos_c = np.minimum(np.searchsorted(basis, coupled), n - 1)
        idx = np.flatnonzero(basis[pos_c] == coupled)
        if len(idx) == 0:
            continue
        h = np.zeros(len(idx), dtype=np.float64)
        for yz, c in zip(terms.yz[sel], terms.coeff[sel]):
            h += c * np_parity_pm1(blk[idx] & yz)
        rows.append(idx + r0)
        cols.append(pos_c[idx])
        vals.append(h)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


# row granularity of the blocked assembly: the COO staging of a block holds at
# most block * (Kxy + 1) entries of 24 B (one 1.66 M-state block of the H2O
# 6-31G sector would take over 125 GB); 2.5e5 rows keeps it a few GB for every
# shipped system
_ASSEMBLE_ROW_BLOCK = 250_000


def assemble_sparse_hamiltonian_blocks(terms: PauliTerms, basis: np.ndarray,
                                       row_block: int | None = None):
    """H as a list of scipy CSR row blocks over a sorted packed-state basis,
    each with int32 indices (a block's nnz stays below 2^31 at the default
    granularity), assembled by the native library where it builds, else by
    numpy."""
    import scipy.sparse as sp

    from naqs_tpu_torch import native

    basis = np.asarray(basis, dtype=np.int64)
    n = len(basis)
    row_block = row_block or _ASSEMBLE_ROW_BLOCK
    blocks = []
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        coo = native.assemble_h_coo(terms, basis, r0, r1)
        if coo is None:
            coo = _assemble_rows_np(terms, basis, r0, r1)
        rows, cols, vals = coo
        blocks.append(sp.csr_matrix((vals, (rows - r0, cols)), shape=(r1 - r0, n)))
    return blocks


def assemble_sparse_hamiltonian_np(terms: PauliTerms, basis: np.ndarray,
                                   row_block: int | None = None):
    """scipy CSR H over a sorted packed-state basis (for Lanczos solves),
    assembled block by block so that the COO staging stays O(row_block); for a
    space whose matrix does not fit either, use hamiltonian_linear_operator."""
    import scipy.sparse as sp

    blocks = assemble_sparse_hamiltonian_blocks(terms, basis, row_block)
    return blocks[0] if len(blocks) == 1 else sp.vstack(blocks, format="csr")


def hamiltonian_linear_operator(terms: PauliTerms, basis: np.ndarray,
                                row_block: int | None = None):
    """H as a scipy LinearOperator over int32-indexed CSR row blocks: eigsh
    without one monolithic CSR (its vstack alone doubles the footprint)."""
    from scipy.sparse.linalg import LinearOperator

    basis = np.asarray(basis, dtype=np.int64)
    blocks = assemble_sparse_hamiltonian_blocks(terms, basis, row_block)
    n = len(basis)

    def mv(x):
        x = np.asarray(x)
        if x.ndim == 2:  # eigsh probes with column vectors
            x = x[:, 0]
        return np.concatenate([b @ x for b in blocks])

    return LinearOperator((n, n), matvec=mv, dtype=np.float64)


def freeze_core(terms: PauliTerms, n_occ: int) -> PauliTerms:
    """Project the Hamiltonian onto the subspace whose first `n_occ` qubits
    are occupied, and renumber the other qubits from 0.

    Terms that flip a frozen qubit are dropped; Z factors on frozen qubits
    give a fixed sign, folded into the coefficient.
    """
    if n_occ == 0:
        return terms
    frozen = np.int64((1 << n_occ) - 1)

    def fold(xy, yz, coeff):
        keep = (xy & frozen) == 0
        xy, yz, coeff = xy[keep], yz[keep], coeff[keep]
        sign = np_parity_pm1(yz & frozen).astype(np.float64)
        return xy >> n_occ, yz >> n_occ, coeff * sign

    dxy, dyz, dco = fold(np.zeros_like(terms.diag_yz), terms.diag_yz, terms.diag_coeff)
    xy, yz, coeff = fold(terms.xy, terms.yz, terms.coeff)

    # merge duplicates through the compiler
    out: dict = {}
    for m_xy, m_yz, c in zip(np.concatenate([np.zeros_like(dyz), xy]),
                             np.concatenate([dyz, yz]), np.concatenate([dco, coeff])):
        ops = []
        q = 0
        bits = int(m_xy) | int(m_yz)
        while bits:
            if bits & 1:
                in_xy = (int(m_xy) >> q) & 1
                in_yz = (int(m_yz) >> q) & 1
                ops.append((q, "Y" if in_xy and in_yz else "X" if in_xy else "Z"))
            bits >>= 1
            q += 1
        key = tuple(ops)
        # undo the i^n_Y folding, which compile_pauli_terms does again
        n_y = sum(1 for _, p in ops if p == "Y")
        out[key] = out.get(key, 0.0) + complex(c) / (1j ** n_y).real
    return compile_pauli_terms(out, terms.n_qubits - n_occ)
