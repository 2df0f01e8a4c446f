"""Jordan-Wigner Pauli-string Hamiltonian compiled to flat term arrays.

A qubit Hamiltonian is a dict {((qubit, 'X'|'Y'|'Z'), ...): coeff}. Each
Pauli string P_k acting on basis state |s> (s a packed occupation bitstring)
gives exactly one coupled state |s ^ xy_k> with matrix element

    <s ^ xy_k| P_k |s> = c_k * (-1)^{popcount(s & yz_k)}

where xy_k has bits at X/Y sites (the flip mask), yz_k has bits at Y/Z sites
(the sign mask), and c_k = (i^{n_Y} * coeff), real for Hermitian
Hamiltonians with real orbitals. Masks are int64 (see utils/bits.py).
Mirrors `naqs_tpu/hamiltonian.py::compile_pauli_terms` term for term, and
keeps its numpy host oracles `diagonal_energy_np` and `local_energy_np`.
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
