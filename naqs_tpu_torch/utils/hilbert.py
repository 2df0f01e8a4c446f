"""Electron-number-restricted Hilbert space over packed int64 bitstrings.

Qubit convention (Jordan-Wigner, OpenFermion order): bit 2i = alpha spin of
spatial orbital i, bit 2i+1 = beta spin. A "shell" is a spatial orbital.
Membership is decided from electron counts (and, with `n_exc_max`, the
excitation count) alone, so nothing on the training path enumerates the
basis; `basis` is built lazily (numpy) for exact-energy evaluation and tests.
Port of `naqs_tpu/utils/hilbert.py` on int64 states.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property
from math import comb
from typing import Optional, Tuple

import numpy as np

_ALPHA = sum(1 << (2 * i) for i in range(31))  # alpha-position bits


def _spin_combos(n_slots: int, n_occ: int, weights: np.ndarray) -> np.ndarray:
    """All C(n_slots, n_occ) packed ints with n_occ bits set at `weights`."""
    if n_occ < 0 or n_occ > n_slots:
        return np.zeros((0,), dtype=np.int64)
    if n_occ == 0:
        return np.zeros((1,), dtype=np.int64)
    pos = np.array(list(itertools.combinations(range(n_slots), n_occ)),
                   dtype=np.int64)
    return weights[pos].sum(axis=1)


@dataclass(frozen=True)
class Hilbert:
    """Electron-number-restricted Hilbert space for N qubits (N even, <= 62).

    sectors: allowed (n_alpha, n_beta) electron-count pairs. n_exc_max: at
    most this many electrons outside the lowest orbitals of each spin (see
    `excitation_count`); None = no excitation cap.
    """

    n_qubits: int
    sectors: Tuple[Tuple[int, int], ...]
    n_exc_max: Optional[int] = None

    def __post_init__(self):
        if self.n_qubits % 2 != 0 or not (2 <= self.n_qubits <= 62):
            raise ValueError(f"n_qubits must be even in [2, 62], got {self.n_qubits}")
        if not self.sectors:
            raise ValueError("at least one (n_alpha, n_beta) sector required")
        s = self.n_shells
        for (na, nb) in self.sectors:
            if not (0 <= na <= s and 0 <= nb <= s):
                raise ValueError(f"sector ({na},{nb}) out of range for {s} shells")
        if self.n_exc_max is not None and len({na + nb for (na, nb) in self.sectors}) != 1:
            raise ValueError("n_exc_max requires all sectors to share one total electron "
                             f"count, got {sorted({na + nb for (na, nb) in self.sectors})}")

    @staticmethod
    def for_molecule(mol, restrict_to_ms: bool = True) -> "Hilbert":
        """One (n_alpha, n_beta) sector, or every S_z-compatible split."""
        na, nb = mol.n_alpha_electrons, mol.n_beta_electrons
        m_s = abs(na - nb) // 2
        if m_s == 0 or restrict_to_ms:
            sectors = ((na, nb),)
        else:
            n = na + nb
            nas = n // 2 + np.arange(-m_s, m_s + 1)
            nbs = n // 2 + np.arange(m_s, -m_s - 1, -1)
            sectors = tuple((int(a), int(b)) for a, b in zip(nas, nbs))
        return Hilbert(n_qubits=mol.n_qubits, sectors=sectors)

    @staticmethod
    def full_n_up(n_qubits: int, n_electrons: int,
                  n_exc_max: Optional[int] = None) -> "Hilbert":
        """Every (n_alpha, n_beta) split of a fixed total electron count."""
        s = n_qubits // 2
        sectors = tuple((na, n_electrons - na)
                        for na in range(max(0, n_electrons - s), min(s, n_electrons) + 1))
        return Hilbert(n_qubits=n_qubits, sectors=sectors, n_exc_max=n_exc_max)

    @property
    def n_shells(self) -> int:
        return self.n_qubits // 2

    @property
    def sector_size(self) -> int:
        """Size of the unfiltered sector product space (the rank-table address
        space; >= len(basis) when n_exc_max filters states)."""
        s = self.n_shells
        return sum(comb(s, na) * comb(s, nb) for (na, nb) in set(self.sectors))

    @property
    def size(self) -> int:
        return self.sector_size if self.n_exc_max is None else len(self.basis)

    @staticmethod
    def excitation_count(states: np.ndarray) -> np.ndarray:
        """Excitations from the Hartree-Fock determinant of the state's own
        (n_alpha, n_beta): alpha electrons outside the lowest n_alpha alpha
        orbitals plus beta electrons outside the lowest n_beta beta orbitals.
        Counted per spin, so an open-shell state is measured against its own
        reference (a (5, 3) state's reference holds alpha bit 8, not beta
        bit 7), not against the lowest n_alpha + n_beta qubits."""
        x = np.asarray(states, dtype=np.int64).view(np.uint64)
        alpha = x & np.uint64(_ALPHA)
        beta = x & ~np.uint64(_ALPHA)
        na = np.bitwise_count(alpha).astype(np.uint64)
        nb = np.bitwise_count(beta).astype(np.uint64)
        # the lowest n alpha-position bits, (4^n - 1) / 3; n <= 31 here
        prefix = lambda n: ((np.uint64(1) << (np.uint64(2) * n)) - np.uint64(1)) // np.uint64(3)
        exc_a = np.bitwise_count(alpha & ~prefix(na))
        exc_b = np.bitwise_count(beta & ~(prefix(nb) << np.uint64(1)))
        return (exc_a + exc_b).astype(np.int64)

    @cached_property
    def basis(self) -> np.ndarray:
        """Sorted packed int64 basis of all valid states (all sectors, at most
        n_exc_max excitations)."""
        s = self.n_shells
        alpha_w = np.int64(1) << (2 * np.arange(s, dtype=np.int64))
        beta_w = alpha_w << 1
        parts = []
        for (na, nb) in set(self.sectors):
            a = _spin_combos(s, na, alpha_w)
            b = _spin_combos(s, nb, beta_w)
            parts.append((a[:, None] | b[None, :]).ravel())
        basis = np.unique(np.concatenate(parts)).astype(np.int64)
        if self.n_exc_max is not None:
            basis = basis[self.excitation_count(basis) <= self.n_exc_max]
        return basis

    def state_to_index(self, states: np.ndarray) -> np.ndarray:
        """Index of packed states in `basis`; -1 if not in it."""
        states = np.asarray(states, dtype=np.int64)
        basis = self.basis
        pos = np.minimum(np.searchsorted(basis, states), len(basis) - 1)
        return np.where(basis[pos] == states, pos, -1).astype(np.int64)

    def index_to_state(self, idx: np.ndarray) -> np.ndarray:
        return self.basis[np.asarray(idx, dtype=np.int64)]

    def sector_counts(self, states: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n_alpha, n_beta) occupation counts per packed state."""
        x = np.asarray(states, dtype=np.int64).astype(np.uint64)
        full = np.uint64((1 << self.n_qubits) - 1)
        alpha = np.uint64(_ALPHA) & full
        na = np.bitwise_count(x & alpha).astype(np.int64)
        nb = np.bitwise_count(x & (full ^ alpha)).astype(np.int64)
        return na, nb

    def contains(self, states: np.ndarray) -> np.ndarray:
        """True for states inside one of the sectors (bits >= n_qubits clear)
        with at most n_exc_max excitations; enumerates nothing."""
        x = np.asarray(states, dtype=np.int64)
        na, nb = self.sector_counts(x)
        ok = np.zeros(x.shape, dtype=bool)
        for (sa, sb) in self.sectors:
            ok |= (na == sa) & (nb == sb)
        if self.n_exc_max is not None:
            ok &= self.excitation_count(x) <= self.n_exc_max
        return ok & (x >= 0) & (x >> self.n_qubits == 0)

    def hf_state(self, sector: Optional[Tuple[int, int]] = None) -> int:
        """Packed Hartree-Fock state (lowest orbitals) of `sector`, by default
        the first."""
        na, nb = sector if sector is not None else self.sectors[0]
        return (sum(1 << (2 * i) for i in range(na))
                | sum(1 << (2 * i + 1) for i in range(nb)))
