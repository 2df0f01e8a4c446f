"""Jordan-Wigner transform from molecular integrals (no OpenFermion).

The port's own copy of `naqs_tpu/jw.py`: pure Python and numpy, so the
port needs nothing of the JAX package to build a qubit Hamiltonian from the
stored integrals.

Conventions (OpenFermion MolecularData):
  * spin-orbital q = 2*p + sigma (even = alpha), occupied = bit 1,
  * H = E_nuc + sum_{pq,s} h1[p,q] a+_{ps} a_{qs}
        + 1/2 sum_{pqrs,st} h2[p,q,r,s] a+_{ps} a+_{qt} a_{rt} a_{ss},
    with h2 the physicist-ordered two_body_integrals from the hdf5,
  * JW: a_p = Z_0..Z_{p-1} (X_p + i Y_p)/2.

Pauli strings are carried in symplectic form i^phase * X(a) Z(b) with packed
integer masks; products need only XORs and popcount parities.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

PauliTermDict = Dict[Tuple[Tuple[int, str], ...], complex]


def _popcount(x: int) -> int:
    return bin(x).count("1")


class _Strings:
    """A complex combination of symplectic Pauli strings {(a, b): coeff},
    meaning sum coeff * X(a) Z(b)."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = terms or {}

    @staticmethod
    def ladder(p: int, dagger: bool) -> "_Strings":
        m = (1 << p) - 1  # Z string below p
        e = 1 << p
        sign = 1.0 if dagger else -1.0
        # a(+)_p = 1/2 [X(e)Z(m) -+ X(e)Z(m ^ e)]  (see module docstring)
        return _Strings({(e, m): 0.5, (e, m ^ e): sign * 0.5})

    def __matmul__(self, other: "_Strings") -> "_Strings":
        out: Dict[Tuple[int, int], complex] = defaultdict(complex)
        for (a1, b1), c1 in self.terms.items():
            for (a2, b2), c2 in other.terms.items():
                sign = -1.0 if (_popcount(b1 & a2) & 1) else 1.0
                out[(a1 ^ a2, b1 ^ b2)] += sign * c1 * c2
        return _Strings(dict(out))


def _accumulate(acc, ops: List[Tuple[int, bool]], coeff: complex):
    """acc[(a,b)] += coeff * product of ladder ops (left to right)."""
    s = _Strings.ladder(*ops[0])
    for p, dag in ops[1:]:
        s = s @ _Strings.ladder(p, dag)
    for key, c in s.terms.items():
        acc[key] += coeff * c


def _symplectic_to_termdict(acc, threshold: float) -> PauliTermDict:
    out: PauliTermDict = {}
    for (a, b), c in acc.items():
        if abs(c) < threshold:
            continue
        # X(a)Z(b): bit in both -> Y with phase (X Z = -i Y  =>  Y = i X Z)
        y_mask = a & b
        phase = (-1j) ** _popcount(y_mask)
        coeff = complex(c * phase)
        ops = []
        bits = a | b
        q = 0
        while bits:
            if bits & 1:
                if (a >> q) & 1 and (b >> q) & 1:
                    ops.append((q, "Y"))
                elif (a >> q) & 1:
                    ops.append((q, "X"))
                else:
                    ops.append((q, "Z"))
            bits >>= 1
            q += 1
        out[tuple(ops)] = out.get(tuple(ops), 0.0) + coeff
    return {k: v for k, v in out.items() if abs(v) >= threshold}


def jordan_wigner_from_integrals(
    one_body: np.ndarray,
    two_body: np.ndarray,
    constant: float = 0.0,
    threshold: float = 1e-12,
) -> PauliTermDict:
    """Qubit-operator term dict from spatial-orbital integrals."""
    n = one_body.shape[0]
    acc: Dict[Tuple[int, int], complex] = defaultdict(complex)
    acc[(0, 0)] += constant

    for p in range(n):
        for q in range(n):
            c = one_body[p, q]
            if abs(c) < threshold:
                continue
            for s in (0, 1):
                _accumulate(acc, [(2 * p + s, True), (2 * q + s, False)], c)

    nz = np.argwhere(np.abs(two_body) >= threshold)
    for p, q, r, s in nz:
        c = 0.5 * two_body[p, q, r, s]
        for sig in (0, 1):
            for tau in (0, 1):
                i, j = 2 * p + sig, 2 * q + tau
                k, l = 2 * r + tau, 2 * s + sig
                if i == j or k == l:
                    continue  # a+a+ / aa on the same mode vanish
                _accumulate(
                    acc, [(i, True), (j, True), (k, False), (l, False)], c
                )

    return _symplectic_to_termdict(acc, threshold)
