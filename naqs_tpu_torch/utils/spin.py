"""Total-spin S^2 as a qubit operator + spin-resolved eigenstate selection.

The port's own copy of `naqs_tpu/utils/spin.py` (host numpy and scipy only),
built on the port's `jw` ladder algebra and `hamiltonian` assembly.

Why this exists: the JW particle sectors the framework (and the reference,
src/utils/hilbert.py) restricts to are S_z sectors, NOT total-spin sectors.
An (n_a, n_b) = (7, 7) sector contains the S_z = 0 components of triplets
and quintets alongside the singlets — and for stretched geometries those
can drop BELOW the singlet ground state. On the reference's own molecule
data, for N2 at r = 2.1 A the stored Psi4 "FCI" energy (-107.430438, a
singlet) is only the THIRD eigenvalue of the sector Hamiltonian: two
spin-contaminated states sit 18.2 / 12.5 mHa lower. Energy-minimizing VMC
correctly converges onto those, which looks like a "nonphysical below-FCI
energy" if one only ever compares against the singlet number.

This module builds S^2 = S_z^2 + S_z + S^- S^+ exactly, through the same
symplectic ladder-operator algebra that derives the Hamiltonian
(naqs_tpu_torch/jw.py), so spin-resolved selection can pick the lowest eigenpair
with a chosen total spin out of a subspace diagonalization. The reference
has no counterpart — it simply reports the trapped/contaminated energies.

Interleaved ordering convention: spin-up <-> even qubits (matches
utils/hilbert.py and the JW derivation in jw.py).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Tuple

import numpy as np

from naqs_tpu_torch.jw import _accumulate, _symplectic_to_termdict


def s_squared_termdict(n_spatial: int, threshold: float = 1e-12):
    """Pauli-term dict of S^2 for `n_spatial` spatial orbitals.

    S^2 = S_z^2 + S_z + S^- S^+ with
      S_z    = 1/2 sum_p (n_{p,up} - n_{p,dn})
      S^+    = sum_q a+_{q,up} a_{q,dn}
      S^- S^+ = sum_{pq} a+_{p,dn} a_{p,up} a+_{q,up} a_{q,dn}
    """
    acc = defaultdict(complex)
    up = lambda p: 2 * p
    dn = lambda p: 2 * p + 1

    # S_z and S_z^2 from products of number operators (the ladder algebra
    # normal-orders n^2 = n automatically)
    for p in range(n_spatial):
        for s, sgn in ((up, 0.5), (dn, -0.5)):
            _accumulate(acc, [(s(p), True), (s(p), False)], sgn)
        for q in range(n_spatial):
            for s1, g1 in ((up, 0.5), (dn, -0.5)):
                for s2, g2 in ((up, 0.5), (dn, -0.5)):
                    _accumulate(
                        acc,
                        [(s1(p), True), (s1(p), False),
                         (s2(q), True), (s2(q), False)],
                        g1 * g2,
                    )
    # S^- S^+
    for p in range(n_spatial):
        for q in range(n_spatial):
            _accumulate(
                acc,
                [(dn(p), True), (up(p), False),
                 (up(q), True), (dn(q), False)],
                1.0,
            )
    return _symplectic_to_termdict(acc, threshold)


def penalized_termdict(h_td, n_qubits: int, lam: float,
                       threshold: float = 1e-12):
    """Merged Pauli-term dict of H + lam * S^2 (spin-penalty training).

    Energy-minimizing VMC in an S_z sector legitimately converges onto
    spin-contaminated eigenstates when they lie below the singlet (stretched
    N2: the <S^2>=12 state is a zero-variance, zero-gradient fixed point
    24.7 mHa above the singlet — RESULTS.md "strong correlation"). Adding
    lam * S^2 leaves every singlet eigenvalue untouched while lifting an
    S^2 = s(s+1) contaminant by lam * s(s+1), so for lam > 0 the variational
    minimum of <H + lam S^2> IS the singlet ground energy. The reference has
    no counterpart (it reports the trapped energies). Training uses the
    merged operator; reporting still evaluates pure <H> (trainer.dt_h).

    The penalty biases towards the LOWEST total spin compatible with the
    trained sector: S = 0 in an m_s = 0 sector, S = m_s in a fixed-m_s
    open-shell sector (a uniform shift lam * m_s(m_s+1) on every reachable
    state does not move the argmin). Do not use it to target an
    ABOVE-minimal spin state.
    """
    out = dict(h_td)
    for k, v in s_squared_termdict(n_qubits // 2, threshold).items():
        out[k] = out.get(k, 0.0) + lam * v
    return {k: v for k, v in out.items() if abs(v) >= threshold}


def s_squared_sparse(basis: np.ndarray, n_qubits: int):
    """Sparse S^2 matrix over the given (sorted, packed int64) basis."""
    from naqs_tpu_torch.hamiltonian import (
        assemble_sparse_hamiltonian_np, compile_pauli_terms)

    td = s_squared_termdict(n_qubits // 2)
    terms = compile_pauli_terms(td, n_qubits)
    return assemble_sparse_hamiltonian_np(terms, basis)


def lowest_eig_with_spin(
    H,
    basis: np.ndarray,
    n_qubits: int,
    target_s2: float = 0.0,
    k: int = 8,
    tol: float = 0.3,
) -> Tuple[float, np.ndarray, np.ndarray, Optional[int]]:
    """Lowest eigenpair of sparse H whose <S^2> matches `target_s2`.

    Returns (energy, eigenvector, s2_per_eig, index); index is None (and
    the plain ground pair is returned) when none of the k lowest states
    matches — callers should treat that as "spin target not found".
    """
    from scipy.sparse.linalg import eigsh

    k_eff = int(min(k, H.shape[0] - 1))
    if k_eff < 1:
        w = np.linalg.eigvalsh(H.toarray())
        v = np.linalg.eigh(H.toarray())[1]
        w, v = w[:1], v[:, :1]
    else:
        w, v = eigsh(H, k=k_eff, which="SA")
        order = np.argsort(w)
        w, v = w[order], v[:, order]
    s2m = s_squared_sparse(basis, n_qubits)
    s2 = np.einsum("ij,ij->j", v.conj(), s2m @ v).real
    match = np.abs(s2 - target_s2) < tol
    if not match.any():
        return float(w[0]), v[:, 0], s2, None
    i = int(np.argmax(match))  # eigenvalues ascending -> first match = lowest
    return float(w[i]), v[:, i], s2, i
