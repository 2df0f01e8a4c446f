"""Shared inputs for the port's parity tests (no tests here).

Molecules come from `naqs_tpu.chem.generate.generate_molecule_data` (H2,
LiH and H2O STO-3G, a few seconds each), from the port's N2 STO-3G `.npz`
(the same integrals for both packages) and from the checked-in H2O 6-31G
folder, and are cached per process. Each `Case` holds the same molecule as seen by
both packages: `*_j` objects are naqs_tpu (JAX), `*_t` objects
naqs_tpu_torch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.chem.generate import generate_molecule_data
from naqs_tpu_torch.utils.molecule import molecule_from_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O_631G_DIR = os.path.join(REPO, "data", "generated", "H2O_6-31G_gen")

_GEOMETRIES = {
    "H2": (["H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7414]]),
    "LiH": (["Li", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 1.5949]]),
    "H2O": (["O", "H", "H"], [[0.0, 0.0, 0.0], [0.2774, 0.8929, 0.2544],
                              [0.6068, -0.2383, -0.7169]]),
}


@dataclass
class Case:
    name: str
    mol_j: object
    mol_t: object
    h_j: object
    h_t: object
    terms_j: object
    terms_t: object


@lru_cache(maxsize=None)
def fields(name: str) -> dict:
    if name == "N2":
        path = os.path.join(REPO, "naqs_tpu_torch", "data", "N2_STO-3G_gen.npz")
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k].item() if z[k].ndim == 0 else z[k] for k in z.files}
    syms, pos = _GEOMETRIES[name]
    return generate_molecule_data(syms, np.asarray(pos), name=name)


def _jax_molecule(d: dict):
    from naqs_tpu.jw import jordan_wigner_from_integrals

    keep = {k: d[k] for k in ("name", "basis", "n_qubits", "n_orbitals",
                              "n_electrons", "multiplicity", "nuclear_repulsion",
                              "hf_energy", "fci_energy", "one_body_integrals",
                              "two_body_integrals")}
    mol = nq.Molecule(**keep)
    mol.qubit_hamiltonian = jordan_wigner_from_integrals(
        mol.one_body_integrals, mol.two_body_integrals, mol.nuclear_repulsion)
    return mol


@lru_cache(maxsize=None)
def case(name: str) -> Case:
    """'H2', 'LiH' or 'H2O' (STO-3G, generated), 'N2' (STO-3G, the port's
    .npz) or 'H2O_6-31G' (checked in).

    For H2O 6-31G the port reads its own .npz and reuses the JAX package's
    Jordan-Wigner term dict (the two JW codes are compared in
    test_torch_host.py); this saves one ~10 s transform per process.
    """
    if name == "H2O_6-31G":
        mol_j = nq.load_molecule(H2O_631G_DIR)
        mol_t = nt.load_molecule("H2O_6-31G_gen", load_hamiltonian=False)
        mol_t.qubit_hamiltonian = mol_j.qubit_hamiltonian
    else:
        mol_j = _jax_molecule(fields(name))
        mol_t = molecule_from_fields(fields(name))
    h_j = nq.Hilbert.for_molecule(mol_j)
    h_t = nt.Hilbert.for_molecule(mol_t)
    terms_j = nq.compile_pauli_terms(mol_j.qubit_hamiltonian, mol_j.n_qubits)
    terms_t = nt.compile_pauli_terms(mol_t.qubit_hamiltonian, mol_t.n_qubits)
    return Case(name, mol_j, mol_t, h_j, h_t, terms_j, terms_t)


def near_hf_states(c: Case, m: int, rng: np.random.Generator) -> np.ndarray:
    """Sorted int64 array of m sector states: HF plus states it couples to
    (so the truncated E_loc has hits), without enumerating the basis."""
    xy = c.terms_t.xy_unique

    def neighbours(s):
        out = np.unique(np.asarray(s)[:, None] ^ xy[None, :])
        return out[c.h_t.contains(out)]

    hf = np.array([c.h_t.hf_state()], dtype=np.int64)
    first = np.setdiff1d(neighbours(hf), hf)
    if len(first) >= m - 1:
        rest = rng.choice(first, size=m - 1, replace=False)
    else:  # small spaces: all neighbours, then some of theirs
        second = np.setdiff1d(neighbours(first), np.concatenate([hf, first]))
        rest = np.concatenate(
            [first, rng.choice(second, size=m - 1 - len(first), replace=False)])
    return np.sort(np.concatenate([hf, rest])).astype(np.int64)


def padded_batch(states: np.ndarray, cap: int, rng: np.random.Generator):
    """(states, log_amp, phase, counts) numpy buffers of length cap: the
    given sorted states, then SENTINEL padding; log-amps in [-1.5, 0]."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    m = len(states)
    s = np.full(cap, SENTINEL, dtype=np.int64)
    s[:m] = states
    la = np.zeros(cap, np.float32)
    la[:m] = -rng.uniform(0.0, 1.5, size=m)
    ph = np.zeros(cap, np.float32)
    ph[:m] = rng.uniform(-np.pi, np.pi, size=m)
    counts = np.zeros(cap, np.float64)
    counts[:m] = rng.integers(1, 1000, size=m)
    return s, la, ph, counts


def to_u64(states: np.ndarray) -> np.ndarray:
    """int64 port states -> the JAX package's uint64 (SENTINEL -> all-ones)."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    out = states.astype(np.uint64)
    out[states == SENTINEL] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return out


def h_row(dt, s):
    """(C, Kxy) f32 off-diagonal H row of states s as the JAX package's chunk
    loop forms it: parity(s & yz_unique) @ A in fp32 where dt carries a dense
    A, else the per-term segment sum (`offdiag_h_terms_ref`). The port's
    engines form neither: their one launch sums H term by term."""
    import torch

    from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms_ref
    from naqs_tpu_torch.utils.bits import parity_pm1

    if dt.a_mat is None:
        return offdiag_h_terms_ref(s, dt.yz_unique, dt.xy_ptr, dt.term_yz, dt.term_coeff)
    return torch.matmul(parity_pm1(s[:, None] & dt.yz_unique[None, :]).to(torch.float32),
                        dt.a_mat)
