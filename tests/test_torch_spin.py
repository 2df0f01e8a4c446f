"""The port's utils/spin.py against naqs_tpu's.

Tolerances: the S^2 and H + lam S^2 term dicts within 1e-12 per coefficient
(the same ladder algebra in double precision); the S^2 matrix within 1e-12
per entry; lowest_eig_with_spin's energy within 1e-10 Ha (two Lanczos
solves of the same matrix, each to machine precision), its <S^2> values
within 1e-8 and the same index.
"""

import numpy as np
import pytest

from naqs_tpu.utils import spin as spin_j
from naqs_tpu_torch import compile_pauli_terms
from naqs_tpu_torch.hamiltonian import assemble_sparse_hamiltonian_np
from naqs_tpu_torch.utils import spin as spin_t
from test_torch_support import case, to_u64


def _same_dicts(a, b, tol=1e-12):
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= tol, k


@pytest.mark.parametrize("n_spatial", [2, 3, 4, 5, 6])
def test_s_squared_termdict_matches_jax(n_spatial):
    _same_dicts(spin_t.s_squared_termdict(n_spatial), spin_j.s_squared_termdict(n_spatial))


@pytest.mark.parametrize("name", ["H2", "LiH"])
def test_penalized_termdict_matches_jax(name):
    c = case(name)
    h_td = c.mol_t.qubit_hamiltonian
    _same_dicts(spin_t.penalized_termdict(h_td, c.mol_t.n_qubits, 0.5),
                spin_j.penalized_termdict(c.mol_j.qubit_hamiltonian, c.mol_j.n_qubits, 0.5))


def test_s_squared_sparse_matches_jax_and_is_a_spin_operator():
    c = case("LiH")
    basis = c.h_t.basis
    s2_t = spin_t.s_squared_sparse(basis, c.mol_t.n_qubits)
    s2_j = spin_j.s_squared_sparse(to_u64(basis), c.mol_j.n_qubits)
    assert abs(s2_t - s2_j).max() <= 1e-12
    # eigenvalues s(s+1): 0 (singlets), 2 (triplets), 6 (quintets) in (2, 2)
    w = np.linalg.eigvalsh(s2_t.toarray())
    assert np.allclose(w, np.round(w), atol=1e-9)
    assert set(np.round(w).astype(int)) <= {0, 2, 6}


@pytest.mark.parametrize("target_s2", [0.0, 2.0])
def test_lowest_eig_with_spin_matches_jax_on_lih(target_s2):
    c = case("LiH")
    basis = c.h_t.basis
    h = assemble_sparse_hamiltonian_np(
        compile_pauli_terms(c.mol_t.qubit_hamiltonian, c.mol_t.n_qubits), basis)
    e_t, vec_t, s2_t, idx_t = spin_t.lowest_eig_with_spin(h, basis, c.mol_t.n_qubits,
                                                           target_s2=target_s2)
    e_j, vec_j, s2_j, idx_j = spin_j.lowest_eig_with_spin(h, to_u64(basis),
                                                           c.mol_j.n_qubits,
                                                           target_s2=target_s2)
    assert idx_t == idx_j and idx_t is not None
    assert abs(e_t - e_j) <= 1e-10
    np.testing.assert_allclose(s2_t, s2_j, rtol=0, atol=1e-8)
    assert abs(abs(np.dot(vec_t, vec_j)) - 1.0) < 1e-8
    if target_s2 == 0.0:
        assert abs(e_t - c.mol_t.fci_energy) < 1e-6
    else:
        assert idx_t > 0 and e_t > c.mol_t.fci_energy
