"""The port's host Hamiltonian layer against naqs_tpu's, on the same inputs.

Dense and sparse H over a sorted basis (to 1e-12: the same float64
arithmetic, possibly summed in another order), the blocked assembly and the
LinearOperator, `freeze_core`'s compiled terms (exactly), the pickled qubit
operator loader with its class allowlist, and the native host library (built
with g++, which this machine has) against numpy and against the JAX package's
own build of the same source.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh

import naqs_tpu as nq
import naqs_tpu.hamiltonian as ham_j
import naqs_tpu_torch as nt
import naqs_tpu_torch.hamiltonian as ham_t
from naqs_tpu import native as native_j
from naqs_tpu.utils import molecule as mol_j
from naqs_tpu_torch import native as native_t
from naqs_tpu_torch.utils import molecule as mol_t
from test_torch_support import case

TOL = 1e-12


def _basis(c):
    b = c.h_t.basis
    return b, b.astype(np.uint64)


def _max_diff(a, b):
    d = (sp.csr_matrix(a) - sp.csr_matrix(b)).tocoo()
    return float(np.abs(d.data).max()) if d.nnz else 0.0


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_dense_hamiltonian_matches_jax(name):
    c = case(name)
    b_t, b_j = _basis(c)
    h_t = ham_t.assemble_dense_hamiltonian_np(c.terms_t, b_t)
    h_j = ham_j.assemble_dense_hamiltonian_np(c.terms_j, b_j)
    assert h_t.shape == (len(b_t), len(b_t))
    np.testing.assert_allclose(h_t, h_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(h_t, h_t.T, rtol=0, atol=TOL)   # Hermitian


@pytest.mark.parametrize("row_block", [None, 97])
@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_sparse_hamiltonian_matches_jax_and_dense(name, row_block):
    c = case(name)
    b_t, b_j = _basis(c)
    s_t = ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t, row_block=row_block)
    s_j = ham_j.assemble_sparse_hamiltonian_np(c.terms_j, b_j, row_block=row_block)
    assert s_t.format == "csr" and s_t.shape == s_j.shape
    assert _max_diff(s_t, s_j) <= TOL
    assert _max_diff(s_t, ham_t.assemble_dense_hamiltonian_np(c.terms_t, b_t)) <= TOL


def test_numpy_assembly_without_the_native_library(monkeypatch):
    """Where the library cannot be built, the blocked assembly takes the numpy
    rows and gives the same matrix."""
    c = case("H2O")
    b_t, _ = _basis(c)
    with_lib = ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t)
    monkeypatch.setattr(native_t, "get_lib", lambda: None)
    assert native_t.assemble_h_coo(c.terms_t, b_t) is None
    without = ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t, row_block=100)
    assert _max_diff(with_lib, without) <= TOL


def test_linear_operator_matvec_matches_jax():
    c = case("H2O")
    b_t, b_j = _basis(c)
    x = np.random.default_rng(0).normal(size=len(b_t))
    op_t = ham_t.hamiltonian_linear_operator(c.terms_t, b_t, row_block=128)
    op_j = ham_j.hamiltonian_linear_operator(c.terms_j, b_j, row_block=128)
    np.testing.assert_allclose(op_t.matvec(x), op_j.matvec(x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(op_t.matvec(x[:, None]).ravel(), op_t.matvec(x), rtol=0, atol=0)
    e_op = eigsh(op_t, k=1, which="SA")[0][0]
    e_sp = eigsh(ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t), k=1, which="SA")[0][0]
    assert abs(e_op - e_sp) < 1e-8


def test_sparse_ground_state_matches_fci_n2_sto3g():
    """N2 STO-3G's 14,400-state sector: the lowest eigenvalue of the native
    assembly equals the stored FCI energy, and numpy's assembly is the same
    matrix."""
    c = case("N2")
    b_t, _ = _basis(c)
    assert len(b_t) == 14_400
    h = ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t)
    e0 = eigsh(h, k=1, which="SA")[0][0]
    assert abs(e0 - c.mol_t.fci_energy) < 1e-6
    rows, cols, vals = ham_t._assemble_rows_np(c.terms_t, b_t, 0, 2000)
    h_np = sp.csr_matrix((vals, (rows, cols)), shape=(2000, len(b_t)))
    assert _max_diff(h_np, h[:2000]) <= TOL


@pytest.mark.parametrize("n_occ", [0, 2, 4])
def test_freeze_core_matches_jax(n_occ):
    c = case("H2O")
    f_t = ham_t.freeze_core(c.terms_t, n_occ)
    f_j = ham_j.freeze_core(c.terms_j, n_occ)
    assert f_t.n_qubits == f_j.n_qubits == c.terms_t.n_qubits - n_occ
    for f in ("diag_yz", "xy", "yz", "xy_unique", "gxy", "yz_unique", "gyz"):
        np.testing.assert_array_equal(getattr(f_j, f).astype(np.int64), getattr(f_t, f),
                                      err_msg=f)
    for f in ("diag_coeff", "coeff"):
        np.testing.assert_array_equal(getattr(f_j, f), getattr(f_t, f), err_msg=f)
    if n_occ:   # the frozen space's HF energy is the full space's
        h = nt.Hilbert(n_qubits=f_t.n_qubits, sectors=((c.h_t.sectors[0][0] - n_occ // 2,
                                                        c.h_t.sectors[0][1] - n_occ // 2),))
        e_f = ham_t.diagonal_energy_np(f_t, np.array([h.hf_state()]))[0]
        e_full = ham_t.diagonal_energy_np(c.terms_t, np.array([c.h_t.hf_state()]))[0]
        assert abs(e_f - e_full) < 1e-10


class _FakeQubitOperator:
    def __init__(self, terms):
        self.terms = terms


class _Gadget:
    def __reduce__(self):
        return (os.system, ("true",))


def _pickle_with_openfermion_name(obj, path, monkeypatch):
    """Pickle `obj` as openfermion.ops.QubitOperator, as OpenFermion writes
    the stored Hamiltonians (a stand-in module holds the class while dumping)."""
    mod = types.ModuleType("openfermion.ops")
    _FakeQubitOperator.__module__ = "openfermion.ops"
    _FakeQubitOperator.__qualname__ = _FakeQubitOperator.__name__ = "QubitOperator"
    mod.QubitOperator = _FakeQubitOperator
    monkeypatch.setitem(sys.modules, "openfermion", types.ModuleType("openfermion"))
    monkeypatch.setitem(sys.modules, "openfermion.ops", mod)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def test_qubit_hamiltonian_pickle_loader_matches_jax(tmp_path, monkeypatch):
    terms = dict(case("LiH").mol_t.qubit_hamiltonian)
    terms[((0, "X"), (1, "Y"))] = np.complex128(0.25 - 0.5j)   # a numpy scalar too
    path = str(tmp_path / "qubit_op.pkl")
    _pickle_with_openfermion_name(_FakeQubitOperator(terms), path, monkeypatch)
    got_t = mol_t.load_qubit_hamiltonian_pickle(path)
    got_j = mol_j.load_qubit_hamiltonian_pickle(path)
    assert got_t == got_j == {k: complex(v) for k, v in terms.items()}
    assert all(type(v) is complex for v in got_t.values())


def test_qubit_hamiltonian_pickle_loader_refuses_other_classes(tmp_path):
    path = str(tmp_path / "gadget.pkl")
    with open(path, "wb") as f:
        pickle.dump({"terms": _Gadget()}, f)
    for loader in (mol_t.load_qubit_hamiltonian_pickle, mol_j.load_qubit_hamiltonian_pickle):
        with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|nt.system"):
            loader(path)


def test_native_library_builds_and_matches_numpy():
    """The port's build of csrc/naqs_host.cpp: COO assembly, host E_loc, the
    complex CSR mat-vec and the enumeration against numpy and against the
    JAX package's build of the same source."""
    assert native_t.available() and native_j.available()
    assert native_t._LIB != native_j._LIB and os.path.exists(native_t._LIB)
    c = case("H2O")
    b_t, b_j = _basis(c)
    r0, r1 = 50, 300
    coo_t = native_t.assemble_h_coo(c.terms_t, b_t, r0, r1)
    coo_j = native_j.assemble_h_coo(c.terms_j, b_j, r0, r1)
    coo_np = ham_t._assemble_rows_np(c.terms_t, b_t, r0, r1)
    mats = [sp.csr_matrix((v, (r - r0, k)), shape=(r1 - r0, len(b_t)))
            for r, k, v in (coo_t, coo_j, coo_np)]
    assert _max_diff(mats[0], mats[1]) <= TOL and _max_diff(mats[0], mats[2]) <= TOL
    assert coo_t[0].dtype == np.int64 and coo_t[2].dtype == np.float64

    rng = np.random.default_rng(1)
    sub = np.sort(rng.choice(len(b_t), size=200, replace=False))
    psi = np.exp(rng.normal(size=200) + 1j * rng.uniform(-np.pi, np.pi, size=200))
    e_t = native_t.local_energy_host(c.terms_t, b_t[sub], psi)
    np.testing.assert_allclose(e_t, ham_t.local_energy_np(c.terms_t, b_t[sub], psi),
                               rtol=0, atol=1e-10)
    # the JAX package builds with -march=native: fused multiply-adds, last bits
    np.testing.assert_allclose(e_t, native_j.local_energy_host(c.terms_j, b_j[sub], psi),
                               rtol=0, atol=TOL)

    h = ham_t.assemble_sparse_hamiltonian_np(c.terms_t, b_t)
    x = rng.normal(size=len(b_t)) + 1j * rng.normal(size=len(b_t))
    np.testing.assert_allclose(native_t.csr_matvec_complex(h, x), h @ x, rtol=0, atol=1e-10)

    weights = (np.int64(1) << (2 * np.arange(7))).astype(np.int64)
    combos = native_t.enumerate_combinations(7, 5, weights)
    assert combos.dtype == np.int64 and len(combos) == 21
    np.testing.assert_array_equal(combos, native_j.enumerate_combinations(
        7, 5, weights.astype(np.uint64)).astype(np.int64))
    np.testing.assert_array_equal(np.sort(combos), np.sort(
        nt.Hilbert(n_qubits=14, sectors=((5, 0),)).basis))


def test_native_source_is_the_port_copy():
    """The port builds its own copy of the host source: the same text as the
    JAX package's, kept inside naqs_tpu_torch."""
    here = os.path.dirname(os.path.abspath(nt.__file__))
    assert native_t._SRC == os.path.join(here, "csrc", "naqs_host.cpp")
    with open(native_t._SRC) as a, open(native_j._SRC) as b:
        assert a.read() == b.read()
