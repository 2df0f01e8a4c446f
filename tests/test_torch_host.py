"""Host layer of the port: molecule data, Jordan-Wigner terms, Hilbert space,
and the rule that naqs_tpu_torch imports neither JAX nor naqs_tpu."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu_torch.utils.device import resolve_device
from test_torch_support import H2O_631G_DIR, REPO, case

_TERM_FIELDS = ("diag_yz", "xy", "yz", "xy_unique", "gxy", "yz_unique", "gyz")


def _assert_terms_equal(tj, tt):
    assert tj.n_qubits == tt.n_qubits
    for f in _TERM_FIELDS:  # integers: bitwise equal
        np.testing.assert_array_equal(
            getattr(tj, f).astype(np.int64), getattr(tt, f), err_msg=f)
    for f in ("diag_coeff", "coeff"):  # the same arithmetic: tolerance 0
        np.testing.assert_array_equal(getattr(tj, f), getattr(tt, f), err_msg=f)


def test_compile_pauli_terms_matches_jax_h2o_sto3g():
    c = case("H2O")
    _assert_terms_equal(c.terms_j, c.terms_t)


def test_compile_pauli_terms_matches_jax_h2o_631g():
    """The port's own JW + compile on its .npz against naqs_tpu on the hdf5."""
    mol_t = nt.load_molecule("H2O_6-31G_gen")
    tt = nt.compile_pauli_terms(mol_t.qubit_hamiltonian, mol_t.n_qubits)
    c = case("H2O_6-31G")
    _assert_terms_equal(c.terms_j, tt)
    assert (len(tt.coeff), len(tt.xy_unique), len(tt.yz_unique), len(tt.diag_yz)) == (
        24696, 4502, 6416, 352)


def test_npz_matches_hdf5():
    a = nt.load_molecule("H2O_6-31G_gen", load_hamiltonian=False)
    b = nq.load_molecule(H2O_631G_DIR, load_hamiltonian=False)
    c = nt.load_molecule(H2O_631G_DIR, load_hamiltonian=False)  # port via h5py
    for mol in (b, c):
        for k in ("one_body_integrals", "two_body_integrals", "orbital_energies"):
            np.testing.assert_array_equal(getattr(a, k), getattr(mol, k))
        for k in ("n_qubits", "n_orbitals", "n_electrons", "multiplicity",
                  "nuclear_repulsion", "hf_energy", "fci_energy", "basis"):
            assert getattr(a, k) == getattr(mol, k), k
    assert a.n_qubits == 26 and (a.n_alpha_electrons, a.n_beta_electrons) == (5, 5)


def test_hdf5_without_h5py_names_the_npz_route(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="npz"):
        nt.load_molecule(H2O_631G_DIR)


@pytest.mark.parametrize("sectors,n_qubits", [
    (((5, 5),), 14), (((5, 3), (4, 4), (3, 5)), 14), (((2, 1),), 12)])
def test_hilbert_matches_jax(sectors, n_qubits):
    hj = nq.Hilbert(n_qubits=n_qubits, sectors=sectors)
    ht = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    assert ht.size == hj.size and ht.n_shells == hj.n_shells
    np.testing.assert_array_equal(ht.basis, hj.basis.astype(np.int64))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** n_qubits, size=2000)
    np.testing.assert_array_equal(ht.contains(x), hj.contains(x.astype(np.uint64)))
    assert ht.contains(ht.basis).all()


def test_hilbert_for_molecule_and_hf():
    c = case("H2O")
    assert c.h_t.sectors == c.h_j.sectors
    assert c.h_t.hf_state() == int(c.h_j.hf_state())


def test_entry_points_refuse_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_pulls_in_neither_jax_nor_naqs_tpu():
    code = (
        "import sys, pkgutil, importlib, naqs_tpu_torch\n"
        "for m in pkgutil.walk_packages(naqs_tpu_torch.__path__, 'naqs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from naqs_tpu_torch import cli\n"
        "from naqs_tpu_torch.utils import plotting, profiling\n"
        "cli.get_parser().parse_args([])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'naqs_tpu' or m.startswith('naqs_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_or_naqs_tpu_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "naqs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "naqs_tpu", "flax", "optax", "msgpack"), \
                (path, mod)


def test_bit_helpers_match_jax():
    from naqs_tpu.utils import bits as bits_j
    from naqs_tpu_torch.utils import bits as bits_t

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 62, size=500), [0, bits_t.SENTINEL]])
    want = bits_j.np_parity_pm1(x.astype(np.uint64))
    np.testing.assert_array_equal(bits_t.np_parity_pm1(x), want)
    np.testing.assert_array_equal(bits_t.parity_pm1(torch.as_tensor(x)).numpy(), want)
    b = bits_t.np_unpack_bits(x[:-1], 62)
    np.testing.assert_array_equal(b, bits_j.np_unpack_bits(x[:-1].astype(np.uint64), 62))
    np.testing.assert_array_equal(bits_t.np_pack_bits(b), x[:-1])
    tb = bits_t.unpack_bits(torch.as_tensor(x[:-1]), 62)
    np.testing.assert_array_equal(tb.numpy(), b)
    np.testing.assert_array_equal(bits_t.pack_bits(tb).numpy(), x[:-1])
