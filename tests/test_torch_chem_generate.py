"""The port's molecule generation against the JAX package's, on the CPU.

`naqs_tpu_torch.chem.generate.generate_molecule_data(..., device="cpu")`
against `naqs_tpu.chem.generate.generate_molecule_data` on the same
geometries: every energy (HF, MP2, CCSD, CISD, FCI) within 1e-8 Ha, the
orbital energies within 1e-9, the same sizes; the dict's layout (numpy
arrays and Python floats) goes into `molecule_from_fields` unchanged. The
port's command line writes `<out>/<basename>.npz`, which
`naqs_tpu_torch.load_molecule` reads back.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import naqs_tpu_torch as nt
from naqs_tpu.chem.generate import generate_molecule_data as generate_j
from naqs_tpu_torch.chem.generate import _read_xyz, generate_molecule_data, write_molecule_dir
from naqs_tpu_torch.utils.molecule import molecule_from_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "H2": (["H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7414]], 1),
    "LiH": (["Li", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 1.5949]], 1),
    "CH2": (["C", "H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.9911, 0.6040],
                              [0.0, -0.9911, 0.6040]], 3),
}
ENERGIES = ("hf_energy", "mp2_energy", "ccsd_energy", "cisd_energy", "fci_energy")


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_matches_jax(name):
    syms, pos, mult = CASES[name]
    want = generate_j(syms, np.asarray(pos), multiplicity=mult, name=name)
    got = generate_molecule_data(syms, np.asarray(pos), multiplicity=mult, name=name,
                                 device="cpu")
    assert set(got) == set(want)
    for k in ("name", "basis", "n_qubits", "n_orbitals", "n_electrons", "multiplicity",
              "symbols"):
        assert got[k] == want[k], k
    for k in ENERGIES:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert isinstance(got[k], float) and abs(got[k] - want[k]) < 1e-8, k
    assert abs(got["nuclear_repulsion"] - want["nuclear_repulsion"]) < 1e-12
    np.testing.assert_array_equal(got["positions"], want["positions"])
    for k in ("orbital_energies", "one_body_integrals", "two_body_integrals"):
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float64, k
        assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["orbital_energies"], want["orbital_energies"], rtol=0,
                               atol=1e-9)
    assert got["fci_energy"] <= got["cisd_energy"] + 1e-12 <= got["hf_energy"] + 2e-12
    mol = molecule_from_fields(got)
    assert mol.n_qubits == want["n_qubits"] and mol.fci_energy == got["fci_energy"]


def test_write_molecule_dir_round_trip(tmp_path):
    syms, pos, _ = CASES["H2"]
    data = generate_molecule_data(syms, np.asarray(pos), name="H2", device="cpu")
    out = os.path.join(tmp_path, "MyH2")
    path = write_molecule_dir(data, out)
    assert path == os.path.join(out, "MyH2.npz")
    with np.load(path, allow_pickle=False) as z:
        assert list(z["geometry/atoms"]) == ["H", "H"]
        np.testing.assert_array_equal(z["geometry/positions"], np.asarray(pos))
    mol = nt.load_molecule(out)
    assert mol.name == "H2" and mol.basis == "sto-3g" and mol.n_electrons == 2
    for k in ENERGIES:
        assert getattr(mol, k) == data[k], k
    np.testing.assert_array_equal(mol.two_body_integrals, data["two_body_integrals"])
    assert mol.qubit_hamiltonian


def test_read_xyz_both_layouts(tmp_path):
    std = os.path.join(tmp_path, "a.xyz")
    with open(std, "w") as f:
        f.write("2\nwater fragment\nO 0 0 0\nH 0 0.75 0.5\n")
    bare = os.path.join(tmp_path, "b.xyz")
    with open(bare, "w") as f:
        f.write("O 0 0 0\nH 0 0.75 0.5\n")
    for path in (std, bare):
        syms, pos = _read_xyz(path)
        assert syms == ["O", "H"]
        np.testing.assert_array_equal(pos, [[0, 0, 0], [0, 0.75, 0.5]])


def test_generate_cli_writes_an_npz_that_trains(tmp_path):
    """`python -m naqs_tpu_torch.chem.generate` on H2 with -platform cpu, in a
    fresh interpreter: the .npz loads, FCI < HF < 0, the energies are the JAX
    package's, and two trainer steps run on it."""
    out = os.path.join(tmp_path, "H2gen")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "naqs_tpu_torch.chem.generate", "--atoms", "H",
                        "H", "--positions", "0", "0", "0", "0", "0", "0.7414", "--out", out,
                        "-platform", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.join(out, "H2gen.npz") in r.stdout
    mol = nt.load_molecule(out)
    assert mol.fci_energy < mol.hf_energy < 0
    want = generate_j(["H", "H"], np.asarray(CASES["H2"][1]))
    for k in ENERGIES:
        assert abs(getattr(mol, k) - want[k]) < 1e-8, k
    hil = nt.Hilbert.for_molecule(mol)
    assert hil.size == 4
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits)
    cfg = nt.NAQSConfig(n_qubits=mol.n_qubits, sectors=hil.sectors, amp_hidden=(16,),
                        phase_hidden=(16,))
    tc = nt.TrainConfig(n_samples=1e3, n_unq_samples_min=4, n_unq_samples_max=64, seed=0)
    tr = nt.VMCTrainer(cfg, terms, hil, tc, device="cpu")
    for _ in range(2):
        assert np.isfinite(tr.step()["e_loc"])
