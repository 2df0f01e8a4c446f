"""Molecule data: the `Molecule` record and its loaders.

The port's native format is a flat `.npz` of the OpenFermion MolecularData
fields (scalars and integral arrays), because the machines that run the port
need not have h5py. An `.hdf5` molecule folder in the stored-data layout is
still read where h5py imports; `save_molecule_npz` converts one. The qubit
Hamiltonian is rebuilt from the integrals by `naqs_tpu_torch.jw`; a pickled
OpenFermion QubitOperator of the stored-data layout loads, without
OpenFermion, through `load_qubit_hamiltonian_pickle`.
"""

from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Tuple

import numpy as np

PauliTermDict = Dict[Tuple[Tuple[int, str], ...], complex]

# molecules shipped inside the package (`<name>.npz`)
DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

_SCALARS = {
    "name": str, "basis": str, "n_qubits": int, "n_orbitals": int,
    "n_electrons": int, "multiplicity": int, "nuclear_repulsion": float,
    "hf_energy": float, "mp2_energy": float, "cisd_energy": float,
    "ccsd_energy": float, "fci_energy": float,
}
_ARRAYS = ("one_body_integrals", "two_body_integrals", "orbital_energies")


@dataclass
class Molecule:
    """Molecular data needed for a VMC run (subset of OpenFermion MolecularData)."""

    name: str = ""
    basis: str = ""
    n_qubits: int = 0
    n_orbitals: int = 0
    n_electrons: int = 0
    multiplicity: int = 1
    nuclear_repulsion: float = 0.0
    hf_energy: Optional[float] = None
    mp2_energy: Optional[float] = None
    cisd_energy: Optional[float] = None
    ccsd_energy: Optional[float] = None
    fci_energy: Optional[float] = None
    one_body_integrals: Optional[np.ndarray] = None
    two_body_integrals: Optional[np.ndarray] = None
    orbital_energies: Optional[np.ndarray] = None
    qubit_hamiltonian: Optional[PauliTermDict] = field(default=None, repr=False)

    @property
    def n_alpha_electrons(self) -> int:
        # multiplicity = 2S + 1 and n_alpha - n_beta = 2S
        return (self.n_electrons + self.multiplicity - 1) // 2

    @property
    def n_beta_electrons(self) -> int:
        return (self.n_electrons - self.multiplicity + 1) // 2


class _QubitOperatorShim:
    """Stand-in for openfermion's QubitOperator while unpickling: only its
    `.terms` dict (Pauli-string tuple -> coefficient) is read."""

    terms: PauliTermDict


# a pickle from a data directory is untrusted: only these classes may be
# rebuilt (a plain Unpickler runs any __reduce__ gadget it is given)
_SAFE_CLASSES = {
    ("builtins", "complex"): complex,
    ("builtins", "float"): float,
    ("builtins", "int"): int,
    ("builtins", "dict"): dict,
    ("builtins", "tuple"): tuple,
    ("builtins", "list"): list,
    ("builtins", "str"): str,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "set"): set,
}
_SAFE_NUMPY = {"ndarray", "dtype", "_reconstruct", "scalar", "float64", "complex128", "int64"}


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # noqa: D102
        if name == "QubitOperator" and module.startswith("openfermion"):
            return _QubitOperatorShim
        if (module, name) in _SAFE_CLASSES:
            return _SAFE_CLASSES[(module, name)]
        if module.startswith("numpy") and name in _SAFE_NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from untrusted molecule data")


def load_qubit_hamiltonian_pickle(path: str) -> PauliTermDict:
    """The term dict of a pickled (OpenFermion) qubit operator."""
    with open(path, "rb") as f:
        op = _ShimUnpickler(io.BytesIO(f.read())).load()
    return {k: complex(v) for k, v in op.terms.items()}


def _scalar(val, cast):
    if val is None:
        return None
    val = np.asarray(val)[()]
    if isinstance(val, (bool, np.bool_)):  # OpenFermion writes False for absent
        return None
    if isinstance(val, bytes):
        val = val.decode()
    return cast(val)


def molecule_from_fields(d: dict, load_hamiltonian: bool = True) -> Molecule:
    """Build a Molecule from a field dict (the layout of an `.npz`/`.hdf5`,
    or the dict `naqs_tpu.chem.generate.generate_molecule_data` returns)."""
    kw = {k: _scalar(d.get(k), cast) for k, cast in _SCALARS.items()}
    kw = {k: v for k, v in kw.items() if v is not None}
    for k in _ARRAYS:
        if d.get(k) is not None:
            kw[k] = np.asarray(d[k], dtype=np.float64)
    mol = Molecule(**kw)
    if load_hamiltonian and mol.one_body_integrals is not None:
        from naqs_tpu_torch.jw import jordan_wigner_from_integrals

        mol.qubit_hamiltonian = jordan_wigner_from_integrals(
            mol.one_body_integrals, mol.two_body_integrals,
            mol.nuclear_repulsion)
    return mol


def save_molecule_npz(mol: Molecule, path: str) -> str:
    """Write the port-native `.npz` (every field but the qubit Hamiltonian)."""
    out = {}
    for f in fields(Molecule):
        val = getattr(mol, f.name)
        if f.name == "qubit_hamiltonian" or val is None:
            continue
        out[f.name] = np.asarray(val)
    np.savez_compressed(path, **out)
    return path


def _read_hdf5(path: str) -> dict:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs h5py, which is not installed; convert the "
            "folder once to the port's .npz format with "
            "naqs_tpu_torch.utils.molecule.save_molecule_npz and load that"
        ) from e
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in (*_SCALARS, *_ARRAYS) if k in f}


def _resolve(name_or_path: str) -> str:
    """Path of the `.npz`/`.hdf5` file a molecule name or path refers to."""
    if os.path.isfile(name_or_path):
        return name_or_path
    if os.path.isdir(name_or_path):
        base = os.path.basename(os.path.normpath(name_or_path))
        for ext in (".npz", ".hdf5"):
            cand = os.path.join(name_or_path, base + ext)
            if os.path.exists(cand):
                return cand
        cands = sorted(p for p in os.listdir(name_or_path)
                       if p.endswith((".npz", ".hdf5")))
        if cands:
            return os.path.join(name_or_path, cands[0])
    roots = [os.environ.get("NAQS_TPU_MOLECULE_DIR", ""), DATA_DIR]
    for root in filter(None, roots):
        cand = os.path.join(root, name_or_path + ".npz")
        if os.path.exists(cand):
            return cand
        folder = os.path.join(root, name_or_path)
        if os.path.isdir(folder):
            return _resolve(folder)
    raise FileNotFoundError(
        f"molecule '{name_or_path}' not found (searched {roots})")


def load_molecule(name_or_path: str, load_hamiltonian: bool = True,
                  hamiltonian_fname: str | None = None) -> Molecule:
    """Load a molecule by name (package data, then NAQS_TPU_MOLECULE_DIR) or
    by path to an `.npz`, an `.hdf5`, or a folder holding either.
    `hamiltonian_fname` names a pickled qubit Hamiltonian to use instead of
    the Jordan-Wigner transform of the integrals."""
    path = _resolve(name_or_path)
    if path.endswith(".hdf5"):
        d = _read_hdf5(path)
    else:
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
    d.setdefault("name", os.path.splitext(os.path.basename(path))[0])
    pickled = load_hamiltonian and hamiltonian_fname is not None
    mol = molecule_from_fields(d, load_hamiltonian=load_hamiltonian and not pickled)
    if pickled:
        mol.qubit_hamiltonian = load_qubit_hamiltonian_pickle(hamiltonian_fname)
    return mol
