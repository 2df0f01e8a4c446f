"""Molecule-data generation: geometry -> a trainable molecule `.npz`.

Port of `naqs_tpu/chem/generate.py`, the chain

    chem.basis (STO-3G refit, or a tabulated set) -> chem.integrals
    (McMurchie-Davidson; the ERIs by the card's kernel) -> chem.scf (DIIS
    RHF, or Guest-Saunders ROHF for multiplicity > 1, + MO transform + MP2)
    -> chem.cc (spin-orbital CCSD, closed and open shell)
    -> CISD + FCI baselines by exact sector diagonalization of the port's
       Jordan-Wigner Hamiltonian (naqs_tpu_torch.jw, scipy eigsh on the host)
       where the sector is small enough
    -> `<out>/<basename>.npz`, the port's native molecule format (the card's
       machine has no h5py), which `naqs_tpu_torch.load_molecule(out)` reads.

The SCF and CCSD run on the device (the CUDA card unless `device`, or the
CLI's `-platform`, names another); the returned dict keeps the JAX package's
layout: numpy arrays and Python floats.

Usage:
    python -m naqs_tpu_torch.chem.generate --atoms H H --positions 0 0 0 0 0 0.7414 \\
        --out molecules/MyH2
    python -m naqs_tpu_torch.chem.generate --xyz water.xyz --basis 6-31g --out molecules/MyH2O
    python -m naqs_tpu_torch.cli -m molecules/MyH2 ...      # train on it
"""

from __future__ import annotations

import argparse
import os
from math import comb
from typing import List, Optional, Sequence

import numpy as np

from naqs_tpu_torch.utils.device import resolve_device

# a sector above this many states is diagonalized through a LinearOperator
# over CSR row blocks, not one CSR matrix (the JAX package's switch)
LINEAR_OPERATOR_STATES = 400_000


def _sector_e0(terms, n_qubits: int, n_a: int, n_b: int, n_exc_max=None) -> float:
    """Lowest eigenvalue of H restricted to the (n_a, n_b) sector, at most
    n_exc_max excitations (None: the whole sector)."""
    from scipy.sparse.linalg import eigsh

    from naqs_tpu_torch.hamiltonian import (
        assemble_sparse_hamiltonian_np, hamiltonian_linear_operator)
    from naqs_tpu_torch.utils.hilbert import Hilbert

    basis = Hilbert(n_qubits=n_qubits, sectors=((n_a, n_b),), n_exc_max=n_exc_max).basis
    if len(basis) > LINEAR_OPERATOR_STATES:
        return float(eigsh(hamiltonian_linear_operator(terms, basis), k=1, which="SA")[0][0])
    H = assemble_sparse_hamiltonian_np(terms, basis)
    if H.shape[0] < 3:
        return float(np.linalg.eigvalsh(H.toarray())[0])
    return float(eigsh(H, k=1, which="SA")[0][0])


def generate_molecule_data(
    symbols: Sequence[str],
    positions_angstrom: np.ndarray,
    charge: int = 0,
    multiplicity: int = 1,
    name: Optional[str] = None,
    do_fci: bool = True,
    fci_max_states: int = 2_000_000,
    basis_name: str = "sto-3g",
    device=None,
) -> dict:
    """Run the full pipeline on the device; returns the molecule's fields
    (numpy arrays and Python floats, the JAX package's layout), which
    `utils/molecule.molecule_from_fields` takes as they are."""
    from naqs_tpu_torch.chem.cc import ccsd
    from naqs_tpu_torch.chem.scf import rhf, rohf

    dev = resolve_device(device)
    positions_angstrom = np.asarray(positions_angstrom, dtype=np.float64)
    if multiplicity == 1:
        r = rhf(symbols, positions_angstrom, charge=charge, basis_name=basis_name, device=dev)
    else:
        # open shell: Guest-Saunders ROHF, one spatial-orbital set, so the
        # JW mapping below is unchanged
        r = rohf(symbols, positions_angstrom, charge=charge, multiplicity=multiplicity,
                 basis_name=basis_name, device=dev)
    one_body = r.one_body_mo.cpu().numpy()
    two_body = r.two_body_mo.cpu().numpy()
    n_orbitals = one_body.shape[0]
    n_qubits = 2 * n_orbitals
    out = {
        "name": name or "".join(symbols),
        "basis": basis_name,
        "n_qubits": n_qubits,
        "n_orbitals": n_orbitals,
        "n_electrons": r.n_electrons,
        "multiplicity": multiplicity,
        "nuclear_repulsion": r.e_nuc,
        "hf_energy": r.e_hf,
        # ROHF MP2 is not uniquely defined; omitted for open shell
        "mp2_energy": r.e_mp2 if multiplicity == 1 else None,
        "orbital_energies": r.orbital_energies.cpu().numpy(),
        "one_body_integrals": one_body,
        "two_body_integrals": two_body,
        "symbols": list(symbols),
        "positions": positions_angstrom,
    }

    cc = ccsd(r, device=dev)
    if cc.converged:
        out["ccsd_energy"] = cc.e_ccsd
    else:
        print("(CCSD did not converge; omitting ccsd_energy)")

    if do_fci:
        if multiplicity == 1:
            n_a = n_b = r.n_electrons // 2
        else:
            # the max-m_s sector holds the multiplet ground state
            n_a, n_b = r.n_alpha, r.n_beta
        sector = comb(n_orbitals, n_a) * comb(n_orbitals, n_b)
        if sector <= fci_max_states:
            from naqs_tpu_torch.hamiltonian import compile_pauli_terms
            from naqs_tpu_torch.jw import jordan_wigner_from_integrals

            terms = compile_pauli_terms(
                jordan_wigner_from_integrals(one_body, two_body, r.e_nuc), n_qubits)
            # CISD = ground state of H restricted to HF + singles + doubles
            out["cisd_energy"] = _sector_e0(terms, n_qubits, n_a, n_b, n_exc_max=2)
            out["fci_energy"] = _sector_e0(terms, n_qubits, n_a, n_b)
        else:
            print(f"(sector has {sector:.3g} states > {fci_max_states}; "
                  "skipping FCI baseline)")
    return out


def write_molecule_dir(data: dict, out_dir: str) -> str:
    """Write `<out_dir>/<basename>.npz`: the fields the JAX package's hdf5
    holds, the geometry under `geometry/atoms` / `geometry/positions` (keys
    that `load_molecule` ignores)."""
    os.makedirs(out_dir, exist_ok=True)
    mol_name = os.path.basename(os.path.normpath(out_dir))
    path = os.path.join(out_dir, f"{mol_name}.npz")
    fields = {"name": np.str_(data["name"]), "basis": np.str_(data["basis"])}
    for k in ("n_qubits", "n_orbitals", "n_electrons", "multiplicity"):
        fields[k] = np.int64(data[k])
    fields["nuclear_repulsion"] = np.float64(data["nuclear_repulsion"])
    for k in ("hf_energy", "mp2_energy", "cisd_energy", "ccsd_energy", "fci_energy"):
        if data.get(k) is not None:
            fields[k] = np.float64(data[k])
    for k in ("orbital_energies", "one_body_integrals", "two_body_integrals"):
        fields[k] = np.asarray(data[k], dtype=np.float64)
    fields["geometry/atoms"] = np.asarray(data["symbols"], dtype=np.str_)
    fields["geometry/positions"] = np.asarray(data["positions"], dtype=np.float64)
    np.savez_compressed(path, **fields)
    return path


def _read_xyz(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    try:
        n = int(lines[0])
        body = lines[2:2 + n]  # standard xyz: count, comment, atoms
    except ValueError:
        body = lines  # bare "<sym> x y z" lines
    symbols: List[str] = []
    pos = []
    for ln in body:
        parts = ln.split()
        symbols.append(parts[0])
        pos.append([float(x) for x in parts[1:4]])
    return symbols, np.asarray(pos)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Generate a trainable molecule .npz from a geometry.")
    p.add_argument("--atoms", nargs="+", help="element symbols")
    p.add_argument("--positions", nargs="+", type=float,
                   help="flat x y z per atom, in Angstrom")
    p.add_argument("--xyz", help="read geometry from an .xyz file instead")
    p.add_argument("--charge", type=int, default=0)
    p.add_argument("--multiplicity", type=int, default=1,
                   help="2S+1; >1 selects the ROHF open-shell path")
    p.add_argument("--name", default=None)
    p.add_argument("--basis", default="sto-3g",
                   help="sto-3g (reconstructed), or an explicitly-tabulated "
                        "set: 6-31g, cc-pvdz, cc-pvtz (chem/basis.py "
                        "EXPLICIT_BASES)")
    p.add_argument("--out", required=True, help="output molecule folder")
    p.add_argument("--no-fci", action="store_true",
                   help="skip the exact-diagonalization FCI baseline")
    p.add_argument("--fci-max-states", type=int, default=2_000_000)
    p.add_argument("-platform", default=None,
                   help="torch device to run on (default: the CUDA card; 'cpu' to "
                        "run on the CPU)")
    args = p.parse_args(argv)

    if args.xyz:
        symbols, pos = _read_xyz(args.xyz)
    else:
        if not args.atoms or not args.positions:
            p.error("provide --xyz or both --atoms and --positions")
        if len(args.positions) != 3 * len(args.atoms):
            p.error("--positions must supply x y z per atom")
        symbols = args.atoms
        pos = np.asarray(args.positions, dtype=np.float64).reshape(-1, 3)

    data = generate_molecule_data(
        symbols, pos, charge=args.charge, multiplicity=args.multiplicity,
        name=args.name, basis_name=args.basis,
        do_fci=not args.no_fci, fci_max_states=args.fci_max_states,
        device=args.platform)
    path = write_molecule_dir(data, args.out)
    print(f"wrote {path}")
    print(f"  HF  = {data['hf_energy']:.6f} Ha")
    if data.get("mp2_energy") is not None:
        print(f"  MP2 = {data['mp2_energy']:.6f} Ha")
    if data.get("ccsd_energy") is not None:
        print(f"  CCSD= {data['ccsd_energy']:.6f} Ha")
    if data.get("fci_energy") is not None:
        print(f"  FCI = {data['fci_energy']:.6f} Ha")
    return path


if __name__ == "__main__":
    main()
