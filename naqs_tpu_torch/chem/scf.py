"""Restricted Hartree-Fock (closed shell) and ROHF, then the MO integrals.

Port of `naqs_tpu/chem/scf.py`. Given a geometry it builds the basis
(`chem/basis.py`, host), the AO integrals (`chem/integrals.py`: the ERIs by
the card's kernel), and runs the SCF as float64 torch operations on the
device: Fock builds, the DIIS B matrix and its solve, `eigh`, the AO -> MO
transform and MP2. It returns the canonical orbitals, the MO-basis
one_body_integrals / two_body_integrals in the stored-data layout
(physicist index order h2[p,q,r,s] = (ps|qr) in chemist notation), the HF
and MP2 energies. `RHFResult` holds float64 tensors on the device.

The SCF loop reads two numbers back a step (the energy change and the
largest commutator entry, the JAX package's convergence test), so it ends on
the same iteration as the JAX package's unless a sum in another order moves
one of them across its threshold. A DIIS solve whose LU finds B singular
(`torch.linalg.solve_ex`'s info) keeps the undamped Fock, as the JAX package
does on numpy's LinAlgError. The seeded guesses draw their perturbation from
`np.random.default_rng(0)` on the host, as the JAX package does, and move it
to the device.

MO coefficients are fixed only up to a sign per orbital (and a rotation
inside a degenerate set): the card's `eigh` may pick others than LAPACK's,
which leaves every energy unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from naqs_tpu_torch.chem.basis import ATOMIC_NUMBER, build_basis
from naqs_tpu_torch.chem.integrals import (
    ANGSTROM_TO_BOHR, build_integrals, nuclear_repulsion, spherical_d_transform)
from naqs_tpu_torch.utils.device import resolve_device


@dataclass
class RHFResult:
    e_hf: float
    e_nuc: float
    mo_coeff: torch.Tensor        # (n_ao, n_mo) columns = canonical orbitals
    orbital_energies: torch.Tensor
    one_body_mo: torch.Tensor     # (n_mo, n_mo) spatial h_pq
    two_body_mo: torch.Tensor     # (n_mo,)*4, h2[p,q,r,s] = (ps|qr)_chem
    e_mp2: float
    n_electrons: int
    multiplicity: int = 1
    n_alpha: int = 0              # filled for open shell (rohf)
    n_beta: int = 0


def _jk(g, dm):
    """(J, K) of a density: J_pq = (pq|rs) D_rs, K_pq = (pr|qs) D_rs."""
    return (torch.einsum("pqrs,rs->pq", g, dm), torch.einsum("prqs,rs->pq", g, dm))


def _fock(h_core, g, dm):
    """The closed-shell Fock matrix of the total density dm."""
    j, k = _jk(g, dm)
    return h_core + j - 0.5 * k


def _diis(errs, focks):
    """The DIIS extrapolation of `focks` (or None where B is singular)."""
    m = len(errs)
    e = torch.stack(errs).reshape(m, -1)
    b = -torch.ones((m + 1, m + 1), dtype=e.dtype, device=e.device)
    b[m, m] = 0.0
    b[:m, :m] = e @ e.T
    rhs = torch.zeros(m + 1, dtype=e.dtype, device=e.device)
    rhs[m] = -1.0
    w, info = torch.linalg.solve_ex(b, rhs)
    if int(info) != 0:
        return None
    return torch.einsum("m,mpq->pq", w[:m], torch.stack(focks))


def _scf_loop(h_core, g, x, s_mat, n_occ, f0, max_iter, conv, diis_len,
              n_damped=12):
    """One SCF attempt from initial Fock f0: damped warm-up then DIIS.
    Returns (e_el, dm) or None if not converged."""
    f = f0
    errs: List[torch.Tensor] = []
    focks: List[torch.Tensor] = []
    e_old = 0.0
    for it in range(max_iter):
        _eps, c_ortho = torch.linalg.eigh(x.T @ f @ x)
        c = x @ c_ortho
        c_occ = c[:, :n_occ]
        dm = 2.0 * c_occ @ c_occ.T
        f_new = _fock(h_core, g, dm)
        e_el = float(0.5 * torch.sum(dm * (h_core + f_new)))
        err = x.T @ (f_new @ dm @ s_mat - s_mat @ dm @ f_new) @ x
        if it < n_damped:
            # plain damping first: DIIS from the core guess can lock onto
            # aufbau saddles (N2 sto-3g stalls 0.71 Ha high)
            f = 0.5 * f + 0.5 * f_new
            e_old = e_el
            continue
        errs.append(err)
        focks.append(f_new.clone())
        if len(errs) > diis_len:
            errs.pop(0)
            focks.pop(0)
        f = f_new
        if len(errs) >= 2:
            ext = _diis(errs, focks)
            if ext is not None:
                f = ext
        if abs(e_el - e_old) < conv and float(err.abs().max()) < 1e-8:
            return e_el, dm
        e_old = e_el
    return None


def _to_spherical(basis, s_mat, t_mat, v_mat, g):
    """Reduce cartesian-d AO integrals to the real-spherical AO space
    (integrals.spherical_d_transform); no-op for pure s/p bases."""
    t = spherical_d_transform(basis)
    if t is None:
        return s_mat, t_mat, v_mat, g
    t = torch.from_numpy(t).to(s_mat.device)
    s_mat = t @ s_mat @ t.T
    t_mat = t @ t_mat @ t.T
    v_mat = t @ v_mat @ t.T
    return s_mat, t_mat, v_mat, _mo_transform(g, t.T)


def _mo_transform(g, c):
    """(pq|rs) -> sum c_pa c_qb c_rc c_sd (pq|rs), one index at a time."""
    g = torch.einsum("pqrs,pa->aqrs", g, c)
    g = torch.einsum("aqrs,qb->abrs", g, c)
    g = torch.einsum("abrs,rc->abcs", g, c)
    return torch.einsum("abcs,sd->abcd", g, c)


def _setup(symbols, positions_angstrom, basis_name, device):
    """(S, ERI, h_core, E_nn, x) on the device: the spherical AO integrals,
    the nuclear repulsion and the Loewdin orthogonalizer x."""
    dev = resolve_device(device)
    centers = np.asarray(positions_angstrom, dtype=np.float64) * ANGSTROM_TO_BOHR
    charges = [float(ATOMIC_NUMBER[s]) for s in symbols]
    basis = build_basis(symbols, centers, basis_name)
    s_mat, t_mat, v_mat, g = build_integrals(basis, charges, centers, device=dev)
    s_mat, t_mat, v_mat, g = _to_spherical(basis, s_mat, t_mat, v_mat, g)
    h_core = t_mat + v_mat
    e_nuc = nuclear_repulsion(charges, centers)
    # symmetric (Loewdin) orthogonalization
    s_val, s_vec = torch.linalg.eigh(s_mat)
    x = s_vec @ torch.diag(s_val ** -0.5) @ s_vec.T
    return s_mat, g, h_core, e_nuc, x


def _perturbation(rng, h_core):
    """A seeded symmetric perturbation of the core Hamiltonian, drawn on the
    host as the JAX package draws it, moved to h_core's device."""
    scale = float(h_core.abs().max())
    pert = rng.normal(size=tuple(h_core.shape)) * (2e-2 * scale)
    return torch.from_numpy(0.5 * (pert + pert.T)).to(h_core.device)


def rhf(
    symbols: Sequence[str],
    positions_angstrom: np.ndarray,
    charge: int = 0,
    max_iter: int = 300,
    conv: float = 1e-11,
    diis_len: int = 8,
    n_guesses: int = 3,
    basis_name: str = "sto-3g",
    device=None,
) -> RHFResult:
    """Closed-shell RHF with DIIS, then the MO-basis integral transform, on
    the device (the CUDA card unless `device` names another).

    Multiple initial guesses (core Hamiltonian + seeded symmetry-breaking
    perturbations) are converged and the lowest SCF solution kept: the
    bare core guess can converge onto an aufbau saddle for systems with
    near-degenerate valence shells (N2 sto-3g sits 0.71 Ha high there).
    """
    charges = [float(ATOMIC_NUMBER[s]) for s in symbols]
    n_elec = int(sum(charges)) - charge
    if n_elec % 2:
        raise ValueError("rhf() handles closed shells only (even electrons)")
    n_occ = n_elec // 2
    s_mat, g, h_core, e_nuc, x = _setup(symbols, positions_angstrom, basis_name, device)

    best = None
    rng = np.random.default_rng(0)
    for attempt in range(n_guesses):
        f0 = h_core.clone()
        if attempt > 0:
            f0 = f0 + _perturbation(rng, h_core)
        got = _scf_loop(h_core, g, x, s_mat, n_occ, f0, max_iter, conv, diis_len)
        if got is not None and (best is None or got[0] < best[0] - 1e-10):
            best = got
    if best is None:
        raise RuntimeError("RHF did not converge from any initial guess")
    _e_el, dm = best

    # final canonical orbitals from the converged Fock
    eps, c_ortho = torch.linalg.eigh(x.T @ _fock(h_core, g, dm) @ x)
    c = x @ c_ortho
    dm = 2.0 * c[:, :n_occ] @ c[:, :n_occ].T
    e_hf = float(0.5 * torch.sum(dm * (h_core + _fock(h_core, g, dm)))) + e_nuc

    h1 = c.T @ h_core @ c
    eri_mo = _mo_transform(g, c)
    # OpenFermion MolecularData layout: h2[p,q,r,s] = <pq|sr> physicist
    #                                              = (ps|qr) chemist
    two_body = eri_mo.permute(0, 2, 3, 1).contiguous()

    # closed-shell MP2 from spatial MO ERIs
    n_mo = h1.shape[0]
    occ, vir = slice(0, n_occ), slice(n_occ, n_mo)
    ov = eri_mo[occ, vir, occ, vir]  # (ia|jb) chemist
    denom = (eps[occ, None, None, None] - eps[None, vir, None, None]
             + eps[None, None, occ, None] - eps[None, None, None, vir])
    e_mp2 = float(torch.sum(ov * (2 * ov - ov.transpose(1, 3)) / denom))

    return RHFResult(
        e_hf=float(e_hf), e_nuc=float(e_nuc), mo_coeff=c,
        orbital_energies=eps, one_body_mo=h1, two_body_mo=two_body,
        e_mp2=float(e_hf + e_mp2), n_electrons=n_elec,
    )


def rohf(
    symbols: Sequence[str],
    positions_angstrom: np.ndarray,
    charge: int = 0,
    multiplicity: int = 3,
    max_iter: int = 400,
    conv: float = 1e-11,
    diis_len: int = 8,
    n_guesses: int = 3,
    basis_name: str = "sto-3g",
    device=None,
) -> RHFResult:
    """Restricted open-shell HF (Guest-Saunders effective Fock) + MO
    transform, on the device (the CUDA card unless `device` names another).

    One spatial-orbital set for both spins (like Psi4's ROHF), so the MO
    integrals drop into the same JW mapping as the closed-shell path; the
    open-shell (alpha-only) orbitals are the n_alpha-n_beta highest
    occupied. DIIS on the effective-Fock commutator; the core guess first,
    seeded perturbed guesses only where it does not converge.
    """
    charges = [float(ATOMIC_NUMBER[s]) for s in symbols]
    n_elec = int(sum(charges)) - charge
    n_open = multiplicity - 1
    if (n_elec - n_open) % 2:
        raise ValueError("electron count inconsistent with multiplicity")
    n_beta = (n_elec - n_open) // 2
    n_alpha = n_beta + n_open
    s_mat, g, h_core, e_nuc, x = _setup(symbols, positions_angstrom, basis_name, device)
    n_ao = h_core.shape[0]

    def spin_focks(c):
        ca, cb = c[:, :n_alpha], c[:, :n_beta]
        da, db = ca @ ca.T, cb @ cb.T
        ja, ka = _jk(g, da)
        jb, kb = _jk(g, db)
        return da, db, h_core + ja + jb - ka, h_core + ja + jb - kb

    def run_attempt(f0):
        """Returns (e_hf_electronic, c) or None."""
        _, c_o = torch.linalg.eigh(x.T @ f0 @ x)
        c = x @ c_o
        errs, focks = [], []
        e_old, f_eff_prev = 0.0, None
        for it in range(max_iter):
            da, db, fa, fb = spin_focks(c)
            e_el = float(0.5 * (torch.sum((da + db) * h_core)
                                + torch.sum(da * fa) + torch.sum(db * fb)))

            # Guest-Saunders effective Fock in the current MO basis
            fa_mo = c.T @ fa @ c
            fb_mo = c.T @ fb @ c
            f_eff = 0.5 * (fa_mo + fb_mo)
            cl = slice(0, n_beta)            # closed (doubly occupied)
            op = slice(n_beta, n_alpha)      # open (alpha only)
            vt = slice(n_alpha, n_ao)        # virtual
            f_eff[cl, op] = fb_mo[cl, op]
            f_eff[op, cl] = fb_mo[op, cl]
            f_eff[op, vt] = fa_mo[op, vt]
            f_eff[vt, op] = fa_mo[vt, op]
            # back to AO (via S c): F_ao = S c F_mo c^T S
            f_ao = s_mat @ c @ f_eff @ c.T @ s_mat

            err = x.T @ (f_ao @ (da + db) @ s_mat
                         - s_mat @ (da + db) @ f_ao) @ x
            errs.append(err)
            focks.append(f_ao.clone())
            if len(errs) > diis_len:
                errs.pop(0), focks.pop(0)
            f_use = f_ao
            if it >= 8 and len(errs) >= 2:
                ext = _diis(errs, focks)
                if ext is not None:
                    f_use = ext
            elif it < 8 and f_eff_prev is not None:
                f_use = 0.5 * f_use + 0.5 * f_eff_prev
            f_eff_prev = f_use
            _, c_o = torch.linalg.eigh(x.T @ f_use @ x)
            c = x @ c_o
            if abs(e_el - e_old) < conv and float(err.abs().max()) < 1e-8:
                return e_el, c
            e_old = e_el
        return None

    # the symmetry-adapted core-guess solution first (for degenerate open
    # shells, seeded perturbations converge onto a symmetry-broken ROHF a few
    # mHa lower); perturbed guesses only against non-convergence
    best = run_attempt(h_core.clone())
    if best is None:
        rng = np.random.default_rng(0)
        for _attempt in range(1, n_guesses):
            got = run_attempt(h_core + _perturbation(rng, h_core))
            if got is not None and (best is None or got[0] < best[0] - 1e-10):
                best = got
    if best is None:
        raise RuntimeError("ROHF did not converge from any initial guess")
    e_el, c = best
    e_hf = e_el + e_nuc

    # canonical-ish orbital energies: diagonal of the converged effective
    # Fock in its own eigenbasis (Psi4 reports the same GS canonicalization)
    _da, _db, fa, fb = spin_focks(c)
    eps = torch.diagonal(0.5 * c.T @ (fa + fb) @ c).clone()

    h1 = c.T @ h_core @ c
    two_body = _mo_transform(g, c).permute(0, 2, 3, 1).contiguous()

    return RHFResult(
        e_hf=float(e_hf), e_nuc=float(e_nuc), mo_coeff=c,
        orbital_energies=eps, one_body_mo=h1, two_body_mo=two_body,
        e_mp2=float("nan"), n_electrons=n_elec,
        multiplicity=multiplicity, n_alpha=n_alpha, n_beta=n_beta,
    )
