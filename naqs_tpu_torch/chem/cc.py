"""Spin-orbital CCSD from the MO integrals, closed and open shell.

Port of `naqs_tpu/chem/cc.py`: standard spin-orbital CCSD with the
Stanton-Gauss-Watts-Bartlett intermediates (J. Chem. Phys. 94, 4334 (1991)),
solved by iteration with DIIS extrapolation on the stacked (t1, t2)
residuals, as float64 torch contractions on the integrals' device (the
problem sizes are small: <= ~56 spin orbitals). Each iteration reads back
the residual norm and the energy for the JAX package's stopping test; a DIIS
solve whose LU finds B singular (`torch.linalg.solve_ex`'s info) keeps the
plain update, as the JAX package does on numpy's LinAlgError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from naqs_tpu_torch.utils.device import resolve_device


@dataclass
class CCSDResult:
    e_ccsd: float           # total energy (HF + correlation)
    e_corr: float           # CCSD correlation energy
    n_iter: int
    converged: bool
    t1: torch.Tensor        # (nocc_so, nvir_so) single amplitudes
    t2: torch.Tensor        # (nocc_so, nocc_so, nvir_so, nvir_so)


def _spin_orbital_integrals(one_body_mo, two_body_mo):
    """Spatial MO integrals -> spin-orbital h1 and antisymmetrized <pq||rs>.

    two_body_mo uses the stored-data (OpenFermion) layout
    h2[p,q,r,s] = <pq|sr>_phys = (ps|qr)_chem, so the physicist <pq|rs> is
    h2[p,q,s,r]. Spin orbitals are interleaved (2p = alpha, 2p+1 = beta) to
    match the JW qubit ordering used throughout the package.
    """
    n = one_body_mo.shape[0]
    n_so = 2 * n
    phys = two_body_mo.permute(0, 1, 3, 2)  # <pq|rs>_phys, spatial
    kw = dict(dtype=one_body_mo.dtype, device=one_body_mo.device)

    h1 = torch.zeros((n_so, n_so), **kw)
    h1[0::2, 0::2] = one_body_mo
    h1[1::2, 1::2] = one_body_mo

    # <PQ|RS> = <pq|rs> d(sP,sR) d(sQ,sS)
    eri = torch.zeros((n_so, n_so, n_so, n_so), **kw)
    for sp in (0, 1):
        for sq in (0, 1):
            eri[sp::2, sq::2, sp::2, sq::2] = phys
    anti = eri - eri.permute(0, 1, 3, 2)
    return h1, anti


def ccsd_from_integrals(
    one_body_mo: torch.Tensor,
    two_body_mo: torch.Tensor,
    n_electrons: int,
    e_hf: float,
    e_nuc: float,
    max_iter: int = 200,
    conv: float = 1e-9,
    diis_depth: int = 8,
    n_alpha: int = None,
    n_beta: int = None,
    device=None,
) -> CCSDResult:
    """Solve CCSD from spatial MO integrals (arrays or tensors) in the
    stored-data layout, in float64 on the device (the CUDA card unless
    `device` names another).

    For an open-shell (ROHF) reference pass n_alpha/n_beta: the occupied
    spin orbitals are then alpha 0..n_alpha-1 and beta 0..n_beta-1 (spatial
    indices) rather than the lowest n_electrons interleaved indices. The
    spin-orbital equations keep the full non-canonical Fock (off-diagonal
    occ-occ/virt-virt blocks enter through the Fae/Fmi intermediates and
    f_ov enters T1), so the energy is the standard ROHF-CCSD.
    """
    dev = resolve_device(device)
    h1, g = _spin_orbital_integrals(
        *(torch.as_tensor(a, dtype=torch.float64).to(dev) for a in (one_body_mo, two_body_mo)))
    n_so = h1.shape[0]
    no = n_electrons
    if n_alpha is not None or n_beta is not None:
        if n_alpha is None or n_beta is None or n_alpha + n_beta != n_electrons:
            raise ValueError(f"an open shell needs n_alpha + n_beta == n_electrons = "
                             f"{n_electrons}, got {n_alpha} and {n_beta}")
        occ_idx = np.sort(np.concatenate([2 * np.arange(n_alpha), 2 * np.arange(n_beta) + 1]))
        vir_idx = np.setdiff1d(np.arange(n_so), occ_idx)
        perm = torch.from_numpy(np.concatenate([occ_idx, vir_idx])).to(h1.device)
        h1 = h1[perm][:, perm]
        g = g[perm][:, perm][:, :, perm][:, :, :, perm]
    o, v = slice(0, no), slice(no, n_so)
    ein = torch.einsum

    # spin-orbital Fock matrix from the MO integrals; built explicitly
    # rather than from orbital_energies so the solver also accepts
    # non-canonical orbitals
    f = h1 + ein("piqi->pq", g[:, o, :, o])
    eps = torch.diagonal(f)
    d1 = eps[o, None] - eps[None, v]                      # (no, nv)
    d2 = (eps[o, None, None, None] + eps[None, o, None, None]
          - eps[None, None, v, None] - eps[None, None, None, v])

    f_ov = f[o, v]
    g_oovv = g[o, o, v, v]
    t1 = f_ov / d1
    t2 = g_oovv / d2
    e_mp2 = float(0.25 * ein("ijab,ijab->", g_oovv, t2))

    diis_t, diis_r = [], []

    def energy(t1, t2):
        tau = t2 + ein("ia,jb->ijab", t1, t1) - ein("ib,ja->ijab", t1, t1)
        return float(ein("ia,ia->", f_ov, t1) + 0.25 * ein("ijab,ijab->", g_oovv, tau))

    e_corr, converged, it = e_mp2, False, 0
    for it in range(1, max_iter + 1):
        t1t1 = ein("ia,jb->ijab", t1, t1) - ein("ib,ja->ijab", t1, t1)
        tau_t = t2 + 0.5 * t1t1
        tau = t2 + t1t1

        # --- Stanton intermediates
        Fae = (f[v, v] - torch.diag(torch.diagonal(f[v, v]))
               - 0.5 * ein("me,ma->ae", f_ov, t1)
               + ein("mf,mafe->ae", t1, g[o, v, v, v])
               - 0.5 * ein("mnaf,mnef->ae", tau_t, g_oovv))
        Fmi = (f[o, o] - torch.diag(torch.diagonal(f[o, o]))
               + 0.5 * ein("ie,me->mi", t1, f_ov)
               + ein("ne,mnie->mi", t1, g[o, o, o, v])
               + 0.5 * ein("inef,mnef->mi", tau_t, g_oovv))
        Fme = f_ov + ein("nf,mnef->me", t1, g_oovv)

        Wmnij = (g[o, o, o, o]
                 + ein("je,mnie->mnij", t1, g[o, o, o, v])
                 - ein("ie,mnje->mnij", t1, g[o, o, o, v])
                 + 0.25 * ein("ijef,mnef->mnij", tau, g_oovv))
        Wabef = (g[v, v, v, v]
                 - ein("mb,amef->abef", t1, g[v, o, v, v])
                 + ein("ma,bmef->abef", t1, g[v, o, v, v])
                 + 0.25 * ein("mnab,mnef->abef", tau, g_oovv))
        Wmbej = (g[o, v, v, o]
                 + ein("jf,mbef->mbej", t1, g[o, v, v, v])
                 - ein("nb,mnej->mbej", t1, g[o, o, v, o])
                 - ein("jnfb,mnef->mbej", 0.5 * t2 + ein("jf,nb->jnfb", t1, t1), g_oovv))

        # --- T1 equations
        rhs1 = (f_ov
                + ein("ie,ae->ia", t1, Fae)
                - ein("ma,mi->ia", t1, Fmi)
                + ein("imae,me->ia", t2, Fme)
                - ein("nf,naif->ia", t1, g[o, v, o, v])
                - 0.5 * ein("imef,maef->ia", t2, g[o, v, v, v])
                - 0.5 * ein("mnae,nmei->ia", t2, g[o, o, v, o]))
        t1_new = rhs1 / d1

        # --- T2 equations
        Fae_h = Fae - 0.5 * ein("mb,me->be", t1, Fme)
        Fmi_h = Fmi + 0.5 * ein("je,me->mj", t1, Fme)
        P_ab = ein("ijae,be->ijab", t2, Fae_h)
        P_ij = ein("imab,mj->ijab", t2, Fmi_h)
        rhs2 = (g_oovv
                + P_ab - P_ab.permute(0, 1, 3, 2)
                - P_ij + P_ij.permute(1, 0, 2, 3)
                + 0.5 * ein("mnab,mnij->ijab", tau, Wmnij)
                + 0.5 * ein("ijef,abef->ijab", tau, Wabef))
        P_mbej = (ein("imae,mbej->ijab", t2, Wmbej)
                  - ein("ie,ma,mbej->ijab", t1, t1, g[o, v, v, o]))
        P_mbej = (P_mbej - P_mbej.permute(0, 1, 3, 2) - P_mbej.permute(1, 0, 2, 3)
                  + P_mbej.permute(1, 0, 3, 2))
        rhs2 = rhs2 + P_mbej
        P_ie = ein("ie,abej->ijab", t1, g[v, v, v, o])
        rhs2 = rhs2 + P_ie - P_ie.permute(1, 0, 2, 3)
        P_ma = ein("ma,mbij->ijab", t1, g[o, v, o, o])
        rhs2 = rhs2 - P_ma + P_ma.permute(0, 1, 3, 2)
        t2_new = rhs2 / d2

        r1, r2 = t1_new - t1, t2_new - t2
        rnorm = float(torch.sqrt(torch.sum(r1 ** 2) + torch.sum(r2 ** 2)))

        # --- DIIS on the stacked amplitude vector
        diis_t.append(torch.cat([t1_new.reshape(-1), t2_new.reshape(-1)]))
        diis_r.append(torch.cat([r1.reshape(-1), r2.reshape(-1)]))
        if len(diis_t) > diis_depth:
            diis_t.pop(0), diis_r.pop(0)
        if len(diis_t) >= 2:
            k = len(diis_r)
            res = torch.stack(diis_r)
            B = torch.full((k + 1, k + 1), -1.0, dtype=res.dtype, device=res.device)
            B[-1, -1] = 0.0
            B[:k, :k] = res @ res.T
            rhs = torch.zeros(k + 1, dtype=res.dtype, device=res.device)
            rhs[-1] = -1.0
            c, info = torch.linalg.solve_ex(B, rhs)
            if int(info) == 0:
                ext = c[:k] @ torch.stack(diis_t)
                t1_new = ext[: t1.numel()].reshape(t1.shape)
                t2_new = ext[t1.numel():].reshape(t2.shape)

        t1, t2 = t1_new, t2_new
        e_new = energy(t1, t2)
        if rnorm < conv and abs(e_new - e_corr) < conv:
            e_corr, converged = e_new, True
            break
        e_corr = e_new

    return CCSDResult(
        e_ccsd=float(e_hf + e_corr), e_corr=float(e_corr),
        n_iter=it, converged=converged, t1=t1, t2=t2,
    )


def ccsd(rhf_result, device=None, **kw) -> CCSDResult:
    """CCSD from a chem.scf rhf/rohf result (open shell auto-detected), on
    the device (the CUDA card unless `device` names another)."""
    if getattr(rhf_result, "multiplicity", 1) > 1:
        kw.setdefault("n_alpha", rhf_result.n_alpha)
        kw.setdefault("n_beta", rhf_result.n_beta)
    return ccsd_from_integrals(
        rhf_result.one_body_mo, rhf_result.two_body_mo,
        rhf_result.n_electrons, rhf_result.e_hf, rhf_result.e_nuc, device=device, **kw)
