"""Basis sets: STO-3G rebuilt from first principles, and tabulated 6-31G,
cc-pVDZ and cc-pVTZ.

Port of `naqs_tpu/chem/basis.py`, host numpy and scipy as there (basis
construction is set-up, not device work). STO-3G is reconstructed the way it
was originally defined (Hehre, Stewart, Pople, J. Chem. Phys. 51, 2657
(1969)): least-squares expand normalized Slater-type orbitals of exponent
zeta = 1 in N = 3 Gaussians, sharing one exponent set between the 2s/2p (and
3s/3p) shells, then scale the universal exponents by zeta^2 per atom. The fit
maximizes the overlap <STO_nl | sum_i c_i g_i>; for fixed exponents the
optimal coefficients are c ~ S^-1 s, so only the 3 shared exponents are
optimized numerically (Nelder-Mead in log space), once per process
(`universal_expansion` is cached). The tabulated sets and the Slater
exponents are copied digit for digit from the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.integrate import quad
from scipy.optimize import minimize

from naqs_tpu_torch.chem.integrals import ContractedGaussian

# Standard STO-3G Slater exponents per element and shell (the "standard
# molecular set" of Hehre-Stewart-Pople; third row from Hehre, Ditchfield,
# Stewart, Pople, J. Chem. Phys. 52, 2769 (1970)).
ZETAS: Dict[str, Tuple[float, ...]] = {
    "H": (1.24,),
    "He": (1.69,),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.50),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "Na": (10.61, 3.48, 1.75),
    "Mg": (11.59, 3.72, 1.70),
    "Al": (12.56, 4.17, 1.70),
    "Si": (13.53, 4.66, 1.75),
    # S/P: fitted to the stored Psi4 H2S/PH3 HF and orbital energies (the
    # JAX package's values; the literature set misses those by ~0.13 Ha)
    "P": (14.725788, 5.290759, 1.909612),
    "S": (15.744713, 5.766814, 2.057648),
    "Cl": (16.43, 6.26, 2.10),
}

ATOMIC_NUMBER = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17,
}


def _sto_radial(n: int, r: np.ndarray) -> np.ndarray:
    """Normalized Slater radial function R_n(r) at zeta = 1:
    R_n = (2)^{n+1/2} / sqrt((2n)!) * r^{n-1} e^{-r}."""
    return 2.0 ** (n + 0.5) / np.sqrt(factorial(2 * n)) * r ** (n - 1) * np.exp(-r)


def _gauss_radial(l: int, alpha: float, r: np.ndarray) -> np.ndarray:
    """Normalized radial part of an l-type Gaussian: N r^l e^{-a r^2} with
    int N^2 r^{2l} e^{-2 a r^2} r^2 dr = 1."""
    # int_0^inf r^{2l+2} e^{-2 a r^2} dr = (2l+1)!! sqrt(pi) / (2^{l+2} (2a)^{l+1} sqrt(2a))
    dfact = 1.0
    for k in range(2 * l + 1, 0, -2):
        dfact *= k
    mom = dfact * np.sqrt(np.pi) / (2 ** (l + 2) * (2 * alpha) ** (l + 1)
                                    * np.sqrt(2 * alpha))
    return r ** l * np.exp(-alpha * r * r) / np.sqrt(mom)


def _sto_gauss_overlap(n: int, l: int, alpha: float) -> float:
    """<R_n STO | R_l gaussian> radial overlap (same angular part)."""
    val, _ = quad(
        lambda r: _sto_radial(n, r) * _gauss_radial(l, alpha, r) * r * r,
        0.0, 40.0, limit=200,
    )
    return val


def _shell_overlap_and_coeffs(n: int, l: int, alphas: np.ndarray):
    """Best-coefficient overlap of STO_nl with span{g_l(alpha_i)}."""
    m = len(alphas)
    s_vec = np.array([_sto_gauss_overlap(n, l, a) for a in alphas])
    s_mat = np.empty((m, m))
    for i in range(m):
        for j in range(m):
            # overlap of two normalized same-l gaussians: analytic
            ai, aj = alphas[i], alphas[j]
            s_mat[i, j] = (2.0 * np.sqrt(ai * aj) / (ai + aj)) ** (l + 1.5)
    c = np.linalg.solve(s_mat, s_vec)
    ov = float(np.sqrt(s_vec @ c))
    return ov, c / ov  # normalized contraction


@lru_cache(maxsize=None)
def universal_expansion(shell: str) -> Tuple[Tuple[float, ...], Dict[str, Tuple[float, ...]]]:
    """(exponents, {orbital: coeffs}) for shell in {"1s", "2sp", "3sp"},
    fit at zeta = 1. sp shells share exponents between s and p (the
    defining STO-3G constraint), maximizing the SUM of the two overlaps.
    """
    if shell == "1s":
        parts = [(1, 0, "1s")]
        x0 = np.log([2.2, 0.4, 0.1])
    elif shell == "2sp":
        parts = [(2, 0, "2s"), (2, 1, "2p")]
        x0 = np.log([1.0, 0.23, 0.075])
    elif shell == "3sp":
        parts = [(3, 0, "3s"), (3, 1, "3p")]
        x0 = np.log([0.45, 0.12, 0.05])
    else:
        raise ValueError(shell)

    def neg_total_overlap(logalphas):
        alphas = np.exp(logalphas)
        tot = 0.0
        for n, l, _ in parts:
            ov, _c = _shell_overlap_and_coeffs(n, l, alphas)
            tot += ov
        return -tot

    res = minimize(neg_total_overlap, x0, method="Nelder-Mead",
                   options={"xatol": 1e-10, "fatol": 1e-12, "maxiter": 4000})
    alphas = np.exp(res.x)
    order = np.argsort(-alphas)  # descending, the conventional listing
    alphas = alphas[order]
    coeffs = {}
    for n, l, name in parts:
        _ov, c = _shell_overlap_and_coeffs(n, l, alphas)
        coeffs[name] = tuple(float(v) for v in c)
    return tuple(float(a) for a in alphas), coeffs


# ---------------------------------------------------------------------------
# Explicitly-tabulated basis sets beyond STO-3G.
#
# STO-3G above is reconstructed (Slater refit); 6-31G and the Dunning
# correlation-consistent sets are defined by their published primitive
# tables (Hehre, Ditchfield, Pople, J. Chem. Phys. 56, 2257 (1972);
# Dunning, J. Chem. Phys. 90, 1007 (1989)).
#
# Format: {basis: {element: [(l_token, ((exp, coeff...), ...)), ...]}}
# where l_token in {"s", "p", "d", "sp"}; "sp" rows carry (exp, c_s, c_p).
EXPLICIT_BASES: Dict[str, Dict[str, list]] = {
    "6-31g": {
        "H": [
            ("s", ((18.7311370, 0.03349460),
                   (2.8253937, 0.23472695),
                   (0.6401217, 0.81375733))),
            ("s", ((0.1612778, 1.0),)),
        ],
        "C": [
            ("s", ((3047.5249, 0.0018347), (457.36951, 0.0140373),
                   (103.94869, 0.0688426), (29.210155, 0.2321844),
                   (9.2866630, 0.4679413), (3.1639270, 0.3623120))),
            ("sp", ((7.8682724, -0.1193324, 0.0689991),
                    (1.8812885, -0.1608542, 0.3164240),
                    (0.5442493, 1.1434564, 0.7443083))),
            ("sp", ((0.1687144, 1.0, 1.0),)),
        ],
        "N": [
            ("s", ((4173.5110, 0.0018348), (627.45790, 0.0139950),
                   (142.90210, 0.0685870), (40.234330, 0.2322410),
                   (12.820210, 0.4690700), (4.3904370, 0.3604550))),
            ("sp", ((11.626358, -0.1149610, 0.0675797),
                    (2.7162800, -0.1691180, 0.3239070),
                    (0.7722180, 1.1458520, 0.7408950))),
            ("sp", ((0.2120313, 1.0, 1.0),)),
        ],
        "O": [
            ("s", ((5484.6717, 0.0018311), (825.23495, 0.0139501),
                   (188.04696, 0.0684451), (52.964500, 0.2327143),
                   (16.897570, 0.4701930), (5.7996353, 0.3585209))),
            ("sp", ((15.539616, -0.1107775, 0.0708743),
                    (3.5999336, -0.1480263, 0.3397528),
                    (1.0137618, 1.1307670, 0.7271586))),
            ("sp", ((0.2700058, 1.0, 1.0),)),
        ],
    },
    "cc-pvdz": {
        "H": [
            ("s", ((13.0100, 0.0196850), (1.9620, 0.1379770),
                   (0.4446, 0.4781480))),
            ("s", ((0.1220, 1.0),)),
            ("p", ((0.7270, 1.0),)),
        ],
    },
    "cc-pvtz": {
        "H": [
            ("s", ((33.8700, 0.0060680), (5.0950, 0.0453080),
                   (1.1590, 0.2028220))),
            ("s", ((0.3258, 1.0),)),
            ("s", ((0.1027, 1.0),)),
            ("p", ((1.4070, 1.0),)),
            ("p", ((0.3880, 1.0),)),
            ("d", ((1.0570, 1.0),)),
        ],
    },
}

_P_LMN = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
# cartesian d order used throughout (the spherical transform in
# integrals.py depends on it): xx, yy, zz, xy, xz, yz
_D_LMN = ((2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1))


def _explicit_atom_basis(table: list, center: np.ndarray
                         ) -> List[ContractedGaussian]:
    out: List[ContractedGaussian] = []
    for l_token, prims in table:
        prims = np.asarray(prims, dtype=np.float64)
        alphas = prims[:, 0]
        if l_token == "s":
            out.append(ContractedGaussian(center, (0, 0, 0), alphas,
                                          prims[:, 1]))
        elif l_token == "p":
            for lmn in _P_LMN:
                out.append(ContractedGaussian(center, lmn, alphas,
                                              prims[:, 1]))
        elif l_token == "sp":
            out.append(ContractedGaussian(center, (0, 0, 0), alphas,
                                          prims[:, 1]))
            for lmn in _P_LMN:
                out.append(ContractedGaussian(center, lmn, alphas,
                                              prims[:, 2]))
        elif l_token == "d":
            # cartesian d sextet; spherical reduction (6 -> 5, dropping the
            # s-contaminant) happens at the integral level (integrals.py)
            for lmn in _D_LMN:
                out.append(ContractedGaussian(center, lmn, alphas,
                                              prims[:, 1]))
        else:
            raise ValueError(f"unknown shell token {l_token!r}")
    return out


_SHELL_OF_INDEX = {0: "1s", 1: "2sp", 2: "3sp"}


def element_shells(symbol: str) -> List[Tuple[str, float]]:
    """[(shell_name, zeta)] for the element's occupied STO-3G shells."""
    zetas = ZETAS[symbol]
    return [(_SHELL_OF_INDEX[i], z) for i, z in enumerate(zetas)]


def build_atom_basis(symbol: str, center: np.ndarray,
                     basis_name: str = "sto-3g") -> List[ContractedGaussian]:
    """AO functions for one atom: the reconstructed STO-3G by default, or
    an explicitly-tabulated set (6-31G, cc-pVDZ, ...) from EXPLICIT_BASES."""
    key = basis_name.lower()
    if key != "sto-3g":
        table = EXPLICIT_BASES.get(key, {}).get(symbol)
        if table is None:
            raise ValueError(
                f"basis {basis_name!r} not tabulated for element {symbol!r} "
                f"(available: {sorted(EXPLICIT_BASES.get(key, {}))})")
        return _explicit_atom_basis(table, np.asarray(center))
    out: List[ContractedGaussian] = []
    for shell, zeta in element_shells(symbol):
        alphas_u, coeffs = universal_expansion(shell)
        alphas = np.asarray(alphas_u) * zeta**2
        s_name = shell[0] + "s"  # "1s" -> "1s", "2sp" -> "2s"
        out.append(ContractedGaussian(center, (0, 0, 0), alphas,
                                      np.asarray(coeffs[s_name])))
        if shell.endswith("sp"):
            p_name = shell[0] + "p"
            for lmn in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                out.append(ContractedGaussian(center, lmn, alphas,
                                              np.asarray(coeffs[p_name])))
    return out


def build_basis(symbols: Sequence[str], centers_bohr: np.ndarray,
                basis_name: str = "sto-3g") -> List[ContractedGaussian]:
    basis: List[ContractedGaussian] = []
    for sym, cen in zip(symbols, centers_bohr):
        basis.extend(build_atom_basis(sym, np.asarray(cen), basis_name))
    return basis
