"""Gaussian one- and two-electron integrals (McMurchie-Davidson scheme).

Port of `naqs_tpu/chem/integrals.py`. The one-electron integrals (overlap,
kinetic, nuclear attraction) stay host numpy, as in the JAX package: O(n^2)
contracted pairs, cheap. The two-electron repulsion integrals (ERIs) are
where the time goes (the JAX package's pure-Python 8-fold quartet loop), so
`build_integrals(basis, charges, centers, device=None)` returns S, T, V and
the (n, n, n, n) ERI tensor as float64 tensors on the device, the ERIs from
`eri_tensor`:

* on a CUDA tensor it launches the hand-written kernel of `csrc/eri.cu`
  (built by nvcc at first use), one launch a call over the basis'
  primitive-pair table and work list (`PackedBasis`), or raises: there is no
  fallback;
* on a CPU tensor it runs the plain version, `eri_tensor_ref`: the JAX
  package's loops (`eri`, `_prim_eri`, `_e_coeffs`, `_hermite_coulomb`,
  `boys`) on the host, entry for entry the JAX package's ERIs.

`boys_ref` is the plain torch twin of the kernel's Boys routine (series,
stopped at its first term below 2^-53 of the sum so far, and downward
recursion below BOYS_SERIES_MAX, F_0 from erf and upward recursion at and
above it); `boys_tensor` runs the kernel's own routine on a CUDA
tensor. `eri_tensor.launches` and `boys_tensor.launches` count kernel
launches.

McMurchie-Davidson (J. Comput. Phys. 26, 218 (1978)): products of two
Gaussians expand in Hermite Gaussians via E-coefficients with a 3-term
recurrence; nuclear attraction and ERIs then reduce to the Boys function
and the Hermite Coulomb tensor R_tuv.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from scipy.special import gammainc, gammaln

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.utils.device import resolve_device

# Angstrom -> Bohr: the conversion OpenFermion/Psi4 used for the stored
# molecule data (the JAX package's value).
ANGSTROM_TO_BOHR = 1.0 / 0.52917721067


def boys(n_max: int, x: np.ndarray) -> np.ndarray:
    """Boys functions F_0..F_n_max, shape (n_max+1,) + x.shape.

    F_n(x) = int_0^1 t^{2n} exp(-x t^2) dt
           = Gamma(n+1/2) P(n+1/2, x) / (2 x^{n+1/2})   for x > 0,
    with the x -> 0 limit 1/(2n+1); P is the regularized lower incomplete
    gamma function. Upward use is numerically fine here because sto-3g
    scale keeps n small (<= 4 angular momentum sum).
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((n_max + 1,) + x.shape, dtype=np.float64)
    small = x < 1e-13
    xs = np.where(small, 1.0, x)  # avoid 0^negative
    for n in range(n_max + 1):
        a = n + 0.5
        fn = np.exp(gammaln(a)) * gammainc(a, xs) / (2.0 * xs**a)
        out[n] = np.where(small, 1.0 / (2 * n + 1) - x / (2 * n + 3), fn)
    return out


def _e_coeffs(la: int, lb: int, a: float, b: float, ab: float) -> np.ndarray:
    """Hermite expansion coefficients E_t^{ij} for one Cartesian direction.

    Returns E[i, j, t] for i<=la, j<=lb, t<=i+j with the standard MD
    recurrences; `ab` = A_x - B_x.
    """
    p = a + b
    mu = a * b / p
    e = np.zeros((la + 1, lb + 1, la + lb + 1))
    e[0, 0, 0] = np.exp(-mu * ab * ab)
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                # build from (i-1, 0)
                for t in range(i + 1):
                    v = 0.0
                    if t - 1 >= 0:
                        v += e[i - 1, 0, t - 1] / (2 * p)
                    v += -(b / p) * ab * e[i - 1, 0, t]
                    if t + 1 <= i - 1:
                        v += (t + 1) * e[i - 1, 0, t + 1]
                    e[i, 0, t] = v
            else:
                for t in range(i + j + 1):
                    v = 0.0
                    if t - 1 >= 0:
                        v += e[i, j - 1, t - 1] / (2 * p)
                    v += (a / p) * ab * e[i, j - 1, t]
                    if t + 1 <= i + j - 1:
                        v += (t + 1) * e[i, j - 1, t + 1]
                    e[i, j, t] = v
    return e


def _hermite_coulomb(t_max: int, u_max: int, v_max: int, p: float,
                     pc: np.ndarray) -> np.ndarray:
    """Hermite Coulomb tensor R_{tuv} = (d/dPx)^t (d/dPy)^u (d/dPz)^v F0."""
    n_max = t_max + u_max + v_max
    x = p * float(pc @ pc)
    f = boys(n_max, np.asarray(x))
    r_n = np.zeros((n_max + 1, t_max + 1, u_max + 1, v_max + 1))
    for n in range(n_max + 1):
        r_n[n, 0, 0, 0] = (-2.0 * p) ** n * f[n]
    for total in range(1, n_max + 1):
        for t in range(min(total, t_max) + 1):
            for u in range(min(total - t, u_max) + 1):
                v = total - t - u
                if v > v_max:
                    continue
                for n in range(n_max - total + 1):
                    if t > 0:
                        val = pc[0] * r_n[n + 1, t - 1, u, v]
                        if t > 1:
                            val += (t - 1) * r_n[n + 1, t - 2, u, v]
                    elif u > 0:
                        val = pc[1] * r_n[n + 1, t, u - 1, v]
                        if u > 1:
                            val += (u - 1) * r_n[n + 1, t, u - 2, v]
                    else:
                        val = pc[2] * r_n[n + 1, t, u, v - 1]
                        if v > 1:
                            val += (v - 1) * r_n[n + 1, t, u, v - 2]
                    r_n[n, t, u, v] = val
    return r_n[0]


def _dfact(n: int) -> float:
    """(2n-1)!! with (-1)!! = 1."""
    out = 1.0
    for k in range(2 * n - 1, 0, -2):
        out *= k
    return out


@dataclass(frozen=True)
class Primitive:
    """One Cartesian primitive Gaussian x^i y^j z^k exp(-a r^2) at `center`."""

    center: Tuple[float, float, float]
    lmn: Tuple[int, int, int]
    alpha: float

    def norm(self) -> float:
        i, j, k = self.lmn
        l = i + j + k
        a = self.alpha
        return ((2 * a / np.pi) ** 0.75 * (4 * a) ** (l / 2.0)
                / np.sqrt(_dfact(i) * _dfact(j) * _dfact(k)))


@dataclass
class ContractedGaussian:
    """Normalized contraction sum_m c_m N(a_m) g(a_m); one AO basis function."""

    center: np.ndarray          # (3,) bohr
    lmn: Tuple[int, int, int]
    alphas: np.ndarray          # (M,)
    coeffs: np.ndarray          # (M,) contraction coeffs over NORMALIZED prims

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64)
        self.alphas = np.asarray(self.alphas, dtype=np.float64)
        self.coeffs = np.asarray(self.coeffs, dtype=np.float64)
        # fold primitive norms into the coefficients, then normalize the
        # contraction so <phi|phi> = 1
        norms = np.array([
            Primitive(tuple(self.center), self.lmn, a).norm()
            for a in self.alphas
        ])
        c = self.coeffs * norms
        s = 0.0
        for ci, ai in zip(c, self.alphas):
            for cj, aj in zip(c, self.alphas):
                s += ci * cj * _prim_overlap(self.lmn, ai, self.lmn, aj,
                                             np.zeros(3))
        self.cn = c / np.sqrt(s)


def _prim_overlap(lmn1, a, lmn2, b, ab: np.ndarray) -> float:
    """Overlap of two unnormalized primitives with center difference ab."""
    p = a + b
    out = (np.pi / p) ** 1.5
    for d in range(3):
        e = _e_coeffs(lmn1[d], lmn2[d], a, b, ab[d])
        out *= e[lmn1[d], lmn2[d], 0]
    return out


def overlap(g1: ContractedGaussian, g2: ContractedGaussian) -> float:
    ab = g1.center - g2.center
    s = 0.0
    for c1, a1 in zip(g1.cn, g1.alphas):
        for c2, a2 in zip(g2.cn, g2.alphas):
            s += c1 * c2 * _prim_overlap(g1.lmn, a1, g2.lmn, a2, ab)
    return s


def _prim_kinetic(lmn1, a, lmn2, b, ab: np.ndarray) -> float:
    """Kinetic energy via -1/2 Laplacian acting on the ket:
    T = b(2(l+m+n)+3) S(l2) - 2b^2 [S(l2+2ex)+...] - 1/2 [l(l-1)S(l2-2ex)+...]
    """
    l2 = list(lmn2)
    term = b * (2 * sum(l2) + 3) * _prim_overlap(lmn1, a, lmn2, b, ab)
    for d in range(3):
        up = l2.copy(); up[d] += 2
        term -= 2.0 * b * b * _prim_overlap(lmn1, a, tuple(up), b, ab)
        if l2[d] >= 2:
            dn = l2.copy(); dn[d] -= 2
            term -= 0.5 * l2[d] * (l2[d] - 1) * _prim_overlap(
                lmn1, a, tuple(dn), b, ab)
    return term


def kinetic(g1: ContractedGaussian, g2: ContractedGaussian) -> float:
    ab = g1.center - g2.center
    s = 0.0
    for c1, a1 in zip(g1.cn, g1.alphas):
        for c2, a2 in zip(g2.cn, g2.alphas):
            s += c1 * c2 * _prim_kinetic(g1.lmn, a1, g2.lmn, a2, ab)
    return s


def _prim_nuclear(lmn1, a, ca: np.ndarray, lmn2, b, cb: np.ndarray,
                  cn: np.ndarray) -> float:
    """<g1| 1/|r - C| |g2> for one nucleus at cn."""
    p = a + b
    pc_center = (a * ca + b * cb) / p
    ab = ca - cb
    es = [_e_coeffs(lmn1[d], lmn2[d], a, b, ab[d]) for d in range(3)]
    tm, um, vm = (lmn1[0] + lmn2[0]), (lmn1[1] + lmn2[1]), (lmn1[2] + lmn2[2])
    r = _hermite_coulomb(tm, um, vm, p, pc_center - cn)
    val = 0.0
    for t in range(tm + 1):
        et = es[0][lmn1[0], lmn2[0], t]
        for u in range(um + 1):
            eu = es[1][lmn1[1], lmn2[1], u]
            for v in range(vm + 1):
                ev = es[2][lmn1[2], lmn2[2], v]
                val += et * eu * ev * r[t, u, v]
    return 2.0 * np.pi / p * val


def nuclear(g1: ContractedGaussian, g2: ContractedGaussian,
            charges: Sequence[float], centers: np.ndarray) -> float:
    s = 0.0
    for c1, a1 in zip(g1.cn, g1.alphas):
        for c2, a2 in zip(g2.cn, g2.alphas):
            for z, cn in zip(charges, centers):
                s -= c1 * c2 * z * _prim_nuclear(
                    g1.lmn, a1, g1.center, g2.lmn, a2, g2.center, cn)
    return s


def _prim_eri(lmn1, a, ca, lmn2, b, cb, lmn3, c, cc, lmn4, d, cd) -> float:
    """(g1 g2 | g3 g4), chemist notation, unnormalized primitives."""
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    p_center = (a * ca + b * cb) / p
    q_center = (c * cc + d * cd) / q
    e1 = [_e_coeffs(lmn1[dd], lmn2[dd], a, b, (ca - cb)[dd]) for dd in range(3)]
    e2 = [_e_coeffs(lmn3[dd], lmn4[dd], c, d, (cc - cd)[dd]) for dd in range(3)]
    t1, u1, v1 = lmn1[0] + lmn2[0], lmn1[1] + lmn2[1], lmn1[2] + lmn2[2]
    t2, u2, v2 = lmn3[0] + lmn4[0], lmn3[1] + lmn4[1], lmn3[2] + lmn4[2]
    r = _hermite_coulomb(t1 + t2, u1 + u2, v1 + v2, alpha, p_center - q_center)
    val = 0.0
    for t in range(t1 + 1):
        for u in range(u1 + 1):
            for v in range(v1 + 1):
                e_bra = (e1[0][lmn1[0], lmn2[0], t]
                         * e1[1][lmn1[1], lmn2[1], u]
                         * e1[2][lmn1[2], lmn2[2], v])
                if e_bra == 0.0:
                    continue
                for tt in range(t2 + 1):
                    for uu in range(u2 + 1):
                        for vv in range(v2 + 1):
                            e_ket = (e2[0][lmn3[0], lmn4[0], tt]
                                     * e2[1][lmn3[1], lmn4[1], uu]
                                     * e2[2][lmn3[2], lmn4[2], vv])
                            if e_ket == 0.0:
                                continue
                            sgn = -1.0 if (tt + uu + vv) & 1 else 1.0
                            val += (e_bra * e_ket * sgn
                                    * r[t + tt, u + uu, v + vv])
    return val * 2.0 * np.pi**2.5 / (p * q * np.sqrt(p + q))


def eri(g1, g2, g3, g4) -> float:
    """(g1 g2 | g3 g4) over contracted functions (chemist notation)."""
    s = 0.0
    for c1, a1 in zip(g1.cn, g1.alphas):
        for c2, a2 in zip(g2.cn, g2.alphas):
            for c3, a3 in zip(g3.cn, g3.alphas):
                for c4, a4 in zip(g4.cn, g4.alphas):
                    s += c1 * c2 * c3 * c4 * _prim_eri(
                        g1.lmn, a1, g1.center, g2.lmn, a2, g2.center,
                        g3.lmn, a3, g3.center, g4.lmn, a4, g4.center)
    return s


# --- the ERI tensor: packed basis, pair table, work list, plain version, kernel

BOYS_SERIES_MAX = 12.0  # x below: F_L by its series, then downward; at and above: erf, upward
BOYS_SERIES_TERMS = 56  # the series' most terms: the 56th is below 2^-60 of the sum at x = 12
BOYS_SERIES_STOP = 2.0 ** -53  # the series stops before its first term below this of the sum so far
ERI_MAX_L = 8           # a quartet's total angular momentum (d functions, l <= 2 each)
_INV_ODD_LEN = 64       # 1/(2m+1), m < 64: the kernel's kInvOdd table
_HALF_SQRT_PI = 0.5 * math.sqrt(math.pi)
BOYS_RTOL = 1e-14       # kernel's Boys routine against boys_ref, relative: a few ulps
                        # (FMA contraction, the card's exp and erf), magnified at most
                        # 1.14x by the upward recursion
ERI_ATOL = 1e-11        # Ha, kernel against eri_tensor_ref per entry: another order of
                        # the same f64 sums and the Boys routine above
ERI_ROW = 16            # doubles a primitive-pair row: p, P, the pair's Hermite weights (<= 12)
ERI_WARP = 32           # lanes a warp: the kernel keeps two partial sums a warp
ERI_CHUNK_SCALE = 1 << 17  # a chunk is sqrt(primitive quartets / this), at least 1: on the
                           # H100 the best of 1-4 for H2O, N2 and C2H4 6-31G and H2 cc-pVTZ
_SHAPE_BITS = 3         # bits of one exponent sum in a quartet's shape code (eri.cu kShapeBits)
# the shapes (t, u, v) of a bra or ket of exponent sum at most 2, in the order
# of eri.cu's ERI_PAIR_SHAPES: an s/p quartet's descriptor names its bra's and
# ket's by their place here
ERI_PAIR_SHAPES = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0), (0, 2, 0), (0, 0, 2),
                   (1, 1, 0), (1, 0, 1), (0, 1, 1))
_NK_MAX = 255           # ket primitive pairs a quartet descriptor holds (its low 8 bits)

# C2H4 at its experimental structure (NIST CCCBDB: C=C 1.339, C-H 1.086 Angstrom, HCC 121.2
# degrees), in the xy plane, the C=C bond on x
_CC, _CH, _HCC = 1.339, 1.086, math.radians(121.2)
_C2H4 = (["C", "C", "H", "H", "H", "H"],
         [[-_CC / 2, 0.0, 0.0], [_CC / 2, 0.0, 0.0]]
         + [[sx * (_CC / 2 - _CH * math.cos(_HCC)), sy * _CH * math.sin(_HCC), 0.0]
            for sx in (-1, 1) for sy in (-1, 1)])
# the molecules the ERI kernel is held and timed on (chip_smoke.py phase 17a,
# tools/eri_timing.py): (label, symbols, positions (Angstrom), basis, held
# against eri_tensor_ref); H2O at the committed molecule's geometry
ERI_SHAPES = (("H2O 6-31G", ["O", "H", "H"], [[0.0, 0.0, 0.0], [0.2774, 0.8929, 0.2544],
                                               [0.6068, -0.2383, -0.7169]], "6-31g", True),
              ("N2 6-31G", ["N", "N"], [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0977]], "6-31g", False),
              ("H2 cc-pVTZ", ["H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7414]], "cc-pvtz", True),
              ("C2H4 6-31G", *_C2H4, "6-31g", False))

_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def boys_ref(n_max: int, x: torch.Tensor) -> torch.Tensor:
    """F_0..F_n_max, shape (n_max+1,) + x.shape, float64: the plain torch twin
    of `csrc/eri.cu`'s Boys routine, step for step. Below BOYS_SERIES_MAX,
    F_n_max = e^-x sum_k (2x)^k / ((2 n_max + 1) ... (2 n_max + 2k + 1)), the
    positive terms added until the first below BOYS_SERIES_STOP of the sum so
    far (at most BOYS_SERIES_TERMS), then F_n = (2x F_{n+1} + e^-x) / (2n+1)
    downward; at and above it, F_0 = sqrt(pi)/2 erf(sqrt x) / sqrt x, then
    F_{n+1} = ((2n+1) F_n - e^-x) / 2x upward."""
    if not 0 <= n_max <= ERI_MAX_L:
        raise ValueError(f"boys_ref: n_max must lie in [0, {ERI_MAX_L}], got {n_max}")
    x = torch.as_tensor(x, dtype=torch.float64)
    inv_odd = 1.0 / (2.0 * torch.arange(_INV_ODD_LEN, dtype=torch.float64, device=x.device) + 1.0)
    two_x = 2.0 * x
    ex = torch.exp(-x)
    term = inv_odd[n_max].expand_as(x)
    total = term
    live = torch.ones_like(x, dtype=torch.bool)
    for k in range(1, BOYS_SERIES_TERMS):
        term = term * (two_x * inv_odd[n_max + k])
        live = live & ~(term < BOYS_SERIES_STOP * total)
        total = torch.where(live, total + term, total)
    low = [None] * (n_max + 1)
    low[n_max] = ex * total
    for n in range(n_max - 1, -1, -1):
        low[n] = (two_x * low[n + 1] + ex) * inv_odd[n]
    series = x < BOYS_SERIES_MAX
    xh = torch.where(series, BOYS_SERIES_MAX, x)  # keeps the unused branch finite
    sx = torch.sqrt(xh)
    high = [_HALF_SQRT_PI * torch.erf(sx) / sx]
    inv_2x = 0.5 / xh
    for n in range(n_max):
        high.append(((2 * n + 1) * high[n] - ex) * inv_2x)
    return torch.stack([torch.where(series, lo, hi) for lo, hi in zip(low, high)])


def unique_quartets(n: int) -> np.ndarray:
    """(Q, 4) int32 unique quartets of an n-function basis in the JAX
    package's loop order: i, j <= i, k <= i, l <= (j if k == i else k)."""
    out = [(i, j, k, l) for i in range(n) for j in range(i + 1) for k in range(i + 1)
           for l in range((j if k == i else k) + 1)]
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)


def quartet_images(q) -> list:
    """The eight positions a unique quartet (i, j, k, l) stands for."""
    i, j, k, l = q
    return [(i, j, k, l), (j, i, k, l), (i, j, l, k), (j, i, l, k),
            (k, l, i, j), (l, k, i, j), (k, l, j, i), (l, k, j, i)]


def _e_row(la: int, lb: int, a, b, ab: float) -> np.ndarray:
    """E^{la lb}_t, t <= la + lb, of one direction for arrays of exponents a
    and b: `_e_coeffs`' recurrences term for term (up in i at j = 0, then up in
    j at i = la); shape (la + lb + 1,) + the shape of a + b."""
    p = a + b
    mu = a * b / p
    cur = [np.exp(-mu * ab * ab)]
    for s in range(1, la + lb + 1):
        x = -(b / p) * ab if s <= la else (a / p) * ab
        prev = cur + [0.0]
        cur = []
        for t in range(s + 1):
            v = 0.0
            if t >= 1:
                v = v + prev[t - 1] / (2 * p)
            v = v + x * prev[t]
            if t + 1 <= s - 1:
                v = v + (t + 1) * prev[t + 1]
            cur.append(v)
    return np.stack(np.broadcast_arrays(*cur))


def pair_id(i, j):
    """The number of function pair (i, j <= i) in the pair table."""
    return i * (i + 1) // 2 + j


def pair_table(centers: np.ndarray, lmn: np.ndarray, prim_ptr: np.ndarray,
               alphas: np.ndarray, cn: np.ndarray):
    """The ERI kernel's primitive-pair table: (rows (R, ERI_ROW) float64,
    row0 (n (n+1)/2,) int64). Function pair (i, j <= i), number pair_id(i, j),
    holds rows row0[pair] .. row0[pair] + np_i np_j - 1, primitive pair (a, b)
    at a np_j + b: p = a + b, the centre P = (a A + b B) / p, then the Hermite
    weights c_a c_b / p E^x_t E^y_u E^z_v over t <= lx_i + lx_j,
    u <= ly_i + ly_j, v <= lz_i + lz_j (t outer, v inner; zeros after), each
    direction's E from `_e_row`, whose E_0 holds exp(-ab/p (A - B)^2) of that
    direction."""
    n = len(lmn)
    row0 = np.zeros(n * (n + 1) // 2, dtype=np.int64)
    blocks, at = [], 0
    for i in range(n):
        a = alphas[prim_ptr[i]:prim_ptr[i + 1], None]
        ca = cn[prim_ptr[i]:prim_ptr[i + 1], None]
        for j in range(i + 1):
            b = alphas[None, prim_ptr[j]:prim_ptr[j + 1]]
            cb = cn[None, prim_ptr[j]:prim_ptr[j + 1]]
            p = a + b
            ex, ey, ez = (_e_row(int(lmn[i, d]), int(lmn[j, d]), a, b,
                                 centers[i, d] - centers[j, d]) for d in range(3))
            w = (ca * cb / p) * ex[:, None, None] * ey[None, :, None] * ez[None, None, :]
            nb = w.shape[0] * w.shape[1] * w.shape[2]
            block = np.zeros(p.shape + (ERI_ROW,))
            block[..., 0] = p
            block[..., 1:4] = (a[..., None] * centers[i] + b[..., None] * centers[j]) / p[..., None]
            block[..., 4:4 + nb] = np.moveaxis(w.reshape((nb,) + p.shape), 0, -1)
            row0[pair_id(i, j)] = at
            at += p.size
            blocks.append(block.reshape(-1, ERI_ROW))
    rows = np.concatenate(blocks) if blocks else np.zeros((0, ERI_ROW))
    return rows, row0


def pair_shape(t, u, v):
    """The place of the exponent sums (t, u, v) of a bra or ket in
    ERI_PAIR_SHAPES, on arrays; -1 for a sum above 2."""
    t, u, v = (np.asarray(a, dtype=np.int64) for a in (t, u, v))
    lut = np.full(27, -1)
    for i, (a, b, c) in enumerate(ERI_PAIR_SHAPES):
        lut[9 * a + 3 * b + c] = i
    return np.where(t + u + v <= 2, lut[np.minimum(9 * t + 3 * u + v, 26)], -1)


def work_list(quartets: np.ndarray, lmn: np.ndarray, n_prim: np.ndarray, row0: np.ndarray,
              chunk=None):
    """The ERI kernel's quartet descriptors and work items for the (Q, 4)
    unique quartets: (qdesc (Q, 4) int32: bra row, ket row, primitive
    quartets, ket primitive pairs | shape << 8; qitems (Q, 2) int32:
    first item, items; items (n_items, 2) int32: quartet, first primitive
    quartet; chunk; the largest exponent sum of a bra or ket; the largest R
    box). Quartet (i, j, k, l)
    has bra (i, j) and ket (k, l), but where both have exponent sums of at
    most 2 and the bra's pair_shape exceeds the ket's, bra (k, l) and ket
    (i, j) ((ij|kl) = (kl|ij); the kernel unrolls each pair of shapes in that
    order only). With bra (i, j), primitive quartets m = ((a np_j + b) np_k
    + c) np_l + d (JAX's loop order), bra row m // nk and ket row m % nk past
    its pairs' first rows (nk = np_k np_l). Its shape code packs lx_i + lx_j,
    ly_i + ly_j, lz_i + lz_j of the bra, then the ket's, _SHAPE_BITS each; the
    descriptor's shape is that code where some bra or ket has an exponent sum
    above 2, else the bra's and ket's pair_shape, bs | ks << 4 (the kernel's
    unrolled path reads only those). An item is `chunk`
    consecutive m (the quartet's last fewer; by default the integer part of
    sqrt(primitive quartets / ERI_CHUNK_SCALE), at least 1: more items than
    the card holds at once, few serial primitive quartets an item); a
    quartet's items are consecutive, the quartets
    visited by class, largest first, then by shape code, then in their order."""
    q = quartets.astype(np.int64)
    n_q = q.shape[0]
    sums = np.concatenate([lmn[q[:, 0]] + lmn[q[:, 1]], lmn[q[:, 2]] + lmn[q[:, 3]]], axis=1)
    bs, ks = pair_shape(*sums[:, :3].T), pair_shape(*sums[:, 3:].T)
    swap = (bs >= 0) & (ks >= 0) & (bs > ks)
    q = np.where(swap[:, None], q[:, [2, 3, 0, 1]], q)
    sums = np.where(swap[:, None], sums[:, [3, 4, 5, 0, 1, 2]], sums)
    nk = n_prim[q[:, 2]] * n_prim[q[:, 3]]
    nq_prim = n_prim[q[:, 0]] * n_prim[q[:, 1]] * nk
    code = (sums.astype(np.int64) << (_SHAPE_BITS * np.arange(6))).sum(axis=1)
    cls = sums.sum(axis=1)
    pair_l = max(sums[:, :3].sum(axis=1).max(initial=0), sums[:, 3:].sum(axis=1).max(initial=0))
    boxes = (sums[:, :3] + sums[:, 3:] + 1).prod(axis=1)
    if n_q and (nk.max() > _NK_MAX or nq_prim.max() >= 1 << 31):
        raise ValueError(f"eri work list: at most {_NK_MAX} primitive pairs a ket and 2^31 "
                         "primitive quartets a quartet")
    if chunk is None:
        chunk = max(1, math.isqrt(int(nq_prim.sum()) // ERI_CHUNK_SCALE))
    counts = -(-nq_prim // chunk)
    order = np.lexsort((np.arange(n_q), code, -cls))
    first = np.zeros(n_q, dtype=np.int64)
    first[order] = np.cumsum(counts[order]) - counts[order]
    item_q = np.repeat(order, counts[order])
    item_m0 = (np.arange(item_q.size) - first[item_q]) * chunk
    if item_q.size >= 1 << 31:
        raise ValueError("eri work list: more than 2^31 work items")
    shape = code if pair_l > 2 else np.minimum(bs, ks) | np.maximum(bs, ks) << 4
    qdesc = np.stack([row0[pair_id(q[:, 0], q[:, 1])], row0[pair_id(q[:, 2], q[:, 3])],
                      nq_prim, nk | (shape << 8)], axis=1)
    return (qdesc.astype(np.int32), np.stack([first, counts], axis=1).astype(np.int32),
            np.stack([item_q, item_m0], axis=1).astype(np.int32), int(chunk), int(pair_l),
            int(boxes.max(initial=1)))


@dataclass(frozen=True)
class PackedBasis:
    """A contracted basis and its unique quartets as flat tensors on one device:
    what the ERI kernel reads. Function i's primitives are prim_ptr[i] ..
    prim_ptr[i+1]-1; `cn` holds `ContractedGaussian.cn` (normalised contraction
    coefficients). The quartets are sorted by angular class L (the sum of the
    four functions' exponents), the most primitive quartets first within a
    class; class L's are rows class_ptr[L] .. class_ptr[L+1]-1. `pairs` is
    the primitive-pair table (`pair_table`) stored by column, (ERI_ROW, R),
    so that lanes reading neighbouring rows read neighbouring words; `qdesc`,
    `qitems`, `items`, `chunk`, `pair_l` and `box` the work list
    (`work_list`): a basis whose bras and kets all have exponent sums of at
    most 2 (every s/p basis, `pair_l` <= 2) takes the kernel's shape-unrolled
    path, any other its loops over R in shared memory."""

    centers: torch.Tensor    # (n, 3) float64, bohr
    lmn: torch.Tensor        # (n, 3) int32
    prim_ptr: torch.Tensor   # (n + 1,) int32
    alphas: torch.Tensor     # (P,) float64
    cn: torch.Tensor         # (P,) float64
    quartets: torch.Tensor   # (Q, 4) int32
    class_ptr: Tuple[int, ...]  # (ERI_MAX_L + 2,) host ints
    pairs: torch.Tensor      # (ERI_ROW, R) float64: pair_table's rows as columns
    qdesc: torch.Tensor      # (Q, 4) int32
    qitems: torch.Tensor     # (Q, 2) int32
    items: torch.Tensor      # (n_items, 2) int32
    chunk: int               # primitive quartets a work item
    pair_l: int              # the largest exponent sum of a quartet's bra or ket
    box: int                 # the largest R box (tm + 1)(um + 1)(vm + 1) of a quartet

    @property
    def n(self) -> int:
        return self.centers.shape[0]

    @property
    def classes(self) -> List[Tuple[int, int, int]]:
        """(L, q0, q1) of each angular class that has quartets."""
        return [(c, self.class_ptr[c], self.class_ptr[c + 1]) for c in range(ERI_MAX_L + 1)
                if self.class_ptr[c + 1] > self.class_ptr[c]]

    @staticmethod
    def from_basis(basis: List[ContractedGaussian], device) -> "PackedBasis":
        """The packed basis on `device`."""
        dev = torch.device(device)
        n = len(basis)
        lmn = np.asarray([g.lmn for g in basis], dtype=np.int32).reshape(n, 3)
        if (lmn.sum(axis=1) > 2).any():
            raise NotImplementedError("ERIs implemented up to d functions")
        n_prim = np.asarray([len(g.alphas) for g in basis], dtype=np.int64)
        prim_ptr = np.zeros(n + 1, dtype=np.int32)
        prim_ptr[1:] = np.cumsum(n_prim)
        quartets = unique_quartets(n)
        l_fn = lmn.sum(axis=1)
        cls = l_fn[quartets].sum(axis=1)
        work = n_prim[quartets].prod(axis=1)
        order = np.lexsort((-work, cls))
        quartets = np.ascontiguousarray(quartets[order])
        class_ptr = np.searchsorted(cls[order], np.arange(ERI_MAX_L + 2))
        centers = np.asarray([g.center for g in basis], dtype=np.float64).reshape(n, 3)
        alphas = np.concatenate([g.alphas for g in basis]) if n else np.zeros(0)
        cn = np.concatenate([g.cn for g in basis]) if n else np.zeros(0)
        pairs, row0 = pair_table(centers, lmn, prim_ptr, alphas, cn)
        qdesc, qitems, items, chunk, pair_l, box = work_list(quartets, lmn, n_prim, row0)

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

        return PackedBasis(
            centers=put(centers, torch.float64), lmn=put(lmn, torch.int32),
            prim_ptr=put(prim_ptr, torch.int32), alphas=put(alphas, torch.float64),
            cn=put(cn, torch.float64), quartets=put(quartets, torch.int32),
            class_ptr=tuple(int(c) for c in class_ptr), pairs=put(pairs.T, torch.float64),
            qdesc=put(qdesc, torch.int32), qitems=put(qitems, torch.int32),
            items=put(items, torch.int32), chunk=chunk, pair_l=pair_l, box=box)


class _Function(NamedTuple):
    """One contracted function of a PackedBasis as `eri` reads it."""

    center: np.ndarray
    lmn: Tuple[int, int, int]
    alphas: np.ndarray
    cn: np.ndarray


def eri_tensor_ref(pb: PackedBasis) -> torch.Tensor:
    """Plain version: the JAX package's ERI loops on the host (`eri` for each
    unique quartet), written to the eight symmetric positions; (n, n, n, n)
    float64 on pb's device."""
    centers = pb.centers.cpu().numpy()
    ptr = pb.prim_ptr.cpu().numpy()
    alphas, cn = pb.alphas.cpu().numpy(), pb.cn.cpu().numpy()
    fns = [_Function(centers[f], tuple(row), alphas[ptr[f]:ptr[f + 1]], cn[ptr[f]:ptr[f + 1]])
           for f, row in enumerate(pb.lmn.cpu().tolist())]
    n = pb.n
    g = np.zeros((n, n, n, n))
    for q in pb.quartets.cpu().tolist():
        val = eri(*(fns[f] for f in q))
        for pos in quartet_images(q):
            g[pos] = val
    return torch.from_numpy(g).to(pb.centers.device)


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("eri")
    lib.eri_launch.argtypes = [_PTR, _INT] + [_PTR] * 4 + [_INT] * 5 + [_PTR] * 4
    lib.eri_launch.restype = _INT
    lib.eri_boys.argtypes = [_PTR, _INT, _INT, _PTR, _PTR]
    lib.eri_boys.restype = _INT
    return lib


def _check_packed(name, pb: PackedBasis):
    n, n_p, n_q = pb.n, pb.alphas.shape[0], pb.quartets.shape[0]
    f64, i32 = (torch.float64,), (torch.int32,)
    _build.check_tensors(name, pb.centers, {
        "centers": (pb.centers, f64, (n, 3)), "lmn": (pb.lmn, i32, (n, 3)),
        "prim_ptr": (pb.prim_ptr, i32, (n + 1,)), "alphas": (pb.alphas, f64, (n_p,)),
        "cn": (pb.cn, f64, (n_p,)), "quartets": (pb.quartets, i32, (n_q, 4)),
        "pairs": (pb.pairs, f64, (ERI_ROW, pb.pairs.shape[-1])),
        "qdesc": (pb.qdesc, i32, (n_q, 4)), "qitems": (pb.qitems, i32, (n_q, 2)),
        "items": (pb.items, i32, (pb.items.shape[0], 2))}, align=16)
    if len(pb.class_ptr) != ERI_MAX_L + 2 or pb.class_ptr[0] != 0 \
            or pb.class_ptr[-1] != n_q or list(pb.class_ptr) != sorted(pb.class_ptr):
        raise ValueError(f"{name}: class_ptr must rise from 0 to the {n_q} quartets in "
                         f"{ERI_MAX_L + 2} entries, got {pb.class_ptr}")
    if not (pb.chunk >= 1 and 0 <= pb.pair_l <= ERI_MAX_L // 2 and 1 <= pb.box <= 64):
        raise ValueError(f"{name}: chunk {pb.chunk}, pair_l {pb.pair_l} or box {pb.box} out of "
                         f"range")


_arrivals: dict = {}   # the kernel's arrival counters, one a quartet, by device and stream


def eri_tensor(pb: PackedBasis) -> torch.Tensor:
    """(n, n, n, n) float64 ERIs (ij|kl), chemist order, over pb's contracted
    Cartesian functions, on pb's device: the kernel on a CUDA tensor (one
    launch), `eri_tensor_ref` on a CPU tensor."""
    _check_packed("eri_tensor", pb)
    if pb.centers.device.type == "cpu":
        return eri_tensor_ref(pb)
    n, dev = pb.n, pb.centers.device
    out = torch.empty((n, n, n, n), dtype=torch.float64, device=dev)
    n_items = pb.items.shape[0]
    partial = torch.empty(2 * -(-n_items // ERI_WARP), dtype=torch.float64, device=dev)
    arrivals = _build.zeroed_counters(_arrivals, dev, pb.quartets.shape[0])
    flat = [t.data_ptr() for t in (pb.qdesc, pb.qitems, pb.quartets, pb.items)]
    _build.launch_flat(_lib(), "eri_launch",
                       [pb.pairs.data_ptr(), pb.pairs.shape[1], *flat, n_items, pb.chunk, n,
                        int(pb.pair_l > 2), pb.box, partial.data_ptr(),
                        arrivals.data_ptr(), out.data_ptr()], dev)
    eri_tensor.launches += 1
    return out


eri_tensor.launches = 0


def boys_tensor(n_max: int, x: torch.Tensor) -> torch.Tensor:
    """F_0..F_n_max (n_max+1, N) float64 at the (N,) float64 points x: the
    kernel's own Boys routine on a CUDA tensor, `boys_ref` on a CPU tensor."""
    if not 0 <= n_max <= ERI_MAX_L:
        raise ValueError(f"boys_tensor: n_max must lie in [0, {ERI_MAX_L}], got {n_max}")
    _build.check_tensors("boys_tensor", x, {"x": (x, (torch.float64,), (x.shape[0],))})
    if x.device.type == "cpu":
        return boys_ref(n_max, x)
    out = torch.empty((n_max + 1, x.shape[0]), dtype=torch.float64, device=x.device)
    _build.launch(_lib(), "eri_boys", (x, x.shape[0], n_max, out), x.device)
    boys_tensor.launches += 1
    return out


boys_tensor.launches = 0


def build_integrals(basis: List[ContractedGaussian],
                    charges: Sequence[float], centers: np.ndarray, device=None):
    """(S, T, V, ERI) float64 tensors on the device (the CUDA card unless
    `device` names another): AO matrices and the ERI tensor in chemist order
    (ij|kl), Cartesian, before the spherical-d transform. S, T and V are
    computed on the host, as the JAX package computes them."""
    dev = resolve_device(device)
    n = len(basis)
    s_mat = np.zeros((n, n))
    t_mat = np.zeros((n, n))
    v_mat = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            s_mat[i, j] = s_mat[j, i] = overlap(basis[i], basis[j])
            t_mat[i, j] = t_mat[j, i] = kinetic(basis[i], basis[j])
            v_mat[i, j] = v_mat[j, i] = nuclear(basis[i], basis[j],
                                                charges, centers)
    g = eri_tensor(PackedBasis.from_basis(basis, dev))
    return (*(torch.from_numpy(m).to(dev) for m in (s_mat, t_mat, v_mat)), g)


D_CART_ORDER = ((2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1),
                (0, 1, 1))
# real spherical d in terms of NORMALIZED cartesian d (xx, yy, zz, xy, xz,
# yz): rows m = -2, -1, 0, +1, +2. Same-exponent normalized cartesians
# overlap as <xx|yy> = 1/3, so d_z2 = (2zz - xx - yy)/2 and
# d_x2-y2 = (sqrt(3)/2)(xx - yy) come out unit-normalized.
_SQRT3_2 = np.sqrt(3.0) / 2.0
SPH_D = np.array([
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],            # d_{-2} = xy
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],            # d_{-1} = yz
    [-0.5, -0.5, 1.0, 0.0, 0.0, 0.0],          # d_0    = z^2
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],            # d_{+1} = xz
    [_SQRT3_2, -_SQRT3_2, 0.0, 0.0, 0.0, 0.0],  # d_{+2} = x^2 - y^2
])


def spherical_d_transform(basis: List[ContractedGaussian]):
    """Cartesian -> real-spherical-harmonic AO transform T (n_sph x n_cart),
    or None when the basis is pure s/p (then cartesian == spherical).

    Cartesian d shells must appear as consecutive sextets in D_CART_ORDER
    (how basis.py emits them); each collapses to 5 spherical components,
    dropping the s-contaminated (x^2+y^2+z^2) combination — matching
    Psi4's default puream=True AO space (stored H2 cc-pVTZ: 28 spherical
    MOs, not 30 cartesian)."""
    n = len(basis)
    rows = []
    i = 0
    any_d = False
    while i < n:
        l_tot = sum(basis[i].lmn)
        if l_tot == 2:
            grp = basis[i:i + 6]
            if (len(grp) != 6
                    or tuple(g.lmn for g in grp) != D_CART_ORDER
                    or any(g.center is not grp[0].center
                           and not np.array_equal(g.center, grp[0].center)
                           for g in grp)):
                raise ValueError(
                    "d functions must form consecutive sextets in "
                    f"D_CART_ORDER (basis index {i})")
            for m in range(5):
                row = np.zeros(n)
                row[i:i + 6] = SPH_D[m]
                rows.append(row)
            any_d = True
            i += 6
        elif l_tot > 2:
            raise NotImplementedError(
                "spherical transform implemented up to d functions")
        else:
            row = np.zeros(n)
            row[i] = 1.0
            rows.append(row)
            i += 1
    if not any_d:
        return None
    return np.asarray(rows)


def nuclear_repulsion(charges: Sequence[float], centers: np.ndarray) -> float:
    e = 0.0
    n = len(charges)
    for i in range(n):
        for j in range(i + 1, n):
            e += charges[i] * charges[j] / np.linalg.norm(
                centers[i] - centers[j])
    return e
