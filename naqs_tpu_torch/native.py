"""ctypes bindings of the native C++ host kernels (csrc/naqs_host.cpp).

The source is the port's own copy of the JAX package's host library: basis
enumeration, COO assembly of H over a sorted basis (OpenMP over rows), a
host E_loc and a complex CSR mat-vec. It builds with g++ at first use into
`<repo>/build/naqs_tpu_torch/libnaqs_host.so`. Where it cannot be built (no
g++), `get_lib` returns None and every wrapper returns None, so that its
caller runs the numpy version, as the JAX package does.

The library takes uint64 states; the port's int64 states (at most 62 qubits)
have the same bits and the same order, and pass as uint64 views.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from math import comb
from typing import Optional, Tuple

import numpy as np

from naqs_tpu_torch.ops.offdiag_h import term_groups

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "naqs_host.cpp")
_LIB_DIR = os.path.join(os.path.dirname(_PKG), "build", "naqs_tpu_torch")
_LIB = os.path.join(_LIB_DIR, "libnaqs_host.so")
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_I32, _I64, _U64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64


def build_native(force: bool = False) -> Optional[str]:
    """Compile csrc/naqs_host.cpp into the library, unless it is there and not
    older than the source. Returns its path, or None where g++ fails."""
    if os.path.exists(_LIB) and not force and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp, _LIB)  # atomic: a concurrent loader never sees half a file
    return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None if it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.naqs_enumerate_combinations.restype = _I64
    lib.naqs_enumerate_combinations.argtypes = [_I32, _I32, _u64p, _u64p, _I64]
    lib.naqs_popcount_parity.restype = None
    lib.naqs_popcount_parity.argtypes = [_u64p, _I64, _U64, _i8p]
    lib.naqs_assemble_h.restype = _I64
    lib.naqs_assemble_h.argtypes = [_u64p, _I64, _u64p, _i64p, _I64, _u64p, _f64p,
                                    _u64p, _f64p, _I64, _i64p, _i64p, _f64p, _I64]
    lib.naqs_assemble_h_rows.restype = _I64
    lib.naqs_assemble_h_rows.argtypes = [_u64p, _I64, _I64, _I64, _u64p, _i64p, _I64,
                                         _u64p, _f64p, _u64p, _f64p, _I64,
                                         _i64p, _i64p, _f64p, _I64]
    lib.naqs_local_energy.restype = None
    lib.naqs_local_energy.argtypes = [_u64p, _I64, _f64p, _f64p, _u64p, _i64p, _I64,
                                      _u64p, _f64p, _u64p, _f64p, _I64, _f64p, _f64p]
    lib.naqs_csr_matvec_complex.restype = None
    lib.naqs_csr_matvec_complex.argtypes = [_i64p, _i64p, _f64p, _I64, _f64p, _f64p,
                                            _f64p, _f64p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _u64(a) -> np.ndarray:
    """int64 states or masks as the library's contiguous uint64 view."""
    return np.ascontiguousarray(a, dtype=np.int64).view(np.uint64)


def _grouped_terms(terms) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The off-diagonal terms sorted by flip-mask group: (xy_unique, off, yz,
    coeff), group g's terms at off[g] .. off[g+1] - 1."""
    off, yz, coeff = term_groups(terms.gxy, len(terms.xy_unique), terms.yz, terms.coeff)
    return (_u64(terms.xy_unique), off, _u64(yz),
            np.ascontiguousarray(coeff, dtype=np.float64))


def _diag(terms):
    return _u64(terms.diag_yz), np.ascontiguousarray(terms.diag_coeff, dtype=np.float64)


def enumerate_combinations(s: int, n: int, weights: np.ndarray) -> Optional[np.ndarray]:
    """All C(s, n) sums of n of the s `weights` (int64), in the library's
    lexicographic order; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    cap = comb(s, n) if 0 <= n <= s else 0
    out = np.empty(max(cap, 1), dtype=np.uint64)
    cnt = lib.naqs_enumerate_combinations(s, n, _u64(weights), out, out.shape[0])
    if cnt < 0:
        return None
    return out[:cnt].view(np.int64)


def assemble_h_coo(terms, basis: np.ndarray, row0: int = 0, row1: Optional[int] = None):
    """COO (rows, cols, vals) of H rows [row0, row1) over a sorted basis
    (columns search the whole basis), or None without the library. The COO
    holds the worst case of the row range only, so a large basis assembles in
    bounded memory block by block."""
    lib = get_lib()
    if lib is None:
        return None
    basis = _u64(basis)
    xy_u, off, yz, coeff = _grouped_terms(terms)
    dyz, dco = _diag(terms)
    n = len(basis)
    row1 = n if row1 is None else int(row1)
    cap = max(row1 - row0, 0) * (len(xy_u) + 1)
    rows = np.empty(max(cap, 1), dtype=np.int64)
    cols = np.empty(max(cap, 1), dtype=np.int64)
    vals = np.empty(max(cap, 1), dtype=np.float64)
    nnz = lib.naqs_assemble_h_rows(basis, n, int(row0), row1, xy_u, off, len(xy_u), yz, coeff,
                                   dyz, dco, len(dyz), rows, cols, vals, cap)
    if nnz < 0:
        return None
    return rows[:nnz], cols[:nnz], vals[:nnz]


def local_energy_host(terms, states: np.ndarray, psi: np.ndarray):
    """Native E_loc (complex128) over a sorted sample set; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    states = _u64(states)
    xy_u, off, yz, coeff = _grouped_terms(terms)
    dyz, dco = _diag(terms)
    n = len(states)
    e_re = np.empty(n, dtype=np.float64)
    e_im = np.empty(n, dtype=np.float64)
    lib.naqs_local_energy(states, n, np.ascontiguousarray(psi.real, dtype=np.float64),
                          np.ascontiguousarray(psi.imag, dtype=np.float64),
                          xy_u, off, len(xy_u), yz, coeff, dyz, dco, len(dyz), e_re, e_im)
    return e_re + 1j * e_im


def csr_matvec_complex(H, x: np.ndarray) -> Optional[np.ndarray]:
    """H @ x for a real scipy CSR H and a complex vector x; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    n = H.shape[0]
    y_re = np.empty(n, dtype=np.float64)
    y_im = np.empty(n, dtype=np.float64)
    lib.naqs_csr_matvec_complex(np.ascontiguousarray(H.indptr, dtype=np.int64),
                                np.ascontiguousarray(H.indices, dtype=np.int64),
                                np.ascontiguousarray(H.data, dtype=np.float64), n,
                                np.ascontiguousarray(x.real, dtype=np.float64),
                                np.ascontiguousarray(x.imag, dtype=np.float64), y_re, y_im)
    return y_re + 1j * y_im
