"""The off-diagonal H row of a chunk, summed term by term per flip mask.

Where a dense (Kyz, Kxy) coupling matrix A would be too large (over
`local_energy._DENSE_A_MAX` entries), `naqs_tpu/ops/local_energy.py::
_offdiag_h` builds the H row as a per-term segment sum. Here the terms come
grouped by flip mask as CSR (`term_groups`, built once by
`DeviceTerms.from_terms`), and for chunk states s (C,):

    h[c, g] = sum_{k in group g} term_coeff[k] * (-1)^popcount(s[c] & yz_unique[term_yz[k]])

* `offdiag_h_terms(s, yz_unique, xy_ptr, term_yz, term_coeff)` -> h (C, Kxy)
  f32. On a CUDA tensor it launches the hand-written kernel in
  `csrc/offdiag_h.cu` (built by nvcc at first use) or raises; on a CPU tensor
  it runs the plain version, `offdiag_h_terms_ref`: the JAX package's steps,
  a (C, Kyz) parity matrix, a (C, K) product and `index_add_`. There is no
  fallback from one to the other. `offdiag_h_terms.launches` counts launches.

Every product is exact (a coefficient times +-1), so the two differ only in
the order of the fp32 adds: the kernel adds a group's terms in index order,
`index_add_` in its own (on the card, with atomics). Per entry they agree
within OFFDIAG_ATOL + OFFDIAG_RTOL * sum_k |coeff_k| (`offdiag_tolerance`):
each order of n adds errs by at most (n - 1) * 2^-24 * sum_k |coeff_k|, so
the two differ by at most twice that, and RTOL covers groups of up to 84
terms (N2 6-31G's largest holds 70, H2O 6-31G's 50); ATOL covers the sign of
a zero and the subnormals.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.utils.bits import parity_pm1

OFFDIAG_ATOL = 1e-12  # Ha
OFFDIAG_RTOL = 1e-5   # of sum_k |coeff_k| over the group: fp32 add order

_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def term_groups(gxy, n_groups: int, *fields):
    """(ptr (n_groups + 1,) int64, *fields), numpy: the per-term `fields`
    ordered by the terms' flip-mask group `gxy` (stably, so a group keeps its
    terms' order), group g's terms at ptr[g] .. ptr[g+1] - 1. DeviceTerms
    takes the sign mask's index and the coefficient of each term, the native
    host library its sign mask and coefficient."""
    order = np.argsort(gxy, kind="stable")
    ptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(gxy, minlength=n_groups), out=ptr[1:])
    return (ptr, *(f[order] for f in fields))


def term_group(xy_ptr, n_terms: int):
    """(K,) int64 flip-mask group of each grouped term."""
    return torch.repeat_interleave(torch.arange(xy_ptr.shape[0] - 1, device=xy_ptr.device),
                                   torch.diff(xy_ptr.long()), output_size=n_terms)


def offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff):
    """Plain PyTorch version: the parity matrix, the per-term product and a
    segment sum into the groups with `index_add_`."""
    par = parity_pm1(s[:, None] & yz_unique[None, :]).to(torch.float32)
    contrib = par[:, term_yz.long()] * term_coeff
    out = torch.zeros((s.shape[0], xy_ptr.shape[0] - 1), dtype=torch.float32, device=s.device)
    return out.index_add_(1, term_group(xy_ptr, term_yz.shape[0]), contrib)


def offdiag_tolerance(xy_ptr, term_coeff):
    """(Kxy,) bound on |kernel - plain version| per entry of a row."""
    mass = torch.zeros(xy_ptr.shape[0] - 1, dtype=torch.float64, device=term_coeff.device)
    mass.index_add_(0, term_group(xy_ptr, term_coeff.shape[0]), term_coeff.double().abs())
    return OFFDIAG_ATOL + OFFDIAG_RTOL * mass


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("offdiag_h")
    lib.offdiag_h_terms.argtypes = [_PTR, _INT, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR]
    lib.offdiag_h_terms.restype = _INT
    return lib


def offdiag_h_terms(s, yz_unique, xy_ptr, term_yz, term_coeff):
    """h (C, Kxy) f32, Kxy = len(xy_ptr) - 1: the off-diagonal H row entries
    of chunk states s (C,) int64, from the terms grouped by flip mask."""
    n_rows, n_groups, n_terms = s.shape[0], xy_ptr.shape[0] - 1, term_yz.shape[0]
    i64, i32 = (torch.int64,), (torch.int32,)
    _build.check_tensors("offdiag_h_terms", s, {
        "s": (s, i64, (n_rows,)), "yz_unique": (yz_unique, i64, (yz_unique.shape[0],)),
        "xy_ptr": (xy_ptr, i32, (n_groups + 1,)), "term_yz": (term_yz, i32, (n_terms,)),
        "term_coeff": (term_coeff, (torch.float32,), (n_terms,))})
    if s.device.type == "cpu":
        return offdiag_h_terms_ref(s, yz_unique, xy_ptr, term_yz, term_coeff)
    if n_rows * n_groups >= 1 << 31:
        raise ValueError(f"offdiag_h_terms: C * Kxy = {n_rows * n_groups} must be below 2^31")
    h = torch.empty((n_rows, n_groups), dtype=torch.float32, device=s.device)
    if h.numel() == 0:
        return h
    _build.launch(_lib(), "offdiag_h_terms",
                  (s, n_rows, yz_unique, xy_ptr, n_groups, term_yz, term_coeff, h), s.device)
    offdiag_h_terms.launches += 1
    return h


offdiag_h_terms.launches = 0
