"""Packed-bitstring utilities for occupation-number states, as int64.

A state over N <= 62 spin-orbital qubits is one int64; bit q is the
occupation of spin-orbital q in Jordan-Wigner order (even q = alpha spin of
spatial orbital q//2, odd q = beta). States are signed int64 rather than
uint64 because PyTorch has no uint64 shift, compare or searchsorted on every
backend; padding is INT64_MAX so it still sorts after every live state (an
all-ones int64 would be -1 and sort first).

Torch has no popcount, so parity is an xor-fold. The numpy helpers are the
host oracles and the host-side packing used to build inputs.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int64).max)  # padding value, sorts last


# ---------------------------------------------------------------- device ops

def parity_pm1(x: torch.Tensor) -> torch.Tensor:
    """(-1)**popcount(x) as int32 in {+1, -1}, for int64 x of any shape.

    Xor-folds the 64 bits down to bit 0. The arithmetic (sign-filling) right
    shift is harmless: each fold only reads the low half of its result.
    """
    for sh in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> sh)
    return (1 - 2 * (x & 1)).to(torch.int32)


def unpack_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """int64 (...) -> (..., n) int64 of {0, 1} (bit i at position i)."""
    shifts = torch.arange(n, dtype=torch.int64, device=x.device)
    return (x[..., None] >> shifts) & 1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack the trailing axis of {0, 1} ints into int64 (bit i = bits[..., i])."""
    n = bits.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        n, dtype=torch.int64, device=bits.device)
    return torch.sum(bits.to(torch.int64) * w, dim=-1)


# ------------------------------------------------------------------ host ops

def np_parity_pm1(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x).astype(np.uint64)
    return 1 - 2 * (np.bitwise_count(x).astype(np.int64) & 1)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    n = bits.shape[-1]
    w = np.int64(1) << np.arange(n, dtype=np.int64)
    return np.sum(bits.astype(np.int64) * w, axis=-1, dtype=np.int64)


def np_unpack_bits(x: np.ndarray, n: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    return (x[..., None] >> np.arange(n, dtype=np.int64)) & 1
