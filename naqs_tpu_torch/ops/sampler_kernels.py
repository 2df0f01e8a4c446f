"""Loader of `csrc/sampler_step.cu`, the sampler's shell step on the card.

The source holds three hand-written kernels, `multinomial4_split`,
`compact_children` and `split_and_compact` (the two in one launch), built by
nvcc at first use (`ops/_build.py`) and bound through ctypes. Their public
wrappers live beside their plain versions, in `ops/multinomial.py` and
`sampler.py`; each checks its tensors with `_build.check_tensors` (16-byte
aligned on the card), launches through `launch` and counts its own launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

from naqs_tpu_torch.ops import _build

_INT = ctypes.c_int
_PTR = ctypes.c_void_p


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("sampler_step")
    lib.multinomial4_split.argtypes = [_PTR] * 8 + [_INT, _INT, _PTR]
    lib.compact_children.argtypes = [_PTR] * 10 + [_INT, _INT, _INT, _PTR]
    lib.split_and_compact.argtypes = ([_PTR] * 9 + [_INT] + [_PTR] * 6
                                      + [_INT, _PTR, ctypes.c_size_t] + [_INT] * 3 + [_PTR])
    lib.split_grid_empty.argtypes = [_INT, _PTR]
    lib.split_division_mismatches.argtypes = [_PTR, _PTR]
    lib.split_grid_empty.restype = lib.split_division_mismatches.restype = _INT
    lib.compact_tile_rows.argtypes = lib.split_tile_rows.argtypes = []
    lib.multinomial4_split.restype = lib.compact_children.restype = _INT
    lib.split_and_compact.restype = _INT
    lib.compact_tile_rows.restype = lib.split_tile_rows.restype = _INT
    return lib


@lru_cache(maxsize=1)
def compact_tile_rows() -> int:
    """Rows of one compact_children tile, as the kernel's library has it: its
    scratch holds one int32 a tile."""
    return _lib().compact_tile_rows()


@lru_cache(maxsize=1)
def split_tile_rows() -> int:
    """Rows of one split_and_compact tile, as the kernel's library has it: its
    look-back scratch holds one int64 word a tile and one for the ticket."""
    return _lib().split_tile_rows()


def launch(name, args, device):
    """Launch kernel `name` of csrc/sampler_step.cu (`_build.launch`)."""
    _build.launch(_lib(), name, args, device)


def launch_flat(name, flat, device):
    """`launch` with pointers already taken (`_build.launch_flat`)."""
    _build.launch_flat(_lib(), name, flat, device)
