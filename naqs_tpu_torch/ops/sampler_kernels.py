"""Loader of `csrc/sampler_step.cu`, the sampler's shell step on the card.

The source holds three hand-written kernels, `multinomial4_split`,
`compact_children` and `split_and_compact` (the two in one launch), built by
nvcc at first use (`ops/_build.py`) and bound through ctypes. Their public
wrappers live beside their plain versions, in `ops/multinomial.py` and
`sampler.py`; each checks its tensors with `check_tensors`, launches through
`launch` and counts its own launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

_INT = ctypes.c_int
_PTR = ctypes.c_void_p

@lru_cache(maxsize=1)
def _lib():
    from naqs_tpu_torch.ops import _build

    lib = _build.load("sampler_step")
    lib.multinomial4_split.argtypes = [_PTR] * 8 + [_INT, _INT, _PTR]
    lib.compact_children.argtypes = [_PTR] * 10 + [_INT, _INT, _INT, _PTR]
    lib.split_and_compact.argtypes = [_PTR] * 14 + [_INT, _INT, _INT, _PTR]
    lib.compact_tile_rows.argtypes = lib.split_tile_rows.argtypes = []
    lib.multinomial4_split.restype = lib.compact_children.restype = _INT
    lib.split_and_compact.restype = _INT
    lib.compact_tile_rows.restype = lib.split_tile_rows.restype = _INT
    lib.sampler_step_error_string.argtypes = [_INT]
    lib.sampler_step_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=1)
def compact_tile_rows() -> int:
    """Rows of one compact_children tile, as the kernel's library has it: its
    scratch holds one int32 a tile."""
    return _lib().compact_tile_rows()


@lru_cache(maxsize=1)
def split_tile_rows() -> int:
    """Rows of one split_and_compact tile, as the kernel's library has it: its
    scratch holds one int32 a tile."""
    return _lib().split_tile_rows()


def check_tensors(name, anchor, want):
    """Raise on anything the kernels of csrc/sampler_step.cu do not take.
    `want` maps a field's name to (tensor, dtypes, shape); every tensor must
    lie on `anchor`'s device and, on the card, be contiguous, 16-byte aligned
    and hold fewer than 2^31 elements. The plain versions take strided CPU
    tensors."""
    dev = anchor.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for key, (t, dtypes, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        dense = t.is_contiguous() or dev.type == "cpu"
        if t.dtype not in dtypes or tuple(t.shape) != shape or not dense:
            raise ValueError(
                f"{name}: {key} must be a contiguous {' or '.join(map(str, dtypes))} of "
                f"shape {shape}, got {t.dtype} of shape {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        if t.numel() >= 1 << 31:
            raise ValueError(f"{name}: {key} must hold fewer than 2^31 elements")


def launch(name, args, device):
    """Launch kernel `name` of csrc/sampler_step.cu on the device's current
    stream; tensors among `args` pass as pointers (None as a null pointer),
    ints as they are. Checks and counts nothing: the public wrappers do both."""
    lib = _lib()
    flat = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*flat, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.sampler_step_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
