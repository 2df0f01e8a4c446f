"""Reader of the JAX package's checkpoints, with no msgpack or flax.

`naqs_tpu.trainer.VMCTrainer.save` writes `<fname>.msgpack` with
`flax.serialization.to_bytes({"params": ..., "opt_state": ...})`: msgpack
maps, strings, ints, floats, and flax's ext types for arrays (1: an ndarray
as the msgpack triple (shape, dtype name, C-order bytes); 3: a numpy scalar
the same way; bfloat16 arrays come back as torch.bfloat16 tensors). Arrays
over 2^30 bytes are split into a map marked
`__msgpack_chunked_array__`. Tuples and lists arrive as maps keyed "0", "1",
... (flax's state-dict form).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes):
    """The array of an ext payload; a bfloat16 one (numpy has no such dtype)
    as a torch.bfloat16 tensor of the same bits."""
    shape, dtype, buf = unpackb(data)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(tuple(shape)).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(tuple(shape)).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _decode(buf: memoryview, i: int):
    """(object, next offset) of the msgpack item at offset i."""
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[i:i + n]).decode(), i + n
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
             0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
             0xDC: (">H", "array"), 0xDD: (">I", "array"),
             0xDE: (">H", "map"), 0xDF: (">I", "map"),
             0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
    if b in sized:
        fmt, kind = sized[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if kind == "array":
            return _array(buf, i, n)
        if kind == "map":
            return _map(buf, i, n)
        if kind == "ext":
            code = struct.unpack_from(">b", buf, i)[0]
            return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
        raw = bytes(buf[i:i + n])
        return (raw.decode() if kind == "str" else raw), i + n
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {i - 1}")


def _array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _decode(buf, i)
        out.append(v)
    return out, i


def _map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i)
        v, i = _decode(buf, i)
        out[k] = v
    return out, i


def unpackb(data: bytes):
    """The object of one msgpack message."""
    buf = memoryview(data)
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack message")
    return obj


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(blob: bytes):
    """The state dict that `flax.serialization.msgpack_restore` gives."""
    return _unchunk(unpackb(blob))


def _masked(node) -> bool:
    """True if every leaf of node is an empty map: optax.masked's MaskedNode,
    the place of a parameter another label's transform owns."""
    if isinstance(node, dict):
        return all(_masked(v) for v in node.values())
    return False


def jax_params(state: dict) -> dict:
    """A parameter tree of the state dict (its layer lists as maps keyed "0",
    "1", ...) as the nested dict/list tree `models/convert.params_from_jax`
    takes. Groups that are masked out (the other label's parameters in one
    label's Adam moments under optax.multi_transform) are left out."""
    return {name: [group[str(i)] for i in range(len(group))]
            for name, group in state.items() if not (group and _masked(group))}


def optax_parts(opt_state) -> dict:
    """The parts of an optax chain's state that the port keeps, found by
    their fields: "adam" (count, mu, nu of scale_by_adam), "clip" (norms,
    count of the adaptive trailing clip) and "schedule" (the count of
    scale_by_schedule). Under optax.multi_transform ("inner_states" by
    label) the "mlp" label's parts keep these names and another label's get
    its name appended ("adam_lut")."""
    found = {}

    def walk(node, suffix=""):
        if not isinstance(node, dict):
            return
        keys = set(node)
        if {"count", "mu", "nu"} <= keys:
            found.setdefault("adam" + suffix, node)
        elif keys == {"norms", "count"}:
            found.setdefault("clip", node)
        elif keys == {"count"}:
            found.setdefault("schedule" + suffix, node)
        elif keys == {"inner_states"}:
            for label, inner in node["inner_states"].items():
                walk(inner, "" if label == "mlp" else f"_{label}")
        else:
            for k in sorted(node, key=lambda k: (len(k), k)):
                walk(node[k], suffix)

    walk(opt_state)
    return found
