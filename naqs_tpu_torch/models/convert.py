"""Parameters of the JAX package's NADE as a state_dict of the port's NADE.

The JAX parameter tree is {"amp": [{"w", "b"}, ...], "phase": [...],
"lut": [table, ...], "lut_phase": [...]} with per-shell stacked weights
w (S, d_in, d_out) and b (S, d_out) and one table per LUT shell; "phase" is
absent under `combined_amp_phase`, the "lut" groups without `num_lut`. The
port's `NADE` keeps the same arrays, so the conversion only renames them.
"""

from __future__ import annotations

import numpy as np
import torch

_MLP_GROUPS = ("amp", "phase")
_LUT_GROUPS = ("lut", "lut_phase")


def _tensor(x) -> torch.Tensor:
    """A writable copy of an array at its own dtype. numpy has no bfloat16:
    such arrays (ml_dtypes' type, or a torch tensor from the checkpoint
    reader) keep their bits."""
    if torch.is_tensor(x):
        return x.detach().clone()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict) -> dict:
    """Nested dict/list of arrays (a JAX params tree passed through
    np.asarray) -> state_dict for `naqs_tpu_torch.models.nade.NADE`."""
    extra = set(tree) - set(_MLP_GROUPS) - set(_LUT_GROUPS)
    if extra:
        raise ValueError(f"unknown parameter groups {sorted(extra)}")
    out = {}
    for name in _MLP_GROUPS:
        for li, layer in enumerate(tree.get(name, ())):
            for k in ("w", "b"):
                out[f"{name}.{k}.{li}"] = _tensor(layer[k])
    for name in _LUT_GROUPS:
        for j, table in enumerate(tree.get(name, ())):
            out[f"{name}.{j}"] = _tensor(table)
    return out
