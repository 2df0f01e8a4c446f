"""Parameters of the JAX package's NADE as a state_dict of the port's NADE,
and its K-FAC state as the port's (`kfac_state_from_jax`).

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


def kfac_state_from_jax(state: dict) -> dict:
    """The JAX package's K-FAC state ({"step", "amp": [{"A", "G"}, ...],
    "phase": [...]}, as `kfac_init` makes it; layer lists as nested lists
    or, from a checkpoint's state dict, maps keyed "0", "1", ...) as the
    port's: the same factors as float32 tensors and the step as a 0-d int32
    tensor, on the CPU."""
    out = {"step": torch.tensor(np.asarray(state["step"]), dtype=torch.int32).reshape(())}
    for name in _MLP_GROUPS:
        if name not in state:
            continue
        layers = state[name]
        if isinstance(layers, dict):
            layers = [layers[str(i)] for i in range(len(layers))]
        out[name] = [{k: torch.tensor(np.asarray(layer[k]), dtype=torch.float32)
                      for k in ("A", "G")} for layer in layers]
    return out
