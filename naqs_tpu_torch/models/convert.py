"""Parameters of the JAX package's NADE as a state_dict of the port's NADE.

The JAX parameter tree is {"amp": [{"w", "b"}, ...], "phase": [...]} with
per-shell stacked weights w (S, d_in, d_out) and b (S, d_out); the port's
`MLPStack` keeps the same arrays, so the conversion only renames them.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict:
    """Nested dict/list of numpy arrays (a JAX params tree passed through
    np.asarray) -> state_dict for `naqs_tpu_torch.models.nade.NADE`."""
    extra = set(tree) - {"amp", "phase"}
    if extra:
        raise NotImplementedError(f"parameter groups {sorted(extra)} are not ported yet")
    out = {}
    for name in ("amp", "phase"):
        for li, layer in enumerate(tree[name]):
            for k in ("w", "b"):
                out[f"{name}.{k}.{li}"] = torch.from_numpy(
                    np.array(layer[k], dtype=np.float32))  # a writable copy
    return out
