"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Without a card and without an explicit device this raises: the port
    never moves to the CPU unless the caller asks for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def settle_cpu_math() -> None:
    """Make torch's first vectorized math calls on the CPU exact, once per process.

    PyTorch's CPU build computes exp, sin, cos and their kin through MKL's
    vector math library, which picks its code path lazily. When the first such
    call in a process runs on several threads at once, that choice races: one
    thread's share of the tensor can come out of a low-accuracy path (exp off
    by up to 1,771 ulps, 1.5e-4 relative, on one of eight 27,648-element
    chunks; seen in a few of every hundred fresh processes), and a plain
    version's E_loc then moves by up to ~6e-5 Ha on the first call only. One
    small call of each function on the calling thread, before any parallel
    one, settles the choice: this runs at the package's import.
    """
    for dtype in (torch.float32, torch.float64):
        x = torch.full((16,), 0.5, dtype=dtype)
        for fn in (torch.exp, torch.log, torch.log1p, torch.expm1, torch.sin, torch.cos,
                   torch.tanh, torch.sigmoid, torch.sqrt):
            fn(x)
