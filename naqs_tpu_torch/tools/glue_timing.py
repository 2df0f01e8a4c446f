"""Time the model's two feature kernels over the shapes their design handles.

    python -m naqs_tpu_torch.tools.glue_timing

On the card: `shell_features` (one shell of a `sample()` call's frontier) and
`state_features` (`log_psi`'s features of a batch) of `csrc/nade_glue.cu`,
each held bit for bit (signed zeros included) to its plain version, twice,
then held in turns with it (`utils/cuda_timing.py`: 5 repeats of 50
launches). `chip_smoke.py --before DIR` is the harness that times them
against an earlier tree, at H2O 6-31G's shapes.

The cases are H2O 6-31G's model (26 qubits, 13 shells, in_width 24, sector
(5, 5)) at capacity 100,000: shell 12 of a frontier of 100,000 random prefix
pairs, and a batch of 26,000 sector states with SENTINEL after them (a
sampled batch's shape); then the same batch's shape at 28 qubits (a 104-byte
line of x), with the integer encoding (an odd in_width of 13), at 56 qubits
(28 shells) and in float64. The inputs are made from seeds with numpy. Each
case prints its bound from the bytes the kernel must move (each input read
once, each output written once) at 3.35 TB/s. Prints the card's name and
power limit first and one JSON line last.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

SENTINEL = np.iinfo(np.int64).max
HBM_BYTES_PER_S = 3.35e12
ROWS, LIVE, SHELL = 100_000, 26_000, 12
REPEATS, LAUNCHES = 5, 50


def sector_states(n_qubits, n_alpha, n_beta, n, rng):
    """n states of the (n_alpha, n_beta) sector, the electrons placed at
    random shells (no basis is enumerated)."""
    shells = n_qubits // 2
    out = np.zeros(n, np.int64)
    for spin, k in ((0, n_alpha), (1, n_beta)):
        pos = np.argsort(rng.random((n, shells)), axis=1)[:, :k]
        for i in range(k):
            out |= np.int64(1) << (2 * pos[:, i] + spin)
    return out


def cases(dev):
    """{name: (kernel, NAQSConfig keyword arguments, inputs)}."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731

    def batch(n_qubits):
        st = np.full(ROWS, SENTINEL, np.int64)
        st[:LIVE] = sector_states(n_qubits, 5, 5, LIVE, rng)
        return (t(st),)

    def frontier(n_qubits):
        top = 1 << SHELL
        return t(rng.integers(0, top, ROWS)), t(rng.integers(0, top, ROWS)), SHELL

    h2o = dict(n_qubits=26)
    return {
        "shell_features, H2O 6-31G, shell 12": ("shell_features", h2o, frontier(26)),
        "state_features, H2O 6-31G, a batch at capacity": ("state_features", h2o, batch(26)),
        "shell_features, 28 qubits (104-byte lines)": (
            "shell_features", dict(n_qubits=28), frontier(28)),
        "state_features, 28 qubits (104-byte lines)": (
            "state_features", dict(n_qubits=28), batch(28)),
        "state_features, 28 qubits, integer encoding (in_width 13)": (
            "state_features", dict(n_qubits=28, input_encoding="integer"), batch(28)),
        "state_features, 56 qubits (28 shells)": (
            "state_features", dict(n_qubits=56), batch(56)),
        "state_features, H2O 6-31G, float64": (
            "state_features", dict(n_qubits=26, param_dtype="float64"), batch(26)),
    }


def bound_ms(kernel, cfg, args, out) -> float:
    """The bytes the kernel must move (inputs read once, outputs written once)
    at the card's memory rate, in ms."""
    n_in = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    n_out = sum(o.numel() * o.element_size() for o in out if o is not None)
    return (n_in + n_out) / HBM_BYTES_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("glue_timing: no CUDA device available", file=sys.stderr)
        return 2
    from naqs_tpu_torch.models.nade import NAQSConfig
    from naqs_tpu_torch.ops import nade_glue as g
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    out = {}
    for name, (kernel, kw, args) in cases(dev).items():
        cfg = NAQSConfig(sectors=((5, 5),), amp_hidden=(64,), phase_hidden=(512, 512), **kw)
        fns = {"kernel": lambda: getattr(g, kernel)(cfg, *args),
               "plain version": lambda: getattr(g, f"{kernel}_ref")(cfg, *args)}
        want = fns["plain version"]()
        same = g.same_bits(fns["kernel"](), want) and g.same_bits(fns["kernel"](), want)
        bound = bound_ms(kernel, cfg, args, want)
        print(f"[case] {name}: bitwise the plain version's, twice: {same}; bound "
              f"{bound:.5f} ms (bytes)", flush=True)
        if not same:
            raise SystemExit(f"glue_timing: {kernel} differs from its plain version")
        times = time_in_turns(fns, REPEATS, LAUNCHES)
        for label, (med, spread, _) in times.items():
            print(f"[time] {name} | {label}: {med:.4f} ms (spread {spread[0]:.4f}-"
                  f"{spread[1]:.4f}), {bound / med:.0%} of its bound", flush=True)
        out[name] = {"kernel": kernel, "config": {k: v for k, v in kw.items()},
                     "bitwise": same, "bound_ms": bound,
                     "ms": {k: v[0] for k, v in times.items()},
                     "spread": {k: v[1] for k, v in times.items()}}
        del fns, want
    print(json.dumps({"card": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
