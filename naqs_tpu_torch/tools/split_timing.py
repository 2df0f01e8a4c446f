"""Time the sampler's split on inputs that isolate each part of its time.

    python -m naqs_tpu_torch.tools.split_timing [--before DIR ...] [--variant DIR ...]

On the card, at capacity 100,000: H2O 6-31G's paper-scale model (amp 64,
phase 512x512) with random weights from seed 0, as `chip_smoke.py` phase 3
builds it, one recorded `sample()` call at n_samples 1e5 (every shell's
inputs kept by `chip_smoke._shell_inputs`) and its shell with the most live
rows, the steady state. `multinomial4_split` is timed held, in turns
(`utils/cuda_timing.py`, 5 repeats of 50 launches), on `decomposition_inputs`:

* an empty kernel launched on the same grid: the launch alone;
* every row dead: the shell's inputs with every flag false (a row loads its
  count and flag and writes zeros);
* every live row Gaussian: the shell's live rows with a count of 1e12 and
  equal probs (the loads, the three f64 divisions and log1p, three Gaussian
  binomials);
* the real shell;
* `synthetic_split`, the inverse CDF on every binomial (n = 20..5,000), as
  `chip_smoke.py` phase 5b also runs it;

and `split_and_compact` on the real shell. With --before DIR (an earlier
tree unpacked inside a directory `.gitignore` lists; repeatable), that tree's
two kernels too, built from its own source, on the same inputs in the same
turns, each first held bitwise against this tree's; with --variant DIR the same
for a timing-only variant of the kernels (a copy of a tree whose source was
changed to time one part), which is not held to this tree's outputs.
`split_tally` says what
each input asks of the inverse CDF: its looks, the longest, and the longest
chain of a warp (a warp runs each binomial's loop as long as its longest lane
does, the three binomials one after another). Prints the card's name and
power limit first and one JSON line last.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPEATS, LAUNCHES = 5, 50
WARP = 32


def synthetic_split(n_rows, dev):
    """(counts, probs, z, u) that take the inverse CDF on every binomial: n from
    20 to 5,000, conditional p log-uniform in [1e-4, 0.9] (so the p > 1/2 flip
    too), cut to 20 / n where the variance would pass 25; and 64 rows of
    corners at the end: q = 0 and 1, n = 0 and 1e12 (both branches), all-zero
    probs."""
    import numpy as np

    rng = np.random.default_rng(4)
    n = np.floor(10 ** rng.uniform(np.log10(20), np.log10(5000), n_rows))
    c = 10 ** rng.uniform(-4, np.log10(0.9), (n_rows, 4))
    c = np.where(n[:, None] * c * (1 - c) > 24.0, 20.0 / n[:, None], c)
    keep = np.cumprod(1 - c[:, ::-1], axis=1)[:, ::-1]    # prod_{i' >= i} (1 - c[i'])
    probs = c * np.concatenate([keep[:, 1:], np.ones((n_rows, 1))], axis=1)
    probs[:, 0] = keep[:, 1]
    corners = [(17.0, [0, 0, 1, 0]), (1e12, [0, 0, 0, 1]), (1e12, [1, 1e-11, 2e-11, 3e-12]),
               (1e12, [0.1, 0.2, 0.3, 0.4]), (0.0, [0.25] * 4), (5e3, [0, 0, 0, 0]),
               (1.0, [0.5, 0.5, 0, 0]), (1e12, [1e-13, 0, 1, 1e-12])]
    n[-64:] = [corners[i % 8][0] for i in range(64)]
    probs[-64:] = [corners[i % 8][1] for i in range(64)]
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn((3, n_rows), generator=gen, device=dev)
    u = torch.rand((3, n_rows), generator=gen, device=dev)
    return (torch.as_tensor(n, device=dev), torch.as_tensor(probs.astype(np.float32), device=dev),
            z, u)


def decomposition_inputs(step_args, synthetic):
    """{name: multinomial4_split's (counts, probs, z, u, mask, valid)} for a
    shell step's arguments `step_args` (`sampler._split_and_compact`'s) and
    the synthetic split `synthetic` = (counts, probs, z, u) of as many rows."""
    _, _, counts, valid, probs, z, u, mask = step_args[:8]
    live = valid & (counts > 0)
    return {
        "every row dead": (counts, probs, z, u, mask, torch.zeros_like(valid)),
        "every live row Gaussian": (torch.where(live, torch.full_like(counts, 1e12),
                                                torch.zeros_like(counts)),
                                    torch.full_like(probs, 0.25),
                                    z, u, mask, valid),
        "real shell": (counts, probs, z, u, mask, valid),
        "synthetic all-CDF": (*synthetic, None, None),
    }


def split_tally(counts, probs, z, u, valid):
    """What the split's inverse CDF does on these inputs (the plain cascade's
    counts): live rows, binomials by branch, looks in all, the longest loop,
    and the longest chain of a warp of 32 rows in looks (per binomial the
    most looks of a live row of the warp, summed over the three)."""
    from naqs_tpu_torch.ops.multinomial import _GAUSS_VAR_MIN, _SMALL_SUPPORT, _cascade

    live = counts > 0 if valid is None else (counts > 0) & valid
    out = {"live_rows": int(live.sum()), "gauss": 0, "cdf": 0, "looks": 0, "longest": 0}
    pad = -counts.shape[0] % WARP
    chain = torch.zeros((counts.shape[0] + pad) // WARP, dtype=torch.int64,
                        device=counts.device)
    for _, var, small in _cascade(counts, probs, z, u)[1]:
        in_cdf = live & ~(var > _GAUSS_VAR_MIN)
        # u is held against cdf_0 .. cdf_small: small + 1 looks, 127 at most
        looks = torch.where(in_cdf, torch.clamp(small + 1, max=_SMALL_SUPPORT - 1), 0).long()
        out["gauss"] += int((live & (var > _GAUSS_VAR_MIN)).sum())
        out["cdf"] += int(in_cdf.sum())
        out["looks"] += int(looks.sum())
        out["longest"] = max(out["longest"], int(looks.max()) if looks.numel() else 0)
        chain += torch.nn.functional.pad(looks, (0, pad)).view(-1, WARP).amax(dim=1)
    out["warp_chain"] = int(chain.max()) if chain.numel() else 0
    return out


def decomposition(trees, step_args, synthetic, device):
    """Time each tree's kernels on the decomposition's inputs, in turns.
    trees: {label: (its multinomial4_split, its _split_and_compact)}, this
    tree's first; every other tree's outputs are first held bitwise against
    it (SystemExit on a difference), but those of a label that starts with
    "variant". Returns ({name: (median ms, [min, max] ms, hold ms)}, {input:
    split_tally})."""
    from naqs_tpu_torch.ops.sampler_kernels import launch
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    inputs = decomposition_inputs(step_args, synthetic)
    (_, (split0, fused0)), *_ = trees.items()
    # an empty kernel on multinomial4_split's grid: the launch alone
    fns = {"empty launch": lambda: launch("split_grid_empty", (step_args[2].shape[0],), device)}
    for label, (split, fused) in trees.items():
        fused_args = step_args[:len(inspect.signature(fused).parameters)]
        held = split is not split0 and not label.startswith("variant")
        for name, args in inputs.items():
            if held and not all(
                    torch.equal(a, b) for a, b in zip(split(*args), split0(*args))):
                raise SystemExit(f"{label}: multinomial4_split differs on {name}")
            fns[f"{label}: multinomial4_split, {name}"] = (lambda f=split, a=args: f(*a))
        if held and not all(
                torch.equal(a, b) for a, b in zip(fused(*fused_args), fused0(*step_args))):
            raise SystemExit(f"{label}: split_and_compact differs on the real shell")
        fns[f"{label}: split_and_compact, real shell"] = (lambda f=fused, a=fused_args: f(*a))
    times = time_in_turns(fns, REPEATS, LAUNCHES)
    tally = {name: split_tally(args[0], args[1], args[2], args[3], args[5])
             for name, args in inputs.items()}
    return times, tally


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("split_timing: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.ops.multinomial import multinomial4_split
    from naqs_tpu_torch.sampler import _split_and_compact

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    mol = nt.load_molecule("H2O_6-31G_gen")
    hil = nt.Hilbert.for_molecule(mol)
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits)
    cfg = nt.NAQSConfig(n_qubits=mol.n_qubits, sectors=hil.sectors, amp_hidden=(64,),
                        phase_hidden=(512, 512))
    tc = nt.TrainConfig(n_samples=1e6, n_unq_samples_min=50_000, n_unq_samples_max=100_000,
                        seed=0)
    tr = nt.VMCTrainer(cfg, terms, hil, tc, device=dev)
    cap = tr.capacity
    _, shells = chip_smoke._shell_inputs(tr.model, tr.gen, 1e5, cap)
    step = max(shells, key=lambda a: int((a[3] & (a[2] > 0)).sum()))
    trees = {"this tree": (multinomial4_split, _split_and_compact)}
    for i, arg in enumerate(argv):
        if arg in ("--before", "--variant"):
            mods = chip_smoke._before_modules(os.path.abspath(argv[i + 1]))
            label = ("variant " if arg == "--variant" else "") + argv[i + 1]
            trees[label] = (mods["multinomial"].multinomial4_split,
                            mods["sampler"]._split_and_compact)
    times, tally = decomposition(trees, step, synthetic_split(cap, dev), dev)
    for name, t in tally.items():
        print(f"[tally] {name}: {t}", flush=True)
    for name, (med, spread, held) in times.items():
        print(f"[time] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms", flush=True)
    print(json.dumps({"card": smi, "capacity": cap, "tally": tally,
                      "ms": {k: v[0] for k, v in times.items()},
                      "spread": {k: v[1] for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
