"""Time the one-launch row kernels of several trees in turns, on synthetic inputs.

    python -m naqs_tpu_torch.tools.row_timing [--before DIR ...] [--variant DIR ...]

On the card: `sorted_local_energy`, `rank_local_energy`,
`sorted_quadratic_energy` and `rank_quadratic_energy` (csrc/row_energy.cuh's
body with the search and the rank lookups) at the shapes of the sampled steps
and of exact mode, built from each tree's own source into that tree's
`build/` (only `sort_lookup.cu` and `rank_gather.cu`, all trees at once) and
called through its own wrappers on the same inputs, held, in turns
(`utils/cuda_timing.py`: 5 repeats of 5 launches, 3 of 1 for the full-sector
calls). DIR is the root of a tree that holds `naqs_tpu_torch/` (an unpacked
`git archive` of an earlier commit, or a copy whose constants were changed to
time one design choice), inside a directory `.gitignore` lists; --before
trees are held bit for bit to this tree's outputs, --variant trees only
compared. A tree whose `rank_local_energy` takes no `n_valid` (before the
filter of the sampled states) is called without the table's keys.

The inputs are made from seeds with numpy: a sorted buffer of n random
states (36 qubits for the search; sector (5, 5) states of 26 or 32 qubits
for the rank table) padded with SENTINEL, the buffer itself (or 100,000 of
its states) as the query rows, K random flip masks of which a third join a
row to a live state, groups of 1-6 random terms and 257 diagonal terms; the
full-sector cases take every state of the 26-qubit sector (1,656,369), as
exact mode's sector table does; the last case takes H2O 6-31G's own terms
and rows near its Hartree-Fock state. Prints the card's name and power limit
first and one JSON line last.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SENTINEL = np.iinfo(np.int64).max


def _sector_states(n_qubits, n, rng):
    """At least n distinct sorted states of the (5, 5) sector of n_qubits."""
    shells, out = n_qubits // 2, np.zeros(0, np.int64)
    while out.size < n:
        m = 2 * (n - out.size) + 64
        bits = np.zeros(m, np.int64)
        for spin in (0, 1):
            pos = np.argsort(rng.random((m, shells)), axis=1)[:, :5]
            for j in range(5):
                bits |= np.int64(1) << (2 * pos[:, j] + spin)
        out = np.unique(np.concatenate([out, bits]))
    return out


def inputs(n_qubits, u, n, n_rows, n_cols, dev, pool=None, seed=0):
    """(states, la, ph, n_valid, q, q_la, q_ph, xy, xy_ptr, term_yz, yz_unique,
    term_coeff, diag_yz, diag_coeff) on the card, as the module docstring says."""
    rng = np.random.default_rng(seed + n_cols + n)
    if pool is None:
        pool = np.unique(rng.integers(0, 1 << n_qubits, size=2 * n + 8, dtype=np.int64))
    states = np.full(u, SENTINEL, np.int64)
    states[:n] = np.sort(rng.choice(pool, size=n, replace=False)) if n < pool.size else pool
    la = (-rng.uniform(0, 3, size=u)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=u).astype(np.float32)
    if n_rows is None:
        q, q_la, q_ph = states, la, ph
    else:
        q = states[rng.integers(0, n, size=n_rows)]
        q_la = (-rng.uniform(0, 3, size=n_rows)).astype(np.float32)
        q_ph = rng.uniform(-np.pi, np.pi, size=n_rows).astype(np.float32)
    live_q = q[q != SENTINEL]
    n_pad, third = n_cols // 10, n_cols // 3
    xy = rng.integers(1, 1 << n_qubits, size=n_cols, dtype=np.int64)
    xy[:third] = live_q[rng.integers(0, len(live_q), size=third)] ^ states[
        rng.integers(0, n, size=third)]
    xy[:third] = np.where(xy[:third] == 0, 1, xy[:third])
    xy[:n_cols - n_pad] = np.sort(xy[:n_cols - n_pad])
    xy[n_cols - n_pad:] = 0
    sizes = rng.integers(1, 7, size=n_cols)
    sizes[n_cols - n_pad:] = 0
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n_terms, n_yz = int(ptr[-1]), max(int(ptr[-1]) // 2, 1)
    yz_unique = np.sort(rng.integers(0, 1 << n_qubits, size=n_yz, dtype=np.int64))
    term_yz = rng.integers(0, n_yz, size=n_terms).astype(np.int32)
    term_coeff = (0.1 * rng.normal(size=n_terms)).astype(np.float32)
    diag_yz = rng.integers(0, 1 << n_qubits, size=257, dtype=np.int64)
    diag_coeff = rng.normal(size=257)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(states), t(la), t(ph), torch.tensor(n, device=dev), t(q), t(q_la), t(q_ph),
            t(xy), t(ptr), t(term_yz), t(yz_unique), t(term_coeff), t(diag_yz), t(diag_coeff))


def cases(dev):
    """name -> (kernel, its arguments): the sort engine's at N2 6-31G's live
    count and flip masks, the rank engine's at frozen-core N2 6-31G's, 70,000
    and 200,000 live keys in tables of 100,000 and 200,000 rows, and exact
    mode's full-sector tables (more than 262,144 rows)."""
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.ops.dyn_gather import QUAD_MISS
    from naqs_tpu_torch.ops.rank import RankSpec, build_value_table

    def rank(n_qubits, u, n, n_rows, n_cols, full=False):
        hil = nt.Hilbert(n_qubits=n_qubits, sectors=((5, 5),))
        pool = (hil.basis if full
                else _sector_states(n_qubits, n + (n_rows or 0) + 64, np.random.default_rng(n)))
        a = inputs(n_qubits, u, n, n_rows, n_cols, dev, pool=pool)
        spec = RankSpec.for_hilbert(hil)
        return spec, build_value_table(spec, a[0], a[1], a[2], a[3]), a

    def quad(n_qubits, u, n, n_cols, full=False):
        spec, _, a = rank(n_qubits, u, n, None, n_cols, full)
        states, la, ph, nv = a[:4]
        la_q = torch.where(torch.arange(u, device=dev) < nv, la - la[:n].max(),
                           QUAD_MISS).float()
        table = build_value_table(spec, states, la_q, ph, nv, miss_log_amp=QUAD_MISS)
        return (spec, table, nv, states, la_q, ph, *a[7:])

    def near_hf(table_rows, n_rows):
        """H2O 6-31G's terms, its whole sector as the table, and as the query rows
        the Hartree-Fock state and the states it couples to, then theirs (about
        26,000, as a sampled batch holds), SENTINEL-padded to n_rows: exact
        mode's 14b shape with realistic paths through the search."""
        from naqs_tpu_torch.ops.local_energy import DeviceTerms

        mol = nt.load_molecule("H2O_6-31G_gen")
        hil = nt.Hilbert.for_molecule(mol)
        dt = DeviceTerms.from_terms(nt.compile_pauli_terms(mol.qubit_hamiltonian,
                                                           mol.n_qubits), device=dev)
        xy = dt.xy_unique.cpu().numpy()
        hf = np.array([hil.hf_state()], np.int64)
        near = np.unique(hf[:, None] ^ xy[None, :])
        near = near[hil.contains(near)]
        second = np.unique(near[:, None] ^ xy[None, ::8])
        rows = np.unique(np.concatenate([near, second[hil.contains(second)]]))[:26_000]
        q = np.full(n_rows, SENTINEL, np.int64)
        q[:rows.size] = rows
        rng = np.random.default_rng(1)
        basis = np.full(table_rows, SENTINEL, np.int64)
        basis[:hil.size] = hil.basis
        t = lambda a: torch.as_tensor(a, device=dev)
        la = t((-rng.uniform(0, 3, size=table_rows)).astype(np.float32))
        q_la = t((-rng.uniform(0, 3, size=n_rows)).astype(np.float32))
        ph, q_ph = torch.zeros_like(la), torch.zeros_like(q_la)
        return (t(basis), la, ph, torch.tensor(hil.size, device=dev), t(q), q_la, q_ph,
                dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff, dt.diag_yz,
                dt.diag_coeff)

    full = 1_656_369
    sort20 = inputs(36, 100_000, 20_000, None, 27_392, dev)
    return {
        "sort, 20,000 live keys (N2 6-31G's shape)": ("sorted_local_energy", sort20),
        "sort, 70,000 live keys, 100,000 rows": (
            "sorted_local_energy", inputs(36, 100_000, 70_000, None, 27_392, dev)),
        "rank, 25,000 live keys, 32 qubits (frozen-core N2 6-31G's shape)": (
            "rank_local_energy", rank(32, 100_000, 25_000, None, 17_152)),
        "rank, 70,000 live keys, 100,000 rows": (
            "rank_local_energy", rank(26, 100_000, 70_000, None, 4_608)),
        "quadratic sort, 20,000 live keys": (
            "sorted_quadratic_energy", (*sort20[:4], *sort20[7:])),
        "quadratic rank, 200,000 live keys, 200,000 rows": (
            "rank_quadratic_energy", quad(26, 200_000, 200_000, 4_608)),
        "quadratic rank, the full sector (exact_energy's shape)": (
            "rank_quadratic_energy", quad(26, full, full, 4_608, full=True)),
        "sort, 100,000 queries against the full sector (exact mode's shape)": (
            "sorted_local_energy", rank(26, full, full, 100_000, 4_608, full=True)[2]),
        "rank, 100,000 queries against the full sector (exact mode's shape)": (
            "rank_local_energy", rank(26, full, full, 100_000, 4_608, full=True)),
        "sort, H2O 6-31G's near-HF rows against its sector (exact mode's 14b)": (
            "sorted_local_energy", near_hf(26 * 65_536, 100_000)),
    }


def load_trees(trees):
    """{label: (dyn_gather, sort_lookup)} of each tree root, its two libraries
    built at once (one nvcc each) into the tree's own build/ and bound while
    its package is loaded."""
    import inspect

    ours = lambda name: name.split(".")[0] == "naqs_tpu_torch"
    jobs = [subprocess.Popen([sys.executable, "-c", "from naqs_tpu_torch.ops import _build; "
                              "_build.build_all(('sort_lookup', 'rank_gather'))"], cwd=d)
            for d in trees.values()]
    if any(j.wait() for j in jobs):
        raise SystemExit("row_timing: a tree's kernels did not build")
    mods = {}
    for label, d in trees.items():
        saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
        sys.path.insert(0, d)
        try:
            dg = importlib.import_module("naqs_tpu_torch.ops.dyn_gather")
            sl = importlib.import_module("naqs_tpu_torch.ops.sort_lookup")
            dg._lib(), sl._lib()
            mods[label] = (dg, sl, "n_valid" in inspect.signature(
                dg.rank_local_energy).parameters)
        finally:
            sys.path.remove(d)
            for k in [k for k in sys.modules if ours(k)]:
                del sys.modules[k]
            sys.modules.update(saved)
    return mods


def call(mod, kernel, args):
    """A tree's wrapper of `kernel` on `args` (a rank E_loc case: (spec, table, inputs))."""
    dg, sl, keyed = mod
    if kernel == "rank_local_energy":
        spec, table, (states, _, _, nv, q, q_la, q_ph, *terms) = args
        keys = (states, nv) if keyed else ()
        return lambda: dg.rank_local_energy(spec, table, *keys, q, q_la, q_ph, *terms)
    if kernel == "sorted_local_energy":
        return lambda: sl.sorted_local_energy(*args)
    return lambda: getattr(dg if kernel.startswith("rank") else sl, kernel)(*args)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("row_timing: no CUDA device available", file=sys.stderr)
        return 2
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    trees, held = {"this tree": REPO}, {"this tree"}
    for i, arg in enumerate(argv):
        if arg in ("--before", "--variant"):
            label = ("variant " if arg == "--variant" else "") + argv[i + 1]
            trees[label] = os.path.abspath(argv[i + 1])
            if arg == "--before":
                held.add(label)
    mods = load_trees(trees)
    out = {}
    for name, (kernel, args) in cases(dev).items():
        fns = {label: call(mod, kernel, args) for label, mod in mods.items()}
        want = fns["this tree"]()
        same = {label: all(torch.equal(a, b) for a, b in zip(fn(), want))
                for label, fn in fns.items()}
        print(f"[case] {name} ({kernel}): bitwise this tree's {same}", flush=True)
        if not all(same[label] for label in held):
            raise SystemExit(f"row_timing: an earlier tree's {kernel} differs from this tree's")
        full = "full sector" in name
        times = time_in_turns(fns, 3 if full else 5, 1 if full else 5)
        for label, (med, spread, _) in times.items():
            print(f"[time] {name} | {label}: {med:.4f} ms (spread {spread[0]:.4f}-"
                  f"{spread[1]:.4f})", flush=True)
        out[name] = {"kernel": kernel, "bitwise": same,
                     "ms": {k: v[0] for k, v in times.items()},
                     "spread": {k: v[1] for k, v in times.items()}}
        del fns, args, want
    print(json.dumps({"card": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
