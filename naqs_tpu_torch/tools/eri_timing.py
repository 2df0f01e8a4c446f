"""Time the ERI kernel at several chunk sizes on the molecules it is held on.

    python -m naqs_tpu_torch.tools.eri_timing [--chunks 1,2,3,4]

On the card: `chem.integrals.eri_tensor` on each of ERI_SHAPES (H2O and N2
6-31G, H2 cc-pVTZ with classes L = 0-8, C2H4 6-31G at its experimental
structure) with its work list at the default chunk (primitive quartets a work
item, `work_list`) and at each chunk of --chunks (`with_chunk`). Every output
must lie within ERI_ATOL of the default chunk's. Times are held, in turns
(`utils/cuda_timing.py`: 5 repeats of 50 launches). Prints the card's name and
power limit first and one JSON line last. The kernel against an earlier
tree's build is timed by `chip_smoke.py --before DIR`.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from naqs_tpu_torch.chem.integrals import PackedBasis, pair_table, work_list


def with_chunk(pb: PackedBasis, chunk: int) -> PackedBasis:
    """pb with its work list rebuilt at `chunk` primitive quartets an item."""
    host = {f: getattr(pb, f).cpu().numpy() for f in
            ("centers", "lmn", "prim_ptr", "alphas", "cn", "quartets")}
    _, row0 = pair_table(host["centers"], host["lmn"], host["prim_ptr"], host["alphas"],
                         host["cn"])
    n_prim = np.diff(host["prim_ptr"]).astype(np.int64)
    qdesc, qitems, items, chunk, _, _ = work_list(host["quartets"], host["lmn"], n_prim, row0,
                                                  chunk)
    dev = pb.centers.device
    return dataclasses.replace(pb, qdesc=torch.from_numpy(qdesc).to(dev),
                               qitems=torch.from_numpy(qitems).to(dev),
                               items=torch.from_numpy(items).to(dev), chunk=chunk)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("eri_timing: no CUDA device available", file=sys.stderr)
        return 2
    from naqs_tpu_torch.chem.basis import build_basis
    from naqs_tpu_torch.chem.integrals import ANGSTROM_TO_BOHR, ERI_ATOL, ERI_SHAPES, eri_tensor
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    chunks = (1, 2, 3, 4)
    if "--chunks" in argv:
        chunks = tuple(int(c) for c in argv[argv.index("--chunks") + 1].split(","))
    out = {}
    for name, syms, pos, basis_name, _ in ERI_SHAPES:
        basis = build_basis(syms, np.asarray(pos) * ANGSTROM_TO_BOHR, basis_name)
        pb = PackedBasis.from_basis(basis, dev)
        packed = {f"chunk {pb.chunk} (default)": pb}
        packed.update({f"chunk {c}": with_chunk(pb, c) for c in chunks if c != pb.chunk})
        fns = {label: (lambda p: lambda: eri_tensor(p))(p) for label, p in packed.items()}
        want = eri_tensor(pb)
        err = {label: float((fn() - want).abs().max()) for label, fn in fns.items()}
        print(f"[case] {name}: max |output - the default chunk's| {err}", flush=True)
        if max(err.values()) > ERI_ATOL:
            raise SystemExit(f"eri_timing: an output on {name} lies beyond ERI_ATOL")
        times = time_in_turns(fns, 5, 50)
        for label, (med, spread, _) in times.items():
            print(f"[time] {name} | {label}: {med:.5f} ms (spread {spread[0]:.5f}-"
                  f"{spread[1]:.5f})", flush=True)
        out[name] = {"default_chunk": pb.chunk, "max_abs_err": err,
                     "ms": {k: v[0] for k, v in times.items()},
                     "spread": {k: v[1] for k, v in times.items()}}
        del fns, packed, want
    print(json.dumps({"card": smi, "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
