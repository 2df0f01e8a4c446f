"""What the NADE variants cost a training step on the card.

    python -m naqs_tpu_torch.tools.variant_cost

On H2O 6-31G at the paper's width (amp 64, one global phase net 512x512,
capacity 100,000, the CLI's controller settings, seed 7, 5 epochs of
pre_train_hf as `chip_smoke.py` phase 13's run A): the default model, four
LUT shells, and four LUT shells with their rows read by `table[idx]` instead
of `models/nade._lut_rows` (the lookup's backward is what differs). On N2
STO-3G (amp 64, per-shell phase nets 64 wide, phase 13's run B without
`-profile`): integer inputs with three LUT shells, with and without the
combined amp-phase trunk. For each: the wall time of steps 2-5 (each ending
in torch.cuda.synchronize()), then one step under torch.profiler: its device
time and the kernels that took most of it. Needs a CUDA card; prints the
card's name and power limit first and one JSON line per configuration.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

STEPS = 5
TOP = 3


def _case(nt, mol, hil, terms, **model):
    cfg = nt.NAQSConfig(n_qubits=mol.n_qubits, sectors=hil.sectors, **model)
    tc = nt.TrainConfig(n_samples=1e6, n_unq_samples_min=50_000, n_unq_samples_max=100_000,
                        seed=7)
    tr = nt.VMCTrainer(cfg, terms, hil, tc, device="cuda")
    tr.pre_train_hf(5)
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.time()
        out = tr.step()
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return {"steps_s": walls[1:], "n_unique": out["n_unique"],
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in events[:TOP]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("variant_cost: no CUDA device available", file=sys.stderr)
        return 2
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.models import nade

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    lut_rows = nade._lut_rows
    molecules = {}
    paper = dict(amp_hidden=(64,), phase_hidden=(512, 512))
    n2 = dict(amp_hidden=(64,), phase_hidden=(64,), aggregate_phase=True,
              input_encoding="integer", num_lut=3)
    for name, mol_name, model, rows in (
            ("H2O 6-31G default", "H2O_6-31G_gen", paper, lut_rows),
            ("H2O 6-31G 4 LUT shells", "H2O_6-31G_gen", dict(paper, num_lut=4), lut_rows),
            ("H2O 6-31G 4 LUT shells, table[idx]", "H2O_6-31G_gen", dict(paper, num_lut=4),
             lambda table, idx: table[idx]),
            ("N2 STO-3G integer 3 LUT shells", "N2_STO-3G_gen", n2, lut_rows),
            ("N2 STO-3G integer 3 LUT shells, combined trunk", "N2_STO-3G_gen",
             dict(n2, combined_amp_phase=True), lut_rows)):
        if mol_name not in molecules:
            mol = nt.load_molecule(mol_name)
            molecules[mol_name] = (mol, nt.Hilbert.for_molecule(mol),
                                   nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits))
        mol, hil, terms = molecules[mol_name]
        nade._lut_rows = rows
        try:
            res = _case(nt, mol, hil, terms, **model)
        finally:
            nade._lut_rows = lut_rows
        print(json.dumps({"case": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
