#!/usr/bin/env python3
"""Quickest proof that naqs_tpu_torch runs on a CUDA card, end to end.

    python3 chip_smoke.py            # one card; the whole check
    python3 chip_smoke.py --profile  # also one torch.profiler-traced step

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build every CUDA kernel of the main path with nvcc (in parallel);
  2. print the card's name and power limit (nvidia-smi);
  3. set up H2O 6-31G (26 qubits, sector (5, 5), 1,656,369 states) and the
     paper-scale model (amp 64, phase 512x512, global phase net, partial
     masking) with random weights from a seed, capacity 100,000;
  4. hold rank_gather2 against its plain PyTorch version on the real value
     table at the main path's chunk shape (C=512, Kxy=4,608), bitwise, and
     time kernel, plain version and the one-call PyTorch gather;
  5. drive 5 VMCTrainer.step()s with every launch count set to 0, and fail
     if a kernel of the path was never launched or an energy is not finite;
  6. on one batch, check local_energy through the kernel equals the same
     call through the plain version, and a few rows against an independent
     float64 numpy E_loc (5e-4 Ha: fp32 off-diagonal sums).
Prints a {"kernels": [...]} JSON line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12   # non-tensor float32 (used for integer ops too)
ELOC_TOL = 5e-4               # Ha, fp32 off-diagonal vs float64 reference


def _cuda_ms(fn, n_iter=20, n_warm=3):
    import torch

    for _ in range(n_warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def _numpy_eloc(terms, states, la, ph, rows):
    """Independent float64 truncated E_loc by dict lookup, for a few rows."""
    import numpy as np

    from naqs_tpu_torch.utils.bits import np_parity_pm1 as parity

    psi = dict(zip(states.tolist(), (np.exp(la + 1j * ph)).tolist()))
    out = []
    for r in rows:
        s = int(states[r])
        e = float(np.sum(parity(s & terms.diag_yz) * terms.diag_coeff))
        par = parity(s & terms.yz)
        coupled = s ^ terms.xy
        ratios = np.array([psi.get(int(x), 0.0) for x in coupled.tolist()]) / psi[s]
        out.append(e + np.sum(terms.coeff * par * ratios.real))
    return np.array(out)


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops import _build
    from naqs_tpu_torch.ops import local_energy as le
    from naqs_tpu_torch.ops.dyn_gather import rank_gather2, rank_gather2_ref
    from naqs_tpu_torch.ops.rank import build_value_table, rank_index

    dev = torch.device("cuda")
    t0 = time.time()

    # 1. build
    for name, out in _build.build_all(["rank_gather"]).items():
        print(f"[build] {name}: nvcc {time.time() - t0:.1f}s\n{out.strip()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # 2. card
    print(f"[card] {smi}", flush=True)

    # 3. set-up
    t1 = time.time()
    mol = nt.load_molecule("H2O_6-31G_gen")
    hil = nt.Hilbert.for_molecule(mol)
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits)
    cfg = nt.NAQSConfig(n_qubits=mol.n_qubits, sectors=hil.sectors,
                        amp_hidden=(64,), phase_hidden=(512, 512))
    tc = nt.TrainConfig(n_samples=1e6, n_unq_samples_min=50_000,
                        n_unq_samples_max=100_000, seed=0)
    tr = nt.VMCTrainer(cfg, terms, hil, tc, device=dev)
    dt = tr.dt
    spec = dt.rank_spec
    print(f"[setup] H2O 6-31G: {mol.n_qubits} qubits, |basis|={hil.size}, "
          f"K={len(terms.coeff)} Kxy={len(terms.xy_unique)} (pad {dt.xy_unique.shape[0]}) "
          f"Kyz={len(terms.yz_unique)} Kd={len(terms.diag_yz)}; "
          f"{sum(p.numel() for p in tr.model.parameters())} params; "
          f"{time.time() - t1:.1f}s", flush=True)

    # 4. kernel against its plain version on the real table
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    tables = build_value_table(spec, batch.states, la, ph, batch.n_unique)
    chunk = le._chunks(dt, batch.states.shape[0], None)
    s = batch.states[:chunk].contiguous()
    xy = dt.xy_unique
    got = rank_gather2(spec, s, xy, *tables)
    want = rank_gather2_ref(spec, s, xy, *tables)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    live = torch.isfinite(got[0]) & torch.isfinite(want[0])
    max_err = max(float((g - w)[live].abs().max()) for g, w in zip(got, want))
    n_hit = int((got[0] > -1e29).sum())
    print(f"[kernel] rank_gather2 (C={chunk}, Kxy={xy.shape[0]}): bitwise equal={same}, "
          f"max_abs_err={max_err}, hits={n_hit}", flush=True)
    if not same:
        raise SystemExit("rank_gather2 disagrees with rank_gather2_ref")
    ms = _cuda_ms(lambda: rank_gather2(spec, s, xy, *tables))
    plain_ms = _cuda_ms(lambda: rank_gather2_ref(spec, s, xy, *tables))
    idx = rank_index(spec, s[:, None] ^ xy[None, :])
    tab2 = torch.stack(tables, dim=1)
    library_ms = _cuda_ms(lambda: tab2[idx])
    n_rows = int(torch.unique(idx).numel())
    n_bytes = s.numel() * 8 + xy.numel() * 8 + n_rows * 8 + 2 * idx.numel() * 4
    n_ops = idx.numel() * (8 * spec.n_shells + 8)  # shifts, ands, adds, loads per shell
    bound_b, bound_o = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max(bound_b, bound_o), ("bytes" if bound_b >= bound_o else "operations")
    print(f"[kernel] rank_gather2 {ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes} B with {n_rows} table rows touched, {n_ops} ops) | plain {plain_ms:.4f} ms | "
          f"tab2[idx] on a precomputed idx {library_ms:.4f} ms", flush=True)
    del idx, tab2, got, want

    # 5. the main path: 5 training steps through the port's entry points
    rank_gather2.launches = 0
    for i in range(5):
        torch.cuda.synchronize()
        t = time.time()
        out = tr.step()
        torch.cuda.synchronize()
        print(f"[step {i + 1}] {time.time() - t:.3f} s  n_unique={out['n_unique']} "
              f"n_samples={out['n_samples']:.0e} e_loc={out['e_loc']:.6f} "
              f"e_loc_var={out['e_loc_var']:.6f}", flush=True)
        if not (math.isfinite(out["e_loc"]) and math.isfinite(out["e_loc_var"])):
            raise SystemExit(f"non-finite energy at step {i + 1}: {out}")
    launches = rank_gather2.launches
    print(f"[path] rank_gather2 launches in 5 steps: {launches} "
          f"({tr.capacity // chunk + (tr.capacity % chunk > 0)} per local_energy call)",
          flush=True)
    if launches == 0:
        raise SystemExit("the main path never launched rank_gather2")

    # 6. local_energy through the kernel vs through the plain version
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    e_k = le.local_energy(dt, batch.states, la, ph, batch.n_unique)
    le.rank_gather2 = rank_gather2_ref
    try:
        e_p = le.local_energy(dt, batch.states, la, ph, batch.n_unique)
    finally:
        le.rank_gather2 = rank_gather2
    nu = int(batch.n_unique)
    eq = all(torch.equal(a[:nu], b[:nu]) for a, b in zip(e_k, e_p))
    diff = float((e_k[0][:nu] - e_p[0][:nu]).abs().max())
    print(f"[eloc] kernel vs plain on {nu} rows: equal={eq}, max_abs_diff={diff}", flush=True)
    if not eq:
        raise SystemExit("local_energy through the kernel differs from the plain version")
    states_np = batch.states[:nu].cpu().numpy()
    rows = np.random.default_rng(0).choice(nu, size=min(8, nu), replace=False)
    ref = _numpy_eloc(terms, states_np, la[:nu].double().cpu().numpy(),
                      ph[:nu].double().cpu().numpy(), rows)
    got_rows = e_k[0][:nu].cpu().numpy()[rows]
    err = float(np.abs(got_rows - ref).max())
    print(f"[eloc] vs float64 numpy reference on {len(rows)} rows: max_abs_err={err:.2e} "
          f"(tol {ELOC_TOL})", flush=True)
    if not (err < ELOC_TOL and np.all(np.isfinite(e_k[0][:nu].cpu().numpy()))):
        raise SystemExit("local energies disagree with the float64 reference")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        for name, fn in (("sample", tr._sample), ("step", tr.step)):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            print(f"[profile] {name}: {time.time() - t:.3f} s", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.step()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25),
              flush=True)

    print(json.dumps({"kernels": [{
        "name": "rank_gather2", "route": "cuda",
        "source": "naqs_tpu_torch/csrc/rank_gather.cu",
        "replaces": "naqs_tpu/ops/dyn_gather.py:83",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}]}))
    print(f"[card] {smi}; total {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
