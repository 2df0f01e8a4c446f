#!/usr/bin/env python3
"""Quickest proof that naqs_tpu_torch runs on a CUDA card, end to end.

    python3 chip_smoke.py            # one card; the whole check
    python3 chip_smoke.py --profile  # also one torch.profiler-traced step
    python3 chip_smoke.py --before DIR  # also time the two-channel
                                        # rank_gather2 of the port's first
                                        # slice, unpacked at DIR

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build every CUDA kernel of the main path with nvcc (one nvcc per source,
     started together);
  2. print the card's name and power limit (nvidia-smi);
  3. set up H2O 6-31G (26 qubits, sector (5, 5), 1,656,369 states) and the
     paper-scale model (amp 64, phase 512x512, global phase net, partial
     masking) with random weights from a seed, capacity 100,000;
  4. on the real packed value table at the main path's chunk shape (C=512,
     Kxy=4,608): hold rank_gather2 bitwise against its plain version, and
     rank_ratio_rowsum with the real h per row within ROWSUM_ATOL +
     ROWSUM_RTOL * sum_k |h| |r| (fp32 summation order over 4,608 terms,
     expf/sincosf ulps); then time, in turns, REPEATS repeats of LAUNCHES
     launches each (median and min-max of the repeats): rank_gather2, its
     plain version, the library gather tab[idx] on a precomputed idx,
     rank_ratio_rowsum, its plain version, the unfused composition
     (rank_gather2 kernel + eager epilogue) and, with --before, the first
     slice's rank_gather2 (its own source and wrapper, two-channel tables;
     first held bitwise against this tree's) alone and with the eager
     epilogue (that slice's composition of rank_ratio_rowsum). Each is timed held (behind a card
     sleep that covers the host's enqueue, so the launches run back to
     back: the card's time, reported as "ms"); the fast ones also unheld
     (a plain loop, which reads the host's rate where the wrapper is slower
     than the kernel: "unheld_ms"), and the run fails if the hold did not
     cover their enqueue; see naqs_tpu_torch/utils/cuda_timing.py;
  5. the main path: 5 VMCTrainer.step()s with every launch count set to 0;
     fails unless rank_ratio_rowsum ran 196 times per E_loc call (capacity
     100,000 in chunks of 512) and every energy is finite;
  6. quadratic_energy over the sampled buffer with the counts set to 0,
     through rank_gather2 and through rank_gather2_ref: within 1e-6
     relative, and rank_gather2 launched;
  7. on one batch, local_energy through the kernel against the same call
     through the plain version (per row, the tolerance of phase 4), and a
     few rows against an independent float64 numpy E_loc (5e-4 Ha: fp32
     off-diagonal sums).
Prints a {"kernels": [...]} JSON line (launches from phase 5 for
rank_ratio_rowsum, from phase 6 for rank_gather2), and last
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
QUAD_RTOL = 1e-6              # quadratic_energy, kernel vs plain gather
REPEATS, LAUNCHES = 5, 50     # timing: repeats in turns, launches per repeat
RANK_OPS = 25                 # integer ops per element of the kernels' rank_of
EPILOGUE_OPS = 11             # per found element: 3 transcendentals + 8 flops


def _bound(n_bytes, n_ops):
    b, o = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


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


def _before_dyn_gather(before):
    """ops/dyn_gather.py of the port's first slice (two-channel value
    tables), unpacked at `before`, imported beside this tree's, with its
    kernel built from its own csrc/rank_gather.cu."""
    import importlib

    def ours(name):
        return name.split(".")[0] == "naqs_tpu_torch"

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, before)
    try:
        mod = importlib.import_module("naqs_tpu_torch.ops.dyn_gather")
        mod._lib()  # builds and binds that library while its package is loaded
    finally:
        sys.path.remove(before)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return mod


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
    from naqs_tpu_torch.ops.dyn_gather import (ROWSUM_ATOL, ROWSUM_RTOL, rank_gather2,
                                               rank_gather2_ref, rank_ratio_rowsum,
                                               rank_ratio_rowsum_ref, ratio_rowsum,
                                               rowsum_tolerance)
    from naqs_tpu_torch.ops.rank import build_value_table, rank_index
    from naqs_tpu_torch.utils.cuda_timing import hold_ms, time_in_turns

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

    # 4. both kernels against their plain versions on the real table
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    table = build_value_table(spec, batch.states, la, ph, batch.n_unique)
    chunk = le._chunks(dt, batch.states.shape[0], None)
    s = batch.states[:chunk].contiguous()
    my_la, my_ph = la[:chunk].float().contiguous(), ph[:chunk].float().contiguous()
    xy = dt.xy_unique
    h = le._offdiag_h(dt, s)
    got = rank_gather2(spec, s, xy, table)
    want = rank_gather2_ref(spec, s, xy, table)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    live = torch.isfinite(got[0]) & torch.isfinite(want[0])
    gather_err = max(float((g - w)[live].abs().max()) for g, w in zip(got, want))
    found = want[0] > -1e29
    n_found = int(found.sum())
    print(f"[kernel] rank_gather2 (C={chunk}, Kxy={xy.shape[0]}): bitwise equal={same}, "
          f"max_abs_err={gather_err}, hits={n_found}", flush=True)
    if not same:
        raise SystemExit("rank_gather2 disagrees with rank_gather2_ref")
    e_got = rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h)
    e_want = rank_ratio_rowsum_ref(spec, s, xy, table, my_la, my_ph, h)
    tol = rowsum_tolerance(want[0], my_la, h)
    torch.cuda.synchronize()
    diffs = [(g - w).abs() for g, w in zip(e_got, e_want)]
    rowsum_err = max(float(d.max()) for d in diffs)
    worst = max(float((d / tol).max()) for d in diffs)
    ok = all(bool((d <= tol).all()) for d in diffs) and all(
        bool(torch.isfinite(g).all()) for g in e_got)
    print(f"[kernel] rank_ratio_rowsum (C={chunk}, Kxy={xy.shape[0]}, real h): "
          f"max_abs_err={rowsum_err:.3e} Ha, worst row at {worst:.3f} of its tolerance "
          f"({ROWSUM_ATOL} Ha + {ROWSUM_RTOL} * sum_k |h||r|), within={ok}", flush=True)
    if not ok:
        raise SystemExit("rank_ratio_rowsum disagrees with rank_ratio_rowsum_ref")

    fast = ["rank_gather2", "rank_ratio_rowsum", "tab[idx]"]
    idx = rank_index(spec, s[:, None] ^ xy[None, :])
    fns = {
        "rank_gather2": lambda: rank_gather2(spec, s, xy, table),
        "rank_gather2_ref": lambda: rank_gather2_ref(spec, s, xy, table),
        "tab[idx]": lambda: table[idx],
        "rank_ratio_rowsum": lambda: rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h),
        "rank_ratio_rowsum_ref": lambda: rank_ratio_rowsum_ref(spec, s, xy, table, my_la,
                                                               my_ph, h),
        "rank_gather2 + eager epilogue": lambda: ratio_rowsum(
            *rank_gather2(spec, s, xy, table), my_la, my_ph, h),
    }
    old_name = "two-channel rank_gather2"
    if "--before" in argv:
        old = _before_dyn_gather(os.path.abspath(argv[argv.index("--before") + 1]))
        la_c, ph_c = table[:, 0].contiguous(), table[:, 1].contiguous()
        same_old = all(torch.equal(g, w) for g, w in
                       zip(old.rank_gather2(spec, s, xy, la_c, ph_c), want))
        print(f"[kernel] {old_name} (its own build): bitwise equal to this tree's={same_old}",
              flush=True)
        if not same_old:
            raise SystemExit(f"{old_name} disagrees with rank_gather2_ref")
        fns[old_name] = lambda: old.rank_gather2(spec, s, xy, la_c, ph_c)
        fns[f"{old_name} + eager epilogue"] = lambda: ratio_rowsum(
            *old.rank_gather2(spec, s, xy, la_c, ph_c), my_la, my_ph, h)
        fast.append(old_name)
    hold = hold_ms()
    times = time_in_turns(fns, REPEATS, LAUNCHES)
    calls = time_in_turns({n: fns[n] for n in fast}, REPEATS, LAUNCHES, hold=False)
    print(f"[time] {REPEATS} repeats of {LAUNCHES} launches, the functions in turns; held: "
          f"behind a {hold:.1f} ms card sleep, so the launches run back to back (the card's "
          f"time); unheld: a plain loop (the host's rate where that is slower)", flush=True)
    for name, (med, spread) in times.items():
        unheld = (f"; unheld median {calls[name][0]:.4f} ms, spread {calls[name][1][0]:.4f}-"
                  f"{calls[name][1][1]:.4f} ms" if name in calls else "")
        print(f"[time] {name}: held median {med:.4f} ms, spread {spread[0]:.4f}-{spread[1]:.4f}"
              f" ms{unheld}", flush=True)
    slow = [n for n in fast if calls[n][1][1] * LAUNCHES >= hold]
    if slow:
        raise SystemExit(f"the hold did not cover the enqueue of {slow}: held times invalid")
    n_el, n_rows = idx.numel(), int(torch.unique(idx).numel())
    head = s.numel() * 8 + xy.numel() * 8 + n_rows * 8
    g_bytes = head + 2 * n_el * 4
    g_bound = _bound(g_bytes, n_el * RANK_OPS)
    r_bytes = head + h.numel() * 4 + 2 * chunk * 4 + 2 * chunk * 4
    r_ops = n_el * RANK_OPS + n_found * EPILOGUE_OPS
    r_bound = _bound(r_bytes, r_ops)
    print(f"[bound] rank_gather2 {g_bound[0]:.5f} ms ({g_bound[1]}: {g_bytes} B = s, xy, "
          f"{n_rows} touched table rows x 8 B, outputs 2 x {n_el} x 4 B; "
          f"{n_el * RANK_OPS} ops)", flush=True)
    print(f"[bound] rank_ratio_rowsum {r_bound[0]:.5f} ms ({r_bound[1]}: {r_bytes} B = s, xy, "
          f"{n_rows} touched rows x 8 B, h {h.numel() * 4} B, my_la, my_ph, outputs "
          f"{2 * chunk * 4} B; {r_ops} ops of which {3 * n_found} transcendentals on the "
          f"{n_found} found elements, {3 * n_el} if every element counted)", flush=True)
    del idx, got, want, e_got, e_want, h

    # 5. the main path: 5 training steps through the port's entry points
    per_call = -(-tr.capacity // chunk)
    rank_gather2.launches = rank_ratio_rowsum.launches = 0
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
    ratio_launches = rank_ratio_rowsum.launches
    print(f"[path] rank_ratio_rowsum launches in 5 steps: {ratio_launches} "
          f"({per_call} per local_energy call, {ratio_launches / per_call:g} calls); "
          f"rank_gather2: {rank_gather2.launches}", flush=True)
    if ratio_launches == 0 or ratio_launches % per_call:
        raise SystemExit("the main path did not run rank_ratio_rowsum once per chunk")

    # 6. quadratic_energy through rank_gather2 and through its plain version
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    rank_gather2.launches = 0
    q_k = float(le.quadratic_energy(dt, batch.states, la, ph, batch.n_unique))
    gather_launches = rank_gather2.launches
    le.rank_gather2 = rank_gather2_ref
    q_p = float(le.quadratic_energy(dt, batch.states, la, ph, batch.n_unique))
    le.rank_gather2 = rank_gather2
    q_rel = abs(q_k - q_p) / abs(q_p)
    print(f"[quad] quadratic_energy kernel {q_k:.10f} vs plain {q_p:.10f}: rel {q_rel:.2e} "
          f"(tol {QUAD_RTOL}); rank_gather2 launches {gather_launches}", flush=True)
    if not (q_rel <= QUAD_RTOL and gather_launches > 0 and math.isfinite(q_k)):
        raise SystemExit("quadratic_energy through rank_gather2 disagrees or never launched it")

    # 7. local_energy through the kernel vs through the plain version
    e_k = le.local_energy(dt, batch.states, la, ph, batch.n_unique)
    le.rank_ratio_rowsum = rank_ratio_rowsum_ref
    e_p = le.local_energy(dt, batch.states, la, ph, batch.n_unique)
    le.rank_ratio_rowsum = rank_ratio_rowsum
    nu = int(batch.n_unique)
    table = build_value_table(spec, batch.states, la, ph, batch.n_unique)
    tol = []
    for i in range(0, nu, chunk):
        sc = batch.states[i:min(i + chunk, nu)]
        g_la = rank_gather2_ref(spec, sc, xy, table)[0]
        tol.append(rowsum_tolerance(g_la, la[i:i + sc.shape[0]].float(), le._offdiag_h(dt, sc)))
    tol = torch.cat(tol).double()
    d_re, d_im = ((a[:nu] - b[:nu]).abs() for a, b in zip(e_k, e_p))
    eq = bool((d_re <= tol).all() and (d_im <= tol).all())
    print(f"[eloc] kernel vs plain on {nu} rows: within the per-row tolerance={eq}, "
          f"max_abs_diff re {float(d_re.max()):.3e} im {float(d_im.max()):.3e} Ha", flush=True)
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
        events = prof.key_averages()
        print(events.table(sort_by="cuda_time_total", row_limit=25), flush=True)
        for e in events:
            if "rank_" in e.key and e.self_device_time_total > 0:
                print(f"[profile] {e.key}: {e.count} launches, "
                      f"{e.self_device_time_total / 1e3:.3f} ms device time, "
                      f"{e.self_device_time_total / e.count:.2f} us each", flush=True)

    def entry(name, launches, err, t_plain, bound, t_library, **more):
        return {"name": name, "route": "cuda", "source": "naqs_tpu_torch/csrc/rank_gather.cu",
                "replaces": "naqs_tpu/ops/dyn_gather.py:83", "launches": launches,
                "max_abs_err": err, "ms": times[name][0], "spread": times[name][1],
                "unheld_ms": calls[name][0], "plain_ms": times[t_plain][0],
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": times[t_library][0] if t_library else None, **more}

    unfused = "rank_gather2 + eager epilogue"
    print(json.dumps({"kernels": [
        entry("rank_gather2", gather_launches, gather_err, "rank_gather2_ref", g_bound,
              "tab[idx]",
              library_note="tab[idx] on a precomputed idx: skips the rank arithmetic",
              **({"before_ms": times[old_name][0], "before_spread": times[old_name][1]}
                 if old_name in times else {})),
        entry("rank_ratio_rowsum", ratio_launches, rowsum_err, "rank_ratio_rowsum_ref",
              r_bound, None,
              library_note="no single PyTorch call computes the fused gather, ratio and "
                           "row sum",
              unfused_ms=times[unfused][0], unfused_spread=times[unfused][1],
              **({"before_composition_ms": times[f"{old_name} + eager epilogue"][0]}
                 if old_name in times else {})),
    ]}))
    print(f"[card] {smi}; total {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
