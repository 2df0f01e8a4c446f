"""The experiment command line of the port, flag for flag with `naqs_tpu.cli`.

seed -> molecule -> Hilbert space (open-shell m_s sector logic) -> model ->
trainer -> optional exact pre-solve check -> pre-training -> two-phase LR
training -> sampled-subspace FCI -> plots and the chemical-accuracy summary.
It runs on the CUDA card unless `-platform` names another torch device
(`-platform cpu`); with no card and no `-platform` it fails.

Usage:
    python -m naqs_tpu_torch.cli -m LiH -n_train 2000 -n_hid 64 -single_phase

Exact mode runs as in the JAX package: `-exact_eloc` resolves every
coupled state against psi over the whole enumerated sector, and
`-exact_sampling` trains over the whole basis with |psi|^2 weights
(`VMCTrainer.run_exact`), with `-ws_solve_h` re-targeting the model at the
basis ground state in between and the final `solve_h` over the basis.
`-sr` and `-kfac` train with the natural-gradient updates (matrix-free SR,
K-FAC).

`-devices D` above 1 trains data-parallel over D ranks (`parallel/`), one
process each: under `torchrun` (its environment names the group) the
processes are torchrun's; otherwise this process starts D ranks
(`parallel/launch.py`, a `file://` store in the output folder) and waits for
them. Rank r runs on the card cuda:r (NCCL), or with `-platform cpu` on the
CPU (gloo). Rank 0 alone prints and writes files. `-devices 0` means every
card, or one process with `-platform cpu`; more devices than cards is an
error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a NAQS wavefunction on a molecule (PyTorch, CUDA).",
        allow_abbrev=True,
    )
    p.add_argument("-m", "--molecule", default="H2", help="molecule folder or name")
    p.add_argument("-hf", "--hamiltonian_fname", default=None,
                   help="qubit-hamiltonian pkl location override")
    p.add_argument("-o", "--out", default=None, help="output folder")
    p.add_argument("-n", "--number", type=int, default=1, help="number of runs")
    p.add_argument("-qo", "--qubit_ordering", type=int, default=-1,
                   help="shell ordering: 1 natural, -1 reversed, 0 random")
    p.add_argument("-l", "--load", default=None, help="pre-trained checkpoint dir")
    p.add_argument("-c", "--cont", action="store_true", help="continue previous run")
    p.add_argument("-r", "--resetOpt", action="store_true", help="reset optimizer state")
    p.add_argument("-n_samps", type=float, default=1e6)
    p.add_argument("-n_samps_max", type=float, default=1e12)
    p.add_argument("-n_unq_samps_min", type=int, default=50000)
    p.add_argument("-n_unq_samps_max", type=int, default=100000)
    p.add_argument("-weight_by_psi", action="store_true",
                   help="weight samples by |psi|^2 instead of counts")
    p.add_argument("-sample_beta", type=float, default=1.0,
                   help="temper the sampling conditionals to p^beta "
                        "(beta<1 widens support into the |psi|^2 tail; "
                        "implies -weight_by_psi for unbiased expectations)")
    p.add_argument("-no_mask_psi", action="store_true", help="masking: none")
    p.add_argument("-full_mask_psi", action="store_true", help="masking: full")
    p.add_argument("-lr", type=float, default=-1,
                   help="learning rate (-1: default 1e-3 -> 5e-4 schedule)")
    p.add_argument("-lr_lut", type=float, default=1e-2, help="LUT-conditional LR")
    p.add_argument("-n_train", type=int, default=5000)
    p.add_argument("-n_pretrain", type=int, default=0)
    p.add_argument("-pretrain_hf", type=int, default=0,
                   help="BCE pre-training epochs towards the Hartree-Fock state")
    p.add_argument("-input_encoding", choices=["binary", "integer"],
                   default="binary",
                   help="conditional-input encoding: signed bits or one "
                        "integer per previous shell")
    p.add_argument("-n_lut", type=int, default=0,
                   help="number of leading shells using LUT conditionals")
    p.add_argument("-n_hid", type=int, default=64)
    p.add_argument("-n_layer", type=int, default=1)
    p.add_argument("-n_hid_phase", type=int, default=-1)
    p.add_argument("-n_layer_phase", type=int, default=-1)
    p.add_argument("-output_freq", type=int, default=25)
    p.add_argument("-save_freq", type=int, default=-1)
    p.add_argument("-loadH", action="store_true", help="load cached compiled terms")
    p.add_argument("-overwriteH", action="store_true", help="cache compiled terms")
    p.add_argument("-presolveH", action="store_true",
                   help="exactly diagonalize H and check against FCI")
    p.add_argument("-n_excitations_max", type=int, default=-1)
    p.add_argument("-comb_amp_phase", action="store_true")
    p.add_argument("-no_amp_sym", action="store_true")
    p.add_argument("-phase_sym", action="store_true")
    p.add_argument("-single_phase", action="store_true",
                   help="one global phase net instead of per-shell nets")
    p.add_argument("-no_restrictedH", action="store_true",
                   help="do not hard-restrict the ansatz to valid electron counts")
    p.add_argument("-sr", action="store_true",
                   help="stochastic-reconfiguration (natural gradient) updates")
    p.add_argument("-sr_damping", type=float, default=1e-3)
    p.add_argument("-sr_cg_iters", type=int, default=50)
    p.add_argument("-sr_fisher_mix", type=float, default=0.0,
                   help="mix this fraction of a uniform-over-support "
                        "distribution into the SR Fisher weights (metric only)")
    p.add_argument("-sr_kl_clip", type=float, default=-1.0,
                   help="SR trust region: cap the natural step's quadratic "
                        "length dx^T S dx at this many nats (<=0 = off)")
    p.add_argument("-kfac", action="store_true",
                   help="K-FAC natural-gradient updates")
    p.add_argument("-kfac_damping", type=float, default=1e-2)
    p.add_argument("-ws_solve_h", type=int, default=0,
                   help="after this many steps, re-target the model at the "
                        "ground state of H restricted to the most-sampled "
                        "subspace, then continue training")
    p.add_argument("-solve_h_kmax", type=int, default=10000,
                   help="subspace size cap for the final solve_H")
    p.add_argument("-ws_full_basis", action="store_true",
                   help="warm-start against the ground state of the FULL "
                        "(enumerable) training basis instead of the sampled "
                        "counter subspace (host linear algebra)")
    p.add_argument("-ws_loss", default="mse",
                   choices=["mse", "wmse", "overlap"],
                   help="fit objective for the solve_H warm start: 'mse' = "
                        "democratic log-amp MSE, 'wmse' = |target|^2-weighted "
                        "MSE, 'overlap' = log-fidelity")
    p.add_argument("-ws_epochs", type=int, default=500,
                   help="supervised fit epochs for the solve_H warm start")
    p.add_argument("-ws_spin", type=float, default=-1.0,
                   help="target total spin s for solve_H eigenstate "
                        "selection (<S^2> = s(s+1)). -1 = off")
    p.add_argument("-s2_penalty", type=float, default=0.0,
                   help="train on H + lambda*S^2 instead of H; reported "
                        "energies stay pure <H>. 0 = off")
    p.add_argument("-exact_eloc", action="store_true",
                   help="exact local energies: evaluate psi over the whole "
                        "enumerated sector each step and resolve every "
                        "coupled state against it")
    p.add_argument("-exact_sampling", action="store_true",
                   help="train over the entire restricted basis with |psi|^2 weights")
    p.add_argument("-sample_dP", type=float, default=-1,
                   help="density sampling: train on all states with "
                        "|psi|^2 >= dP (adaptive)")
    p.add_argument("-devices", type=int, default=0,
                   help="data-parallel devices (0 = all available)")
    p.add_argument("-profile", action="store_true",
                   help="capture a torch.profiler trace (Chrome trace in "
                        "<out>/profile) of the first 20 steps")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-s", "--seed", type=int, default=-1)
    p.add_argument("-platform", default=None,
                   help="torch device to run on (e.g. 'cpu'); the default is "
                        "the CUDA card")
    return p


def _exp_name(args) -> str:
    name = os.path.basename(os.path.normpath(args.molecule))
    n = args.n_samps
    samp = (
        f"{int(n)}" if n < 1e3 else f"{int(n/1e3)}k" if n < 1e6
        else f"{int(n/1e6)}M" if n < 1e9 else f"{int(n/1e9)}B"
    )
    out = os.path.join("data", "naqs", f"{name}_{samp}_samps")
    if args.no_amp_sym:
        out += "_noAmpSym"
    if args.phase_sym:
        out += "_phaseSym"
    if args.no_restrictedH:
        out += "_no_restrictedH"
    if args.no_mask_psi:
        out += "_no_mask_psi"
    elif args.full_mask_psi:
        out += "_full_mask_psi"
    return out


def _n_devices(parser, args, device) -> int:
    """-devices as a count of ranks: 0 is every card (one process on the
    CPU); more than the cards seen is an error."""
    import torch

    if device.type != "cuda":
        return args.devices or 1
    count = torch.cuda.device_count()
    if args.devices > count:
        parser.error(f"-devices {args.devices}: this machine has {count} CUDA card(s)")
    return args.devices or count


def run(args=None) -> dict:
    parser = get_parser()
    argv = sys.argv[1:] if args is None else list(args)
    args = parser.parse_args(argv)
    if args.no_mask_psi and args.full_mask_psi:
        parser.error("at most one of -no_mask_psi / -full_mask_psi")

    import torch.distributed as dist

    from naqs_tpu_torch.parallel import initialize_distributed, rank_device
    from naqs_tpu_torch.parallel.multihost import backend_for
    from naqs_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    n_dev = _n_devices(parser, args, device)
    out_root = args.out or _exp_name(args)
    seed = args.seed if args.seed >= 0 else int(time.time()) % 100000
    rank = 0
    if n_dev > 1:
        if not initialize_distributed(device=device):
            from naqs_tpu_torch.parallel.launch import spawn

            # the ranks take this process's seed: their models start the same
            return spawn(run, n_dev, (argv + ["-s", str(seed)],), workdir=out_root,
                         backend=backend_for(device), show_rank0=True)[0]
        if dist.get_world_size() != n_dev:
            parser.error(f"-devices {n_dev} in a process group of {dist.get_world_size()} ranks")
        rank = dist.get_rank()
        device = rank_device("cpu" if device.type == "cpu" else None)
        if device.type == "cuda":
            import torch

            torch.cuda.set_device(device)
        seeds = [seed]
        dist.broadcast_object_list(seeds, src=0)   # rank 0's, under torchrun too
        seed = seeds[0]
    with contextlib.ExitStack() as quiet:
        if rank:   # rank 0 alone prints
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        return _train(args, device, n_dev, rank == 0, out_root, seed)


def _train(args, device, n_dev: int, writer: bool, out_root: str, seed: int) -> dict:
    """The runs of `run` on this process's device; only the writer (rank 0)
    writes files."""
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.models.nade import NAQSConfig, count_parameters
    from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer
    from naqs_tpu_torch.utils.plotting import CHEM_ACC, plot_training

    mol = nt.load_molecule(args.molecule, hamiltonian_fname=args.hamiltonian_fname)
    print(f"Loaded {mol.name}: {mol.n_qubits} qubits, {mol.n_electrons} electrons, "
          f"{len(mol.qubit_hamiltonian)} Pauli terms; device {device}")
    for lab, e in [("HF", mol.hf_energy), ("MP2", mol.mp2_energy),
                   ("CCSD", mol.ccsd_energy), ("FCI", mol.fci_energy)]:
        if e is not None:
            print(f"  {lab:5s} energy: {e:.6f} Ha")

    results = {}
    for run_i in range(args.number):
        out_dir = out_root if args.number == 1 else f"{out_root}_{run_i}"
        os.makedirs(out_dir, exist_ok=True)
        if writer:
            with open(os.path.join(out_dir, "args.json"), "w") as f:
                json.dump({**vars(args), "resolved_seed": seed + run_i}, f, indent=2)

        n_exc = args.n_excitations_max if args.n_excitations_max >= 0 else None
        if args.no_restrictedH:
            # unrestricted: the model is unmasked and the Hamiltonian space
            # fixes only the TOTAL electron count
            hilbert = nt.Hilbert.full_n_up(mol.n_qubits, mol.n_electrons, n_exc_max=n_exc)
        else:
            hilbert = nt.Hilbert.for_molecule(mol, restrict_to_ms=True)
            if n_exc is not None:
                hilbert = nt.Hilbert(n_qubits=hilbert.n_qubits, sectors=hilbert.sectors,
                                     n_exc_max=n_exc)
        m_s = abs(mol.n_alpha_electrons - mol.n_beta_electrons) // 2
        # fixed-m_s open-shell runs train without amplitude spin symmetry
        use_amp_spin_sym = not args.no_amp_sym and m_s == 0
        print(f"Hilbert: sectors={hilbert.sectors}, {hilbert.size} valid states")

        masking = ("none" if args.no_mask_psi or args.no_restrictedH else
                   "full" if args.full_mask_psi else "partial")
        n_hid_phase = args.n_hid_phase if args.n_hid_phase > 0 else args.n_hid
        n_layer_phase = args.n_layer_phase if args.n_layer_phase > 0 else args.n_layer
        s = mol.n_qubits // 2
        if args.qubit_ordering == 1:
            shell_order = tuple(range(s))
        elif args.qubit_ordering == -1:
            shell_order = tuple(range(s - 1, -1, -1))
        else:
            shell_order = tuple(np.random.default_rng(seed).permutation(s).tolist())

        cfg = NAQSConfig(
            n_qubits=mol.n_qubits,
            sectors=hilbert.sectors,
            masking=masking,
            amp_hidden=(args.n_hid,) * args.n_layer,
            phase_hidden=(n_hid_phase,) * n_layer_phase,
            use_amp_spin_sym=use_amp_spin_sym,
            use_phase_spin_sym=args.phase_sym,
            aggregate_phase=not args.single_phase,
            num_lut=args.n_lut,
            combined_amp_phase=args.comb_amp_phase,
            shell_order=shell_order,
            input_encoding=args.input_encoding,
        )

        terms = _load_or_compile_terms(args, mol, n_exc, writer)
        train_terms = None
        if args.s2_penalty > 0:
            # training operator H + lam * S^2; `terms` stays pure H for
            # solve_H and the exact energies
            from naqs_tpu_torch.utils.spin import penalized_termdict

            td = penalized_termdict(mol.qubit_hamiltonian, mol.n_qubits, args.s2_penalty)
            train_terms = nt.compile_pauli_terms(td, mol.n_qubits, n_excitations_max=n_exc)
            print(f"S^2 penalty: training on H + {args.s2_penalty}*S^2 "
                  f"({len(td)} merged Pauli terms)")

        use_default_schedule = args.lr < 0
        if args.sample_beta != 1.0 and not args.weight_by_psi:
            # tempered counts are multiplicities under p^beta, not p
            print(f"sample_beta={args.sample_beta}: enabling -weight_by_psi "
                  "(exact |psi|^2 weights keep the estimator unbiased)")
            args.weight_by_psi = True
        if not (0.0 < args.sample_beta <= 1.0):
            raise SystemExit("-sample_beta must be in (0, 1]")
        tc = TrainConfig(
            n_train=args.n_train,
            lr=1e-3 if use_default_schedule else args.lr,
            lr_final=5e-4 if use_default_schedule else args.lr,
            use_lr_schedule=use_default_schedule,
            lr_lut=args.lr_lut,
            n_samples=args.n_samps,
            n_samples_max=args.n_samps_max,
            n_unq_samples_min=args.n_unq_samps_min,
            n_unq_samples_max=args.n_unq_samps_max,
            reweight_by_psi=args.weight_by_psi,
            sample_beta=args.sample_beta,
            exact_eloc=args.exact_eloc,
            use_sr=args.sr,
            sr_damping=args.sr_damping,
            sr_cg_iters=args.sr_cg_iters,
            sr_kl_clip=args.sr_kl_clip if args.sr_kl_clip > 0 else None,
            sr_fisher_mix=args.sr_fisher_mix,
            use_kfac=args.kfac,
            kfac_damping=args.kfac_damping,
            seed=seed + run_i,
        )
        trainer = VMCTrainer(cfg, terms, hilbert, tc, device=device, save_loc=out_dir,
                             train_terms=train_terms, n_devices=n_dev)
        print(f"Model parameters: {count_parameters(trainer.model)}")
        target_s2 = args.ws_spin * (args.ws_spin + 1.0) if args.ws_spin >= 0 else None

        log_exact = args.presolveH and mol.n_qubits < 28
        if args.presolveH and hilbert.size < 50000:
            from scipy.sparse.linalg import eigsh

            from naqs_tpu_torch.hamiltonian import assemble_sparse_hamiltonian_np

            H = assemble_sparse_hamiltonian_np(terms, hilbert.basis)
            e0 = float(eigsh(H, k=1, which="SA")[0][0])
            print(f"Pre-solved ground state: {e0:.6f} Ha (stored FCI: {mol.fci_energy})")
            results["presolve_e0"] = e0

        warm_loaded = False
        if args.load:
            # the model only: a warm start begins with fresh optimizer state
            trainer.save_loc = args.load
            trainer.load(params_only=True)
            trainer.save_loc = out_dir
            warm_loaded = True
        if args.cont and any(os.path.exists(os.path.join(out_dir, f"checkpoint.{ext}"))
                             for ext in ("pt", "msgpack")):
            trainer.load()
        elif warm_loaded:
            # a -l warm start IS the initialization: no pre-training, and the
            # source run's step count, log and counter stay with that run
            trainer.n_steps = 0
            trainer.run_time = 0.0
            trainer.log = {k: [] for k in trainer.log}
            trainer.sampled_counter.clear()
        else:
            if args.n_pretrain > 0:
                print(f"Pre-flattening for {args.n_pretrain} epochs...")
                trainer.pre_flatten(args.n_pretrain)
            if args.pretrain_hf > 0:
                print(f"HF pre-training for {args.pretrain_hf} epochs...")
                trainer.pre_train_hf(args.pretrain_hf)
        if args.resetOpt:
            trainer._new_optimizer()

        print("Training...")
        save_freq = args.save_freq if args.save_freq > 0 else None
        if args.profile:
            from naqs_tpu_torch.utils.profiling import profile_trace

            with profile_trace(os.path.join(out_dir, "profile")):
                trainer.run(min(20, args.n_train), output_freq=args.output_freq)
        # profiled steps count towards the budget, so the LR boundary stays
        # where a run without -profile puts it
        n_remaining = max(args.n_train - trainer.n_steps, 0)
        if args.exact_sampling:
            if args.ws_solve_h > 0 and trainer.n_steps < args.ws_solve_h:
                trainer.run_exact(args.ws_solve_h - trainer.n_steps,
                                  output_freq=args.output_freq, save_freq=save_freq)
                # exact mode feeds no sampled counter: the warm start solves
                # over the whole (enumerable) basis
                e_sub, n_sub = trainer.warm_start_from_solve_h(
                    states=hilbert.basis, target_s2=target_s2, n_epochs=args.ws_epochs,
                    loss=args.ws_loss)
                print(f"solve_H warm start (exact mode): E0={e_sub:.6f} Ha over {n_sub} "
                      "basis states", flush=True)
            trainer.run_exact(max(args.n_train - trainer.n_steps, 0),
                              output_freq=args.output_freq, save_freq=save_freq)
        elif args.sample_dP > 0:
            trainer.run_density(n_remaining, output_freq=args.output_freq, d_p=args.sample_dP)
        elif args.ws_solve_h > 0 and trainer.n_steps < args.ws_solve_h:
            # train, re-target at the sampled-subspace ground state, polish
            trainer.run(args.ws_solve_h - trainer.n_steps, output_freq=args.output_freq,
                        log_exact_energy=log_exact, save_freq=save_freq)
            ws_states = hilbert.basis if args.ws_full_basis else None
            e_sub, n_sub = trainer.warm_start_from_solve_h(
                states=ws_states, target_s2=target_s2, n_epochs=args.ws_epochs,
                loss=args.ws_loss)
            print(f"solve_H warm start: subspace E0={e_sub:.6f} Ha over {n_sub} "
                  + ("basis" if args.ws_full_basis else "most-sampled") + " states",
                  flush=True)
            trainer.run(max(args.n_train - trainer.n_steps, 0), output_freq=args.output_freq,
                        log_exact_energy=log_exact, save_freq=save_freq)
        else:
            trainer.run(n_remaining, output_freq=args.output_freq,
                        log_exact_energy=log_exact, save_freq=save_freq)
        trainer.save()

        try:
            # a full-basis warm start's result (kept in the checkpoint)
            # depends only on (H, basis): reuse it
            if trainer.ws_result is not None and (args.exact_sampling or args.ws_full_basis):
                e_fci_sub, n_unq = trainer.ws_result
                n_unq = int(n_unq)
            elif args.exact_sampling:
                # no sampled counter in exact mode: solve over the basis
                e_fci_sub, n_unq = trainer.solve_h(states=hilbert.basis, target_s2=target_s2)
            else:
                e_fci_sub, n_unq = trainer.solve_h(n_samps=trainer.n_samples,
                                                   k_max=args.solve_h_kmax,
                                                   target_s2=target_s2)
        except Exception as exc:
            print(f"(solve_H failed: {exc})")
            e_fci_sub, n_unq = None, 0
        e_loc_hist = np.asarray([v for _, v in trainer.log["E_LOC"]])
        window = min(25, max(len(e_loc_hist), 1))
        e_smooth = (np.convolve(e_loc_hist, np.ones(window) / window, "valid")
                    if len(e_loc_hist) >= window else e_loc_hist)
        # trailing-window mean: an unbiased estimate of the final-state
        # energy (the min of a noisy series is biased low)
        e_loc_trail = float(e_loc_hist[-window:].mean()) if len(e_loc_hist) else None

        summary = {
            "molecule": mol.name,
            "seed": seed + run_i,
            "e_loc_min": float(e_loc_hist.min()) if len(e_loc_hist) else None,
            "e_loc_smoothed_min": float(e_smooth.min()) if len(e_smooth) else None,
            "e_loc_trailing_mean": e_loc_trail,
            "e_vmc_fci_subspace": e_fci_sub,
            "n_unique_final": n_unq,
            "hf_energy": mol.hf_energy,
            "ccsd_energy": mol.ccsd_energy,
            "fci_energy": mol.fci_energy,
        }
        # the exact <H> over the basis only for moderate spaces
        if hilbert.size <= 200_000:
            try:
                summary["e_exact_final"] = trainer.exact_energy()
            except Exception as exc:
                print(f"(exact-energy evaluation failed: {exc})")
        summary["vmc_estimator"] = (
            "exact_psi_H_psi" if "e_exact_final" in summary else "e_loc_trailing_mean"
        )
        for lab, e in [("vmc", summary.get("e_exact_final", e_loc_trail)),
                       ("vmc_fci", e_fci_sub)]:
            if e is None or mol.fci_energy is None:
                continue
            summary[f"{lab}_below_hf"] = bool(e < mol.hf_energy)
            summary[f"{lab}_below_ccsd"] = bool(mol.ccsd_energy and e < mol.ccsd_energy)
            summary[f"{lab}_chem_acc"] = bool(e < mol.fci_energy + CHEM_ACC)

        print("\n---------- Summary ----------")
        for k, v in summary.items():
            print(f"  {k}: {v}")
        trainer.save_log()
        if writer:
            with open(os.path.join(out_dir, "summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
            try:
                plot_training(trainer, mol, fname=os.path.join(out_dir, "training.png"))
            except Exception as exc:  # plotting must never kill a finished run
                print(f"(plotting failed: {exc})")
        results[f"run_{run_i}"] = summary
    return results


_TERM_ARRAYS = ("diag_yz", "diag_coeff", "xy", "yz", "coeff", "xy_unique", "gxy",
                "yz_unique", "gyz")


def _load_or_compile_terms(args, mol, n_exc, writer: bool = True):
    """The compiled terms, from data/terms_cache/ with -loadH where the
    cache's fingerprint (the molecule's HF energy) matches, else compiled
    (and cached with -overwriteH)."""
    import naqs_tpu_torch as nt
    from naqs_tpu_torch.hamiltonian import PauliTerms

    cache = None
    if args.loadH or args.overwriteH:
        tag = f"_{n_exc}exc" if n_exc is not None else ""
        # the full molecule path in the key: basenames collide across
        # geometry families
        base = os.path.normpath(args.molecule).replace(os.sep, "__")
        cache = os.path.join("data", "terms_cache", f"{base}{tag}_terms.npz")
    # content fingerprint: a cache written for another geometry under a
    # colliding key would train against the wrong Hamiltonian
    fp = float(getattr(mol, "hf_energy", 0.0) or 0.0)
    if args.loadH and cache and os.path.exists(cache):
        with np.load(cache) as z:
            cached_fp = float(z["fingerprint"]) if "fingerprint" in z.files else None
            if cached_fp is None or abs(cached_fp - fp) < 1e-9:
                # masks as int64 (a cache the JAX package wrote holds uint64)
                arrays = {k: z[k].view(np.int64) if z[k].dtype == np.uint64 else z[k]
                          for k in _TERM_ARRAYS}
                terms = PauliTerms(n_qubits=int(z["n_qubits"]), **arrays)
                if cached_fp is None:
                    print(f"Loaded compiled terms from {cache} "
                          "(no fingerprint — pre-guard cache)")
                else:
                    print(f"Loaded compiled terms from {cache}")
                return terms
            print(f"Cache {cache} fingerprint mismatch ({cached_fp} != {fp}); recompiling")
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits,
                                   n_excitations_max=n_exc)
    if args.overwriteH and cache and writer:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, n_qubits=terms.n_qubits, fingerprint=fp,
                 **{k: getattr(terms, k) for k in _TERM_ARRAYS})
        print(f"Cached compiled terms to {cache}")
    return terms


def main():
    run()


if __name__ == "__main__":
    main()
