#!/usr/bin/env python3
"""Quickest proof that naqs_tpu_torch runs on a CUDA card, end to end.

    python3 chip_smoke.py            # one card; the whole check
    python3 chip_smoke.py --profile  # also one torch.profiler-traced step
                                     # per E_loc engine (factored, rank,
                                     # staircase, sort)
    python3 chip_smoke.py --before DIR  # also time an earlier slice's
                                        # kernels, unpacked at DIR, in turns
                                        # with this tree's

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build every CUDA kernel with nvcc (one nvcc per source, started
     together): csrc/rank_gather.cu (with the rank engine's one-launch E_loc
     and quadratic form), csrc/grid_engine.cu (the factored cells, dense and
     staircase accumulations), csrc/sampler_step.cu, csrc/sort_lookup.cu (the
     sort engine's lookups, its one-launch E_loc and quadratic form; the
     one-launch kernels' shared body is csrc/row_energy.cuh) and
     csrc/offdiag_h.cu (the per-term H row);
  2. print the card's name and power limit (nvidia-smi);
  3. set up H2O 6-31G (26 qubits, sector (5, 5), 1,656,369 states) and the
     paper-scale model (amp 64, phase 512x512, global phase net, partial
     masking) with random weights from a seed, capacity 100,000. The default
     dispatch must carry a FactorTerms grid program; the rank engine is the
     same DeviceTerms with dense=None;
  4. the rank engine's chunk kernels (on no path since the one launch took
     the dense-A calls) on the real packed value table at their chunk shape
     (C=512, Kxy=4,608): rank_gather2 bitwise against its plain version,
     rank_ratio_rowsum with the real h (P @ A, as the chunk loop formed it)
     per row within ROWSUM_ATOL + ROWSUM_RTOL * sum_k |h| |r| (fp32
     summation order over 4,608 terms, expf/sincosf ulps);
  5. factored_cells_accumulate on the real sampled grid over the whole
     capacity-100,000 buffer (the rows E_loc reads: the first n_unique)
     against its plain version, per row within GRID_ATOL + GRID_RTOL * sum_k
     sum_r |fcoeff| |T_k| (fp32 order over up to 4,502 masks, fma against mul
     + add), every other row exactly 0, and twice bitwise; the work its bound
     counts on this call's data (_cells_work);
 5b. the sampler's shell step on real inputs: two sample() calls at capacity
     100,000 (one at the trainer's first n_samples, which overflows, one at
     1e5, the steady state) with the inputs of every shell kept; on each of
     the 26 shells split_and_compact (the shell step sample() runs: split and
     compaction in one launch, gated on the previous shell's count), with its
     f32 and its f64 instantiation (the shell's probs as float64), against
     its plain version and against itself run twice, multinomial4_split
     against its plain version and compact_children against its plain
     version on the plain split's outputs, all bitwise (should a
     transcendental's last bit differ, the split is held instead to: row sums
     exact, at most 1 row in 10^4 differs, each by one sample moved between
     two children; the count is printed; split_and_compact has no such
     allowance); the binomials by branch and the longest CDF loop; a
     synthetic split of 100,000 rows that takes the CDF branch everywhere (n
     = 20..5,000, p from 1e-4 to 0.9, the p > 1/2 flip) plus corner rows (q =
     0 and 1, n = 0 and 1e12, all-zero probs), through both split kernels;
     an overflowing compaction through both compaction kernels; a shell step
     of 1,000,003 rows, more tiles than the card holds blocks at once; the
     steady-state shell with the most live rows captured in a CUDA graph and
     replayed 3 times, bitwise equal to an eager call; and one
     sample_density call (d_p = 1e-6) through compact_children against the
     same call through the plain version: states and masses bitwise. Then
     the decomposition of the split's time (naqs_tpu_torch/tools/
     split_timing.py, held, in turns): an empty launch of its grid, every row
     dead, every live row Gaussian, the steady-state shell with the most live
     rows and the synthetic all-CDF split through multinomial4_split, and
     split_and_compact on that shell, this tree's and, with --before, DIR's
     (first held bitwise against this tree's), with what each input asks of
     the inverse CDF (looks, the longest chain of a warp); and the proof that
     the split's division by k (Markstein's correction from RN(1/k) where the
     dividend is +0 or within 2^-100..2^100, else __fdiv_rn) gives
     __fdiv_rn's bits on every float and every k = 1..128;
  6. the main path: 5 VMCTrainer.step()s through the default dispatch with
     every launch count set to 0 just before; fails unless
     factored_cells_accumulate ran exactly once per E_loc call (one call per
     vmc_update) and no other grid kernel ran, split_and_compact ran
     n_shells = 13 times per sample() call and the standalone
     multinomial4_split and compact_children never, no rank kernel ran, and
     every energy is finite;
  7. the earlier main path: 2 more steps of the same trainer on the rank
     engine (dense=None, its dense A kept), counts set to 0 just before;
     fails unless rank_local_energy ran once per E_loc call (the chunk loop
     ran rank_ratio_rowsum 196 times a call), split_and_compact 13 times per
     sample() call, and nothing else;
 7b. the sort engine with the dense A at the paper's width: SORT_A_STEPS
     steps of the same trainer with rank_spec=None and dense=None (as a
     space over 32 qubits, or NAQS_TPU_RANK_MAX below the sector, gives
     it), the counts at 0 before; fails unless sorted_local_energy ran once
     per E_loc call, split_and_compact 13 times per sample() call and
     nothing else (no sorted_ratio_rowsum); then one step under
     torch.profiler: its wall and device time;
  8. quadratic_energy over the sampled buffer on the rank engine with its
     dense A, the counts set to 0: one rank_quadratic_energy launch and
     nothing else, within 1e-6 relative of the chunk loop of before composed
     through rank_gather2_ref (the plain gather, P @ A, the eager epilogue);
  9. on one batch: local_energy through the rank kernel (rank_local_energy)
     against the same call through its plain version (per row within
     rank_local_energy_tolerance);
     local_energy through FactorTerms against the rank engine per live row
     within 2e-4 Ha (the grid engines clip the amplitude ratio per row, the
     rank engine per pair; the JAX package's own bar between its engines);
     and 8 rows of each against the float64 host oracle local_energy_np
     (5e-4 Ha: fp32 off-diagonal sums);
 10. the dense engine: N2 STO-3G (20 qubits, sector (7, 7), 14,400 states;
     DenseTerms asserted), a smaller model, capacity 8,192: 3 steps with the
     counts at 0 before (dense_grid_accumulate once per E_loc call,
     split_and_compact 10 times per sample() call, the standalone sampler
     kernels never),
     dense_grid_accumulate against its plain version and twice bitwise, and
     local_energy against the rank engine and the oracle as in phase 9;
 10b. the staircase engine: Li2O STO-3G CISDTQ (30 qubits, sector (7, 7),
     at most XL_EXC = 4 excitations in the space and X/Y sites in the
     terms; naqs_tpu_torch/data/Li2O_STO-3G_gen.npz), the paper-scale model
     of phase 3, capacity 100,000. The dispatch must carry FactorTermsXL
     with 644,365 cells; 3 steps with the counts at 0 before (xl_grid_accumulate
     once per E_loc call, split_and_compact 15 times per sample() call, no
     other kernel); the share of a sampled batch's weight outside the
     staircase; xl_grid_accumulate on that batch's grid against its plain
     version per cell (grid_tolerance) and twice bitwise; the grid's set cells
     and set (mask, cell) pairs and the kernel's schedule on it (chunks staged,
     entries listed, pairs probed), and the same on a grid of every staircase
     cell set (the whole filtered basis, as local_energy over it sets it),
     the kernel there against its plain version too; with --before, DIR's
     xl_grid_accumulate within grid_tolerance of this tree's on the sampled
     grid; local_energy through
     FactorTermsXL against the rank engine on XL_QUERIES staircase rows as
     queries= over a buffer of the batch's staircase states (ENGINE_TOL), and
     8 staircase rows of the sampled buffer against local_energy_np with psi
     zeroed outside the restricted rectangle (ELOC_TOL);
 10c. the sort engine, for spaces with no RankSpec. On phase 8-9's H2O 6-31G
     batch: local_energy through it with the dense A (rank_spec=None,
     dense=None) one sorted_local_energy launch, within ENGINE_TOL of the rank
     engine per live row and bitwise equal to the same call with no dense A
     (a_mat=None), and quadratic_energy one sorted_quadratic_energy launch
     within QUAD_RTOL of phase 8's, no other kernel; the chunk loops the
     engine ran with the dense A before (per chunk of 512, P @ A +
     sorted_ratio_rowsum, and sorted_gather2 + P @ A + the eager epilogue,
     this tree's kernels) held against both (the loop within phase 9's
     per-row tolerance of the rank engine), and the rank engine's own chunk
     loops of before (P @ A + rank_ratio_rowsum, rank_gather2 + P @ A + the
     epilogue, per chunk of 512) against its one launch (phase 9's per-row
     tolerance, QUAD_RTOL), then both designs of each engine's two calls in
     turns, SLOW_REPEATS of 1, held and unheld (with --before DIR, DIR's own
     calls too, first held against this tree's), with the rank engine's calls
     with a_mat=None beside them; fails unless each one launch is the
     faster. The rank
     engine with no dense A (a_mat=None) on the same batch: local_energy one
     rank_local_energy launch and nothing else and quadratic_energy one
     rank_quadratic_energy launch, both bitwise equal to the calls with the
     dense A; rank_quadratic_energy against its
     plain version per row (num and w within rank_quadratic_energy_tolerance)
     and twice bitwise. Then N2 6-31G
     (naqs_tpu_torch/data/N2_6-31G_gen.npz: 36 qubits, sector (7, 7) of
     1,012,766,976 states, 137,872 terms; the dispatch must carry no RankSpec,
     no grid program and no dense A) with the paper-scale model of phase 3 and
     capacity 100,000: offdiag_h_terms (per entry within offdiag_tolerance),
     sorted_ratio_rowsum (per row within rowsum_tolerance) and sorted_gather2
     (bitwise) against their plain versions on a real chunk (C=128,
     Kxy=27,392), each twice bitwise; sorted_local_energy on the whole sampled
     buffer (capacity 100,000) per row within sorted_local_energy_tolerance of
     its plain version, within that bound without the H entries' term of this
     tree's offdiag_h_terms + sorted_ratio_rowsum composed over the 782 chunks,
     twice bitwise, and through local_energy(queries=) with two SENTINEL rows
     after each of 2,048 live ones (those rows e_im 0 and e_re their diagonal,
     the live rows bitwise as in the whole call, one launch); N2_STEPS training
     steps with the counts at 0 before (sorted_local_energy once per
     local_energy call, split_and_compact 18 times per sample() call, no
     other kernel); 8 rows of a fresh batch against local_energy_np
     (ELOC_TOL); quadratic_energy on that batch with the counts at 0 before
     (one sorted_quadratic_energy launch, no other kernel; the earlier design ran 782
     chunks of sorted_gather2 and offdiag_h_terms) within QUAD_RTOL of the same
     call through its plain version, and the kernel against its plain version
     per row (sorted_quadratic_energy_tolerance) and twice bitwise;
 10d. frozen-core N2 6-31G: freeze_core(N2 6-31G's terms of 10c, 4), 32
     qubits, sector (5, 5) of 19,079,424 states, 87,628 terms; the dispatch
     must carry a RankSpec, no grid program and no dense A (the rank engine's
     one-launch rank_local_energy); the paper-scale model of phase 3, capacity
     100,000: rank_local_energy on a sampled buffer per row within
     rank_local_energy_tolerance of its plain version, on the live rows within
     that bound without the H entries' term of this tree's offdiag_h_terms +
     rank_ratio_rowsum composed over the 391 chunks the parent ran, padding
     rows their diagonal and 0, twice bitwise; what the call tests and reads
     (pairs inside a sector, distinct table rows, found pairs); FROZEN_STEPS
     training steps with the counts at 0 before (rank_local_energy once per
     local_energy call, split_and_compact once per shell, no other kernel).
     The host layer: the native library builds, its COO assembly
     of N2 STO-3G's 14,400-state sector equals numpy's, and the ground state of
     assemble_sparse_hamiltonian_np is the stored FCI energy within 1e-6 Ha;
 11. times, in turns: REPEATS repeats of LAUNCHES launches each (median and
     min-max of the repeats) of rank_gather2, its plain version, the library
     gather tab[idx] on a precomputed idx, rank_ratio_rowsum, its plain
     version, the unfused composition (rank_gather2 kernel + eager epilogue)
     and of the sampler's kernels on the inputs of the steady-state shell
     with the most live rows (split_and_compact, torch's zero_ of its one
     allocation (what its clear costs the card), and in turns with it this
     tree's two-kernel composition multinomial4_split + compact_children on
     the same inputs; then its wrapper's host side unheld: the input checks,
     the one allocation, the whole call), the compaction's plain version (the
     cumsum/index_copy_ composition the step ran before the kernel),
     torch.masked_select of the weights, three torch.binomial calls on the
     cascade's (n, p) (another algorithm for the same distribution: a
     reference time) and dense_grid_accumulate on N2's grid. With --before
     DIR, in the same turns, the kernels of the tree unpacked at DIR, each
     built from DIR's own source into DIR's build/ and called through DIR's
     own wrapper: the first
     slice's two-channel rank_gather2 (first held bitwise against this
     tree's), alone and with the eager epilogue, where DIR's rank_gather2
     takes two tables; dense_grid_accumulate (first held against its plain
     version, per cell within its tolerance) where DIR's grid_kernels has
     it; compact_children (first held bitwise against this
     tree's), its split + compaction (two launches, first held bitwise
     against split_and_compact) and its own split_and_compact (first held
     bitwise against this tree's) where DIR has csrc/sampler_step.cu. Then
     SLOW_REPEATS repeats of SLOW_LAUNCHES of the factored cells and
     staircase kernels, the staircase kernel also on the grid of every
     staircase cell and on a fully set grid of the rectangle (with --before,
     DIR's factored kernel: its whole-grid factored_grid_accumulate, first
     held read at the live cells within grid_tolerance of this tree's rows,
     or its factored_cells_accumulate on the same rows, first held bitwise
     where its source is this tree's, else within grid_tolerance; a DIR with
     csrc/grid_engine.cu and neither exits non-zero; DIR's
     factored_local_energy on the same call, and DIR's staircase kernel on
     all three grids), the grid kernels' plain versions, one
     factored_local_energy call and one full local_energy call per engine at
     capacity 100,000 (rank on H2O 6-31G, and FactorTermsXL against rank on
     Li2O: printed, not asserted), the split's plain version, the fused
     shell step's plain version, the (U, 127)
     cumprod/cumsum split the step ran before the kernel, and one whole
     sample() call at capacity 100,000 (with --before, also DIR's sample()
     on the same model, in turns). Then REPEATS repeats of SORT_LAUNCHES of
     the sort engine's three kernels on N2 6-31G's chunk, their plain versions
     and the library calls beside them (torch.searchsorted of the coupled
     states and a gather; Tensor.index_add of the products computed
     beforehand), held and unheld; REPEATS of ENERGY_LAUNCHES of
     sorted_local_energy on the N2 call, held and unheld; SLOW_REPEATS of one
     of it in turns with this tree's offdiag_h_terms + sorted_ratio_rowsum
     composed over the 782 chunks (with --before, DIR's too, first held
     against the kernel within the composition's bound) and with its plain
     version, held and unheld; and
     SLOW_REPEATS unheld repeats of one whole N2 6-31G local_energy call,
     through the kernel (first held against the call through its plain
     version within ENGINE_TOL) and, with --before, through DIR's chunk loop.
     The one-launch kernels of the spaces with no dense A: the chunk loops
     they replaced first held against them (this tree's kernels composed as
     the parent ran them; with --before DIR, DIR's own chunk loop and
     quadratic_energy), REPEATS of ENERGY_LAUNCHES of each kernel held and
     unheld, then SLOW_REPEATS of 1 in turns of each kernel, the chunk loop it
     replaced and the whole quadratic_energy calls (N2 6-31G; H2O 6-31G with
     and without a dense A; with --before, DIR's), held and unheld (each
     plain version: the wall time of its one call in the checks above, between
     two synchronizes); SLOW_REPEATS unheld of one whole frozen-core N2
     local_energy call, this tree's and, with --before, DIR's chunk loop.
     Each is
     timed held (behind a card sleep of twice its unheld run in the warm-up,
     so the launches run back to back: the card's time, reported as "ms");
     the fast ones also unheld (a plain loop, which reads the host's rate
     where the wrapper is slower than the kernel: "unheld_ms"), and the run
     fails if the hold did not outlast their unheld runs; see
     naqs_tpu_torch/utils/cuda_timing.py.
 12. the trainer's extras at the paper width on phase 3's H2O 6-31G, in a
     temporary working directory, each sub-phase timed on the wall clock: a
     fresh trainer (capacity 100,000, grad_clip_factor CLIP_FACTOR);
     pre_train_hf for HF_EPOCHS epochs (the HF state's -log|psi| must fall),
     pre_flatten for one epoch over the 1,656,369-state basis at batch 2^17;
     EXTRAS_STEPS clipped steps, each update's pre-clip norm, scale and
     whether the clip's ring moved printed (it must move on every applied
     update and on no withheld one, and a forced overflow update must leave
     it as it was), the record steps' and the other steps' times and the
     record's own; the counter equal to the sums of the recorded batches,
     which are the record steps' batches; solve_h over the counter's top
     SOLVE_K states, E0 at or below the lowest diagonal element and within
     1e-8 Ha of the ground state of H assembled by numpy and by the native
     library; exact_energy over the basis (one rank_quadratic_energy launch
     and nothing else), timed whole and in its two parts, log_psi over the
     basis and quadratic_energy, before and after warm_start_from_solve_h
     (WS_EPOCHS epochs,
     overlap loss); a trainer with train_terms = H + S2_PENALTY S^2 (built
     with NAQS_TPU_DENSE=0) whose exact_energy equals the plain trainer's
     within 1e-9 Ha on the same parameters; pre_train_hf for
     DENSITY_HF_EPOCHS epochs, then DENSITY_STEPS run_density steps
     (compact_children once per shell of every sample_density call, the
     E_loc engine's kernel once per update, nothing else); save, load into
     a fresh trainer (parameters, Adam, clip ring, generator, counter, log
     and controller bitwise equal), and one more step of each (e_loc within
     ENGINE_TOL, whether bitwise equal printed); save_psi on phase 10's N2
     STO-3G trainer (the written amplitudes' squares sum to 1 within 1e-6).
 13. the CLI, `naqs_tpu_torch.cli.run` in process at the paper's width, each
     run into a temporary -o directory with every kernel count set to 0 just
     before it: run A (CLI_RUN_A: H2O 6-31G on FactorTerms, amp 64, one
     global phase net 512x512, four LUT shells at -lr_lut 1e-2, training on
     H + 0.5 S^2, -pretrain_hf 5, -presolveH, 6 steps; exact energies at
     steps 1 and 5) must write summary.json (no e_exact_final: 1,656,369
     states), args.json, log.jsonl and checkpoint.pt, change all four LUT
     tables and launch split_and_compact, factored_cells_accumulate and
     rank_quadratic_energy; -c then resumes it from checkpoint.pt for one
     step; run B
     (CLI_RUN_B: N2 STO-3G on DenseTerms, the combined trunk, integer inputs,
     three LUT shells, -presolveH, -profile, 6 steps) must write those and a
     Chrome trace, give e_exact_final and launch split_and_compact,
     dense_grid_accumulate and rank_quadratic_energy. Every step's E_loc must be
     finite. It prints each step's wall time, each run's, the launches of
     every kernel, and the per-step cost against phases 6 and 10.
 14. exact mode at the paper width (phase 3's model and configuration,
     random weights from seed 0), with every count set to 0 before each
     driven call and its launches summed into "launches_exact": 14a a
     VMCTrainer with exact_eloc (eloc_fwd_chunk EXACT_CHUNK: the sector
     table of 26 x 65,536 rows for H2O 6-31G's 1,656,369 states) through
     the default dispatch (FactorTerms), EXACT_STEPS steps (one
     factored_cells_accumulate launch an update), the log_psi_table time, one
     profiled step's device time and busy share; on one recorded batch
     (capacity 100,000) local_energy(queries=) against the full-sector
     table: factored_cells_accumulate on the full-sector grid at the query
     rows against its plain version (grid_tolerance per row; the SENTINEL
     query rows exactly 0; twice bitwise), the call through the plain
     version within the row's tolerance times its amplitude ratio, 8 rows
     against a float64 oracle over the whole basis (ENGINE_TOL); 14b the
     same call on the rank engine (one rank_local_energy) and the sort
     engine (one sorted_local_energy), each against its plain version
     (rank_/sorted_local_energy_tolerance) and within ENGINE_TOL of 14a's,
     the found pairs and bounds recounted (_rank_work, _search_work), the
     three kernels timed in turns (REPEATS x LAUNCHES), EXACT_RANK_STEPS
     steps on the rank engine; 14c Li2O STO-3G CISDTQ with exact_eloc,
     EXACT_XL_STEPS steps (xl_grid_accumulate once an update), the kernel
     on the sector table's grid against its plain version and timed; 14d
     run_exact over the whole basis: vmc_update_scan(n_live=3, length=4)
     against 3 vmc_update calls from the same state (parameters and Adam
     moments within WINDOW_RTOL / WINDOW_ATOL, whether bitwise printed, step
     counts and LR position equal), a window of 2 steps under
     torch.cuda.set_sync_debug_mode("error") (any host sync raises),
     run_exact(EXACT_RUN), a profiled window step's device time, the peak
     device memory, and factored_cells_accumulate on the 1,656,369 live rows
     against its plain version and timed (SLOW_REPEATS x SLOW_LAUNCHES); 14e
     run_exact(EXACT_MINI_STEPS, batch_size=EXACT_BATCH) with exact local
     energies, its minibatches those of np.random.default_rng(seed + 1).
     Then the CLI's run C (CLI_RUN_C: N2 STO-3G, -exact_sampling, 30 steps
     at run A's width): one window of 25 and one of 5, E_LOC for steps 1-30,
     the summary's exact <psi|H|psi> at or above the basis ground state
     (its subspace energy), dense_grid_accumulate once a step; then that
     kernel on the whole basis's grid against its plain version and timed.
 15. the natural-gradient optimizers at the paper width (phase 3's model and
     configuration, random weights from seed 0), every count set to 0 before
     each driven call and its launches summed into "launches_natgrad": 15a
     NATGRAD_STEPS SR steps at the JAX package's defaults (cg_iters 50,
     damping 1e-3; the last with sr_kl_clip SR_KL_CLIP) through FactorTerms,
     one factored_cells_accumulate launch an update and split_and_compact once
     a shell of every sample() call, nothing else; each step's wall time, CG
     iterations, jvp and vjp_fn calls (cg_iters + 1 jvp, one more vjp_fn for
     the gradient, one more of each with the clip), sr_dx_norm and
     grad_norm, step 2 under torch.profiler (its device time and its kernels
     by time), the peak device memory; one sr_update from the batch to its
     readback under torch.cuda.set_sync_debug_mode("error"); the card's S v of
     a seeded v, gradient and update after CUT_CG_ITERS iterations on
     CUT_ROWS live rows against the CPU port's (SV_RTOL, SR_UPDATE_RTOL); 15b
     NATGRAD_EXACT_STEPS SR steps with exact_eloc (the sector table of 26 x
     65,536 rows, factored_cells_accumulate at the query rows once an update);
     15c NATGRAD_STEPS K-FAC steps at its defaults, the factor Grams and solves
     of one update timed on a real batch's taps and their share of a step's
     device time, one kfac_update under the sync check, and the card's factors,
     nu and update on CUT_ROWS rows against the CPU port's (KFAC_RTOL); 15d
     run D of the CLI (CLI_RUN_D: N2 STO-3G on DenseTerms at run A's width),
     -sr for 3 steps, -kfac for 3 and -c resumed for a 4th: finite energies,
     log.jsonl, the K-FAC state read back from checkpoint.pt at step 4.
 16. data parallelism (naqs_tpu_torch/parallel/) at the paper width
     (phase 3's model and configuration), its launches summed over every
     rank into "launches_sharded": 16a a process group of one rank over
     NCCL in this process, one sharded Adam, SR (CUT_CG_ITERS iterations) and
     K-FAC update on a batch at capacity 100,000, each under
     torch.cuda.set_sync_debug_mode("error") with one
     factored_cells_accumulate launch, held against the single-device update
     from the same state on the same batch (SHARD_ADAM_RTOL, SR_UPDATE_RTOL,
     KFAC_RTOL); 16b SHARD_RANKS ranks that share the card over gloo, started
     by naqs_tpu_torch/parallel/launch.spawn and running
     naqs_tpu_torch/tools/shard_drill.rank_run: VMCTrainer(n_devices=2) at
     50,000 rows a rank, SHARD_PLAN's Adam, SR (cg_iters 50) and K-FAC steps,
     each under torch.profiler (wall and device time) with its collectives
     timed on the host's clock and their bytes; the ranks' parameters bitwise
     equal; a fixed pair of batches' Adam update against a one-process
     composition over the merged rows (SHARD_GRAD_RTOL, SHARD_UPDATE_RTOL,
     SHARD_E_TOL); at that pair's merged table, whose states drawn on both
     ranks lie in it twice (there must be some), rank 0's query rows through
     the E_loc kernels of the factored, rank and sort engines
     (factored_cells_accumulate, rank_local_energy, sorted_local_energy)
     against their plain versions per row within phase 9's tolerances
     (grid_tolerance, rank_/sorted_local_energy_tolerance), and against the
     same table without the repeats (the same grid; the row kernels within
     those tolerances); only factored_cells_accumulate and split_and_compact
     launched on each rank in its steps; 16c the same over NCCL across min(count,
     SHARD_MAX_CARDS) cards where torch.cuda.device_count() >= 2, else one line
     saying that it was not run.
With --profile, the profiled step of each engine (H2O 6-31G factored and
rank, Li2O staircase, N2 6-31G sort, frozen-core N2 6-31G rank with no
dense A) must show one device kernel per wrapper call of the
sampler's kernels and of the engine's own; it prints the step's device time
and the card's busy share of the step before it.
Prints a {"kernels": [...]} JSON line (launches from phase 6 for
factored_cells_accumulate, split_and_compact, multinomial4_split and
compact_children (0: the standalone kernels left sample()'s path; their
launches in phase 5b's sample_density call as "launches_sample_density"), 7
for rank_ratio_rowsum (0: on no path, beside its chunk loop's time in turns
with the one launch, 10c), 8 for rank_gather2 (0, likewise), 7's steps for
rank_local_energy's "launches_dense_a_steps", 10 for dense_grid_accumulate, 10b
for xl_grid_accumulate, 10c's N2 steps for sorted_local_energy,
sorted_ratio_rowsum and offdiag_h_terms (0: sorted_ratio_rowsum and
sorted_gather2 are on no path since the sort engine's dense-A calls are one
launch too; their launches in the H2O 6-31G dense-A call of 10c and in the
steps of 7b, 0, stand beside them with the chunk loop's time in turns, and
sorted_local_energy's and sorted_quadratic_energy's entries hold the one
launch's times there; offdiag_h_terms on no path now,
beside which its launches in the N2 quadratic_energy call and the
frozen-core steps stand), its N2 quadratic_energy call for sorted_gather2
and sorted_quadratic_energy, 10c's H2O 6-31G call for
rank_quadratic_energy, 10d's steps for rank_local_energy; phase 12's
exact_energy call for rank_gather2's and rank_quadratic_energy's
"launches_exact_energy" and its
run_density steps for compact_children's "launches_run_density"; the
staircase kernel's bound_ms counts what the function needs on the
sampled grid (the grid cells the valid pairs read, the maps, the program and
the output; the set pairs' operations) and dense_bound_ms the earlier design's
count over every valid pair, beside its times on the staircase and the fully
set grid; the cells kernel's bound counts what this call's data needs (the
valid and found pairs of the live rows, _cells_work), beside one
factored_local_energy call's time; with --before, "before_ms" and
"before_spread" of the earlier tree's kernel; split_and_compact's is DIR's
fused kernel, with its registers by instantiation, the clear's time, its
wrapper's host pieces unheld and whether the graph replays were bitwise;
multinomial4_split's carries the decomposition, DIR's beside it, and the
division proof),
with "launches_cli_a" and "launches_cli_b" from phase 13's runs,
"launches_exact" from phase 14, "launches_cli_c" from run C,
"launches_natgrad" from phase 15 and "launches_sharded" from phase 16 in every
entry, and for the five kernels
phase 14 and run C drive at new shapes
(factored_cells_accumulate at the query rows of the full-sector grid,
"exact_queries_*", and on the whole basis, "full_basis_*";
rank_local_energy, sorted_local_energy, xl_grid_accumulate and
dense_grid_accumulate, "exact_*") the held time, the plain version's, the
error and a bound recounted for that shape's data; and last {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
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
ENGINE_TOL = 2e-4             # Ha per live row, grid engine vs rank engine
XL_EXC = 4                    # Li2O STO-3G CISDTQ: at most 4 excitations
LI2O_CELLS = 644_365          # its staircase cells
XL_QUERIES = 4096             # staircase rows held against the rank engine
QUAD_RTOL = 1e-6              # quadratic_energy, kernel vs plain gather
N2_STEPS = 2                  # training steps of N2 6-31G on the sort engine
SORT_A_STEPS = 2              # training steps of H2O 6-31G on the sort engine with its dense A
SORT_LAUNCHES = 10            # timing of the sort engine's kernels: launches per repeat
ENERGY_LAUNCHES = 5           # timing of sorted_local_energy: launches per repeat
SEARCH_OPS = 3                # integer operations per level of a search: load, compare, select
SECTOR_OPS = 6                # per coupled state of a rank kernel: xor, two and + popcount, compare
FROZEN_STEPS = 3              # training steps of frozen-core N2 6-31G (rank engine, no dense A)
REPEATS, LAUNCHES = 5, 50     # timing: repeats in turns, launches per repeat
SLOW_REPEATS, SLOW_LAUNCHES = 3, 4   # the same for calls of milliseconds and more
CLIP_FACTOR = 1.0             # phase 12: clip to the trailing mean (bites on a rising norm)
EXTRAS_STEPS = 11             # phase 12: clipped steps (the counter records steps 1, 6, 11)
HF_EPOCHS, WS_EPOCHS = 5, 20  # phase 12: pre_train_hf and warm-start epochs
SOLVE_K = 10_000              # phase 12: solve_h's subspace, the counter's top states
S2_PENALTY = 0.5              # phase 12: train_terms = H + 0.5 S^2
DENSITY_STEPS = 2             # phase 12: run_density steps
DENSITY_HF_EPOCHS = 20        # phase 12: pre_train_hf epochs before run_density
RANK_OPS = 25                 # integer ops per element of the kernels' rank_of
EPILOGUE_OPS = 11             # per found element: 3 transcendentals + 8 flops
H100_FP64_OPS_PER_S = 33.5e12  # non-tensor float64: half the float32 rate
# floating-point instructions of the split's operations that are not one
# instruction, before the first EXIT (the path a normal operand takes), by the
# type they work in: counted by naqs_tpu_torch/tools/sass_ops.py in the SASS of
# one-operation probe kernels built with the library's flags (CUDA 12.8,
# sm_90a; an f64 division is MUFU.RCP64H, 7 DFMA, a DMUL and an FFMA test)
SASS_OPS = {"f64_div": {"f64": 9, "f32": 1}, "log1p": {"f64": 55, "f32": 1},
            "sqrt": {"f64": 9, "f32": 0}, "f32_div": {"f64": 0, "f32": 6},
            "expf": {"f64": 0, "f32": 7}}
COMPACT_ROW_OPS = 40          # integer operations per row: flag counts and two scans
SHELL_SRC = {"source": "naqs_tpu_torch/csrc/sampler_step.cu",
             "note": "no Pallas counterpart: XLA-lowered in JAX"}
GRID_SRC = {"source": "naqs_tpu_torch/csrc/grid_engine.cu",
            "note": "no Pallas counterpart: XLA-lowered in JAX"}


def _rank_work(spec, table, s_live, xy, sizes, found_above, chunk=512):
    """What the one-launch rank kernels' work is on these live rows' data: the
    (row, flip mask with terms) pairs, those inside a sector (each reads its
    table row), the distinct table rows read, the found pairs and the terms
    of their groups."""
    import torch

    from naqs_tpu_torch.ops.rank import rank_index

    real = sizes > 0
    xr, sr = xy[real], sizes[real]
    seen = torch.zeros(spec.size + 1, dtype=torch.bool, device=xy.device)
    work = {"pairs": s_live.numel() * xr.numel(), "inside": 0, "found": 0, "terms": 0}
    for i in range(0, s_live.numel(), chunk):
        idx = rank_index(spec, s_live[i:i + chunk, None] ^ xr[None, :])
        inside = idx < spec.size
        seen[idx[inside]] = True
        hit = inside & (table[idx, 0] > found_above)
        work["inside"] += int(inside.sum())
        work["found"] += int(hit.sum())
        work["terms"] += int((hit * sr[None, :]).sum())
    work["rows"] = int(seen.sum())
    return work


def _search_work(table, n_valid, s_live, xy, sizes, chunk=512):
    """The same for the search kernels: the pairs, the found pairs (a flip
    mask with terms), the terms of their groups and the distinct table rows
    found."""
    import torch

    from naqs_tpu_torch.ops.sort_lookup import lookup

    real = sizes > 0
    xr, sr = xy[real], sizes[real]
    work = {"pairs": s_live.numel() * xr.numel(), "found": 0, "terms": 0}
    rows = []
    for i in range(0, s_live.numel(), chunk):
        q = s_live[i:i + chunk, None] ^ xr[None, :]
        hit = lookup(*table, n_valid, q)[0]
        work["found"] += int(hit.sum())
        work["terms"] += int((hit * sr[None, :]).sum())
        rows.append(torch.searchsorted(table[0], q[hit]))
    work["rows"] = int(torch.unique(torch.cat(rows)).numel())
    return work


def _row_bound(work, n_live, cap, n_cols, n_terms, n_diag, lookup_ops, lookup_bytes):
    """bound of a one-launch row kernel: per pair lookup_ops, 3 per walked term,
    the epilogue per found pair, 3 per diagonal term of a live row; each input
    read once (lookup_bytes of the table, xy and xy_ptr, the grouped terms (16
    B a term, at most the n_terms there are), the diagonal terms, every row's
    state and a live row's la and ph), the two f64 outputs written once."""
    ops = (lookup_ops + 3 * work["terms"] + EPILOGUE_OPS * work["found"]
           + 3 * n_live * n_diag)
    n_bytes = (lookup_bytes + n_cols * 12 + min(work["terms"], n_terms) * 16 + n_diag * 16
               + cap * 8 + n_live * 8 + cap * 16)
    return _bound(n_bytes, ops), ops, n_bytes


def _timed(fn):
    """(fn(), ms): one call's wall time between two synchronizes, for plain
    versions of seconds a call, whose device work hides their enqueue."""
    import torch

    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t) * 1e3


def _bound(n_bytes, n_ops):
    b, o = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def _oracle_rows(terms, states, la, ph, rows):
    """float64 host-oracle E_loc (real part) of a few rows of a sorted sample:
    local_energy_np over those rows and every sampled state they couple to,
    which is all their truncated sums can see."""
    import numpy as np

    from naqs_tpu_torch.hamiltonian import local_energy_np

    coupled = (states[rows][:, None] ^ terms.xy_unique[None, :]).ravel()
    keep = np.isin(states, coupled)
    keep[rows] = True
    sub = np.flatnonzero(keep)
    psi = np.exp(la[sub] + 1j * ph[sub])
    return local_energy_np(terms, states[sub], psi)[np.searchsorted(sub, rows)].real


def _grid_work(prog):
    """What the dense program's accumulation must do: (bytes, operations, valid
    (mask, cell) pairs, h_dense's share of the bytes). Bytes: every map and
    the grid read once, the output written once; of h_dense only the 32-byte
    sectors that hold a valid (mask, cell) pair of a mask that is not padding
    (no other value of it enters the sum). h_dense's share is a dict: those
    sectors' bytes, the bytes of its rows with a valid beta image, and the
    whole tensor's. Operations: per valid pair 2 fused multiply-adds."""
    import torch

    idx, sa, sb = prog.r1_idx, prog.sa, prog.sb
    beta_ok = prog.row_map % (sb + 1) < sb
    nb_valid = beta_ok.sum(dim=1)
    na_valid = (idx < sa).sum(dim=1)[(prog.row_map[:, 0] // (sb + 1)).long()]
    pairs = nb_valid * na_valid
    n_bytes = sum(t.numel() * t.element_size() for t in (prog.r1_idx, prog.row_map))
    n_bytes += (sa + 1) * (sb + 1) * 8 + sa * sb * 8
    live = prog.h_dense.flatten(1).abs().amax(dim=1) > 0    # not a pad mask
    rows = beta_ok & live[:, None]
    need = rows[..., None] & (idx < sa)[(prog.row_map // (sb + 1)).long()]
    need = torch.nn.functional.pad(need.flatten(), (0, -need.numel() % 8))
    h_bytes = {"sectors": int(need.view(-1, 8).any(dim=1).sum()) * 32,
               "rows": int(rows.sum()) * sa * 4, "whole": prog.h_dense.numel() * 4}
    n_bytes += h_bytes["sectors"]
    n_pairs = int(pairs[live].sum())
    return n_bytes, 4 * n_pairs, n_pairs, h_bytes


def _cells_work(fn, grid, idx, n_rows, chunk=256):
    """What the factored cells function must do on this call's data: a dict of
    counts and (bytes, operations). A pair (mask, live cell) is valid where
    both images lie in the sector, found where its grid cell is set. Bytes,
    each read once: the image rows of the distinct ra and rb of the live
    cells (Ka and Kb int32 each) and their words, every mask's (ga, gb), the
    packed factor slots (ya, yb, coefficient: 12 B) of the masks of found
    pairs, the distinct grid cells the valid pairs read, idx, n_rows and the
    output. Operations: 4 per valid pair (the two image looks, the test, the
    T test), and 2 n_fact + 4 per found pair (a sign and an add a factor, the
    two fused multiply-adds and the lane's share of the sum)."""
    import torch

    from naqs_tpu_torch.ops.grid_kernels import _live_cells

    sa, sb = fn.sa, fn.sb
    rows, ra, rb = _live_cells(idx, n_rows, sa, sb)
    ia_all, ib_all = fn.pa_idx[:, ra].long(), fn.pb_idx[:, rb].long()   # (Ka, V), (Kb, V)
    occ = (grid != 0).any(-1)
    touched = torch.zeros_like(occ)
    n_masks = int((fn.n_fact > 0).sum())
    valid = found = fact = 0
    found_masks = torch.zeros(fn.ga.shape[0], dtype=torch.bool, device=grid.device)
    for c in range(0, n_masks, chunk):
        k = torch.arange(c, min(c + chunk, n_masks), device=grid.device)
        ia, ib = ia_all[fn.ga[k].long()], ib_all[fn.gb[k].long()]          # (KC, V)
        ok = (ia < sa) & (ib < sb)
        touched[ia[ok], ib[ok]] = True
        hit = ok & occ[ia, ib]
        valid += int(ok.sum())
        per = hit.sum(1)
        found += int(per.sum())
        fact += int((per * fn.n_fact[k]).sum())
        found_masks[k] |= per > 0
    n_ra, n_rb = int(torch.unique(ra).numel()), int(torch.unique(rb).numel())
    n_bytes = (n_ra * (fn.pa_idx.shape[0] * 4 + 4) + n_rb * (fn.pb_idx.shape[0] * 4 + 4)
               + n_masks * 8 + int(fn.n_fact[found_masks].sum()) * 12
               + int(touched.sum()) * 8 + idx.numel() * 8 + 8 + idx.numel() * 8)
    n_ops = 4 * valid + 2 * fact + 4 * found
    return dict(live=int(rows.numel()), distinct_ra=n_ra, distinct_rb=n_rb, masks=n_masks,
                valid_pairs=valid, found_pairs=found, factors=fact,
                grid_cells=int(touched.sum()), bytes=n_bytes, ops=n_ops)


def _xl_work(fn):
    """What the staircase accumulation must do: (bytes, operations, valid
    (mask, cell) pairs, multiply-adds of the on-the-fly H, grid cells the
    valid pairs read). A pair is valid when both spin images lie in the
    restricted rectangle. Bytes: the grid cells those pairs read, once; the
    maps, factor lists and word tables once; of par_a and par_b only the
    columns the blocks' programs read; the packed output once. Operations:
    per valid pair 2 fused multiply-adds into the sum, and one per rank-1
    factor of the mask."""
    import torch

    sa, sb = fn.sa, fn.sb
    va, vb = fn.pa_idx < sa, fn.pb_idx < sb
    a_ok = torch.stack([va[:, off:off + cnt].sum(1) for off, cnt, _ in fn.blocks], 1)
    b_ok = torch.stack([vb[:, :pw].sum(1) for _, _, pw in fn.blocks], 1)
    pairs = (a_ok[fn.ga.long()] * b_ok[fn.gb.long()]).sum(1)
    macs = int((pairs * fn.n_fact).sum())
    touched = torch.zeros((sa, sb), dtype=torch.bool, device=fn.ga.device)
    for g in range(fn.pa_idx.shape[0]):
        gbs = torch.unique(fn.gb[fn.ga == g]).long()
        for off, cnt, pw in fn.blocks:
            rows = fn.pa_idx[g, off:off + cnt]
            cols = torch.unique(fn.pb_idx[gbs, :pw])
            touched[rows[rows < sa].long()[:, None], cols[cols < sb].long()[None, :]] = True
    n_touched = int(touched.sum())
    program_p = {orient: torch.unique(fn.tiles[fn.tiles[:, 0] == orient, 1]).numel()
                 for orient in (0, 1)}
    tables = [fn.ga, fn.gb, fn.pa_idx, fn.pb_idx, fn.alpha_words, fn.beta_words, fn.ya_words,
              fn.yb_words, fn.fa_idx, fn.fb_idx, fn.fcoeff, fn.n_fact, fn.cells_off, fn.tiles]
    n_bytes = sum(t.numel() * t.element_size() for t in tables)
    n_bytes += (fn.par_b.shape[0] * program_p[0] + fn.par_a.shape[0] * program_p[1]) * 4
    n_bytes += n_touched * 8 + fn.n_cells * 8
    n_pairs = int(pairs.sum())
    return n_bytes, 2 * macs + 4 * n_pairs, n_pairs, macs, n_touched


def _xl_sampled_work(fn, grid, n_touched):
    """What the set-cells staircase kernel must do on `grid`: a dict of its
    schedule's counts and (bytes, operations). A pair (mask, staircase cell)
    is set where both images lie in the rectangle and its grid cell is set.
    Per tile the kernel stages the chunks of its orientation whose fixed
    image's bitmap row is not clear (a bulk copy of the row and, for a chunk of
    more than one mask, of its headers); a row of at most XL_LIST_MAX set cells
    and no pad cell is listed (one entry per set cell and mask), any other row
    probed (one per tile cell and mask). Bytes, what the function itself
    needs: the n_touched grid cells that some valid pair reads (a cell is
    known to be clear only once it is read), the maps, word tables and the
    program once, the packed output once; not the rest of the grid, nor the
    bitmaps and staged rows, which are this design's own. Operations: one per
    grid cell (is it set), one per listed entry or probe, per set pair 2
    fused multiply-adds and 2 per factor of its mask (the sign and the add)."""
    import torch

    from naqs_tpu_torch.ops.grid_kernels import XL_LIST_MAX, _xl_row_words, xl_occupancy_ref

    occ = (grid != 0).any(-1)
    sa, sb = fn.sa, fn.sb
    width = fn.width[:-1].long()
    ra_c = torch.repeat_interleave(torch.arange(sa, device=grid.device), width)
    rb_c = torch.arange(fn.n_cells, device=grid.device) - fn.cells_off[:-1].long()[ra_c]
    set_pairs = torch.zeros(fn.ga.shape[0], dtype=torch.int64, device=grid.device)
    for k in range(fn.ga.shape[0]):
        set_pairs[k] = occ[fn.pa_idx[fn.ga[k], ra_c].long(), fn.pb_idx[fn.gb[k], rb_c].long()].sum()
    n_set_pairs = int(set_pairs.sum())
    factor_ops = int((set_pairs * fn.n_fact).sum())
    _, _, any_a, any_b = xl_occupancy_ref(grid)
    row_bytes = {0: _xl_row_words(sa + 1) * 4, 1: _xl_row_words(sb + 1) * 4}
    staged = staged_bytes = listed = probed = 0
    for orient in (0, 1):
        c_lo, c_hi = (0, fn.n_col_chunks) if orient == 0 else (fn.n_col_chunks,
                                                                fn.chunks.shape[0])
        ch = fn.chunks[c_lo:c_hi].long()
        tl = fn.tiles[fn.tiles[:, 0] == orient].long()
        p_idx, n_rows, pad = (fn.pb_idx, occ.sum(0), occ[sa]) if orient == 0 else \
            (fn.pa_idx, occ.sum(1), occ[:, sb])
        anyf = any_b if orient == 0 else any_a
        img = p_idx[ch[:, 0]][:, tl[:, 1]].long()               # (chunks, tiles)
        on = anyf[img] > 0
        staged += int(on.sum())
        masks = ch[:, 2:3]       # a chunk of one mask stages no headers
        staged_bytes += int((on * (row_bytes[orient] + 16 * masks * (masks > 1))).sum())
        is_listed = (n_rows[img] <= XL_LIST_MAX) & ~pad[img]
        per = masks * on
        listed += int((per * is_listed * n_rows[img]).sum())
        probed += int((per * ~is_listed * (tl[:, 3] - tl[:, 2])[None, :]).sum())
    tables = [fn.pa_idx, fn.pb_idx, fn.alpha_words, fn.beta_words, fn.cells_off, fn.prog]
    n_bytes = sum(t.numel() * t.element_size() for t in tables) + n_touched * 8 + fn.n_cells * 8
    n_ops = occ.numel() + listed + probed + 4 * n_set_pairs + 2 * factor_ops
    return dict(set_cells=int(occ.sum()), set_pairs=n_set_pairs, factors=factor_ops,
                staged_chunks=staged, staged_bytes=staged_bytes, listed=listed, probed=probed,
                bytes=n_bytes, ops=n_ops)


def _check_grid_kernel(name, wrapper, ref, prog, grid, *rows):
    """Hold a grid kernel against its plain version on `grid` (and, for the
    factored cells kernel, the rows (idx, n_rows)); returns its max abs
    error. Raises SystemExit on disagreement or a run-to-run change."""
    import torch

    from naqs_tpu_torch.ops.grid_kernels import GRID_ATOL, GRID_RTOL, grid_tolerance

    torch.cuda.reset_peak_memory_stats()
    got = wrapper(prog, grid, *rows)
    torch.cuda.synchronize()
    peak_kernel = torch.cuda.max_memory_allocated()
    again = wrapper(prog, grid, *rows)
    t = time.time()
    want = ref(prog, grid, *rows)
    torch.cuda.synchronize()
    t_plain = time.time() - t
    peak_plain = torch.cuda.max_memory_allocated()
    tol = grid_tolerance(prog, grid, *rows)
    diff = (got - want).abs()
    err, worst = float(diff.max()), float((diff / tol).max())
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(got).all())
    same = torch.equal(got, again)
    if hasattr(prog, "h_dense"):
        shape = f"Kxy_pad={prog.row_map.shape[0]}, Sb={prog.sb}, Sa={prog.sa}"
    elif rows:
        idx, n_rows = rows
        live = (torch.arange(idx.shape[0], device=grid.device) < n_rows) & \
            (idx < prog.sa * prog.sb)
        zeros = bool((got[~live] == 0).all())
        ok = ok and zeros
        shape = (f"Kxy_pad={prog.ga.shape[0]}, Sb={prog.sb}, Sa={prog.sa}; {idx.shape[0]} "
                 f"rows, {int(live.sum())} of them live cells, every other row exactly "
                 f"0={zeros}")
    else:
        shape = (f"Kxy={prog.ga.shape[0]}, {prog.n_cells} staircase cells of Sa*={prog.sa} x "
                 f"Sb*={prog.sb}, {prog.tiles.shape[0]} blocks")
    print(f"[kernel] {name} ({shape}; "
          f"{int((grid[..., 0] ** 2 + grid[..., 1] ** 2 > 0).sum())} cells of the grid set): "
          f"max_abs_err={err:.3e} (sums up to {float(want.abs().max()):.3e}), worst cell at "
          f"{worst:.3f} of its tolerance ({GRID_ATOL} + {GRID_RTOL} * sum_k sum_r |c||T|), "
          f"within={ok}, twice bitwise equal={same}; plain version {t_plain:.2f} s; peak "
          f"device memory {peak_kernel / 2**30:.2f} GiB with the kernel, "
          f"{peak_plain / 2**30:.2f} GiB with the plain version", flush=True)
    if not (ok and same and float(want.abs().max()) > 0):
        raise SystemExit(f"{name} disagrees with its plain version or with itself")
    return err


def _engines_agree(label, le, dt, terms, batch, la, ph):
    """local_energy through dt's grid program against the rank engine
    (dense=None) per live row, and 8 rows of both against the host oracle."""
    import numpy as np

    nu = int(batch.n_unique)
    e_grid = le.local_energy(dt, batch.states, la, ph, batch.n_unique)
    e_rank = le.local_energy(dataclasses.replace(dt, dense=None), batch.states, la, ph,
                             batch.n_unique)
    d_re, d_im = (float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_grid, e_rank))
    rows = np.sort(np.random.default_rng(0).choice(nu, size=min(8, nu), replace=False))
    ref = _oracle_rows(terms, batch.states[:nu].cpu().numpy(), la[:nu].double().cpu().numpy(),
                       ph[:nu].double().cpu().numpy(), rows)
    err_grid = float(np.abs(e_grid[0][:nu].cpu().numpy()[rows] - ref).max())
    err_rank = float(np.abs(e_rank[0][:nu].cpu().numpy()[rows] - ref).max())
    finite = bool(np.all(np.isfinite(e_grid[0][:nu].cpu().numpy())))
    print(f"[eloc] {label}: {type(dt.dense).__name__} vs rank engine on {nu} live rows: "
          f"max_abs_diff re {d_re:.3e} im {d_im:.3e} Ha (tol {ENGINE_TOL}); vs float64 "
          f"local_energy_np on {len(rows)} rows: grid {err_grid:.2e}, rank {err_rank:.2e} "
          f"(tol {ELOC_TOL})", flush=True)
    if not (max(d_re, d_im) <= ENGINE_TOL and max(err_grid, err_rank) < ELOC_TOL and finite):
        raise SystemExit(f"{label}: the engines disagree with each other or with the oracle")
    return e_rank


def _steps(tr, n, label):
    """n training steps, timed; returns (vmc_update calls, step times, sample
    calls)."""
    import torch

    from naqs_tpu_torch import trainer as trainer_mod

    calls = [0, 0]
    update, draw = trainer_mod.vmc_update, trainer_mod.sample

    def counted(*args, **kw):
        calls[0] += 1
        return update(*args, **kw)

    def counted_sample(*args, **kw):
        calls[1] += 1
        return draw(*args, **kw)

    trainer_mod.vmc_update, trainer_mod.sample = counted, counted_sample
    times = []
    try:
        for i in range(n):
            torch.cuda.synchronize()
            t = time.time()
            out = tr.step()
            torch.cuda.synchronize()
            times.append(time.time() - t)
            print(f"[step {label} {i + 1}] {times[-1]:.3f} s  n_unique={out['n_unique']} "
                  f"n_samples={out['n_samples']:.0e} e_loc={out['e_loc']:.6f} "
                  f"e_loc_var={out['e_loc_var']:.6f}", flush=True)
            if not (math.isfinite(out["e_loc"]) and math.isfinite(out["e_loc_var"])):
                raise SystemExit(f"non-finite energy at {label} step {i + 1}: {out}")
    finally:
        trainer_mod.vmc_update, trainer_mod.sample = update, draw
    return calls[0], times, calls[1]


def _dense_h(dt, s):
    """(C, Kxy) f32 H row of chunk states s as the chunk loops formed it with a
    dense A: parity(s & yz_unique) @ A, a full-fp32 product. No engine forms
    it since the one-launch kernels took the dense-A calls."""
    import torch

    from naqs_tpu_torch.utils.bits import parity_pm1

    return torch.matmul(parity_pm1(s[:, None] & dt.yz_unique[None, :]).to(torch.float32),
                        dt.a_mat)


def _dense_chunk_loop(le, dt, states, la, ph, chunk, ratio_fn):
    """local_energy with a dense A as the engines' chunk loops ran it: per chunk
    of `chunk` query rows (the last padded with SENTINEL rows) the diagonal,
    the H row as P @ A (`_dense_h`) and ratio_fn(s, my_la, my_ph, h) -> (re,
    im) f32 (rank_ratio_rowsum or sorted_ratio_rowsum over the table).
    (e_re, e_im) f64."""
    import torch

    from naqs_tpu_torch.utils.bits import SENTINEL

    e_re, e_im = [], []
    for i in range(0, states.shape[0], chunk):
        s, my_la, my_ph = (states[i:i + chunk], la[i:i + chunk].float(),
                           ph[i:i + chunk].float())
        n = s.shape[0]
        if n < chunk:
            s = torch.cat([s, s.new_full((chunk - n,), SENTINEL)])
            my_la = torch.cat([my_la, my_la.new_zeros(chunk - n)])
            my_ph = torch.cat([my_ph, my_ph.new_zeros(chunk - n)])
        r, im = ratio_fn(s, my_la, my_ph, _dense_h(dt, s))
        e_re.append((le.diagonal_energy(dt, s) + r.to(torch.float64))[:n])
        e_im.append(im.to(torch.float64)[:n])
    return torch.cat(e_re), torch.cat(e_im)


def _quad_loop(le, dt_q, gather, h_fn, states, la_q, ph_q, nv, c):
    """quadratic_energy's chunk loop as the earlier designs ran it, on log-amps
    la_q already shifted to a live maximum of 0: per chunk of c rows the
    diagonal, gather(s, live) (a gather kernel), h_fn(s, yz_unique, xy_ptr,
    term_yz, term_coeff) (the H row: the per-term kernel, or P @ A) and the
    eager epilogue."""
    import torch

    dev = states.device
    num = torch.zeros((), dtype=torch.float64, device=dev)
    den = torch.zeros((), dtype=torch.float64, device=dev)
    live_q = torch.arange(states.shape[0], device=dev) < nv
    for i in range(0, states.shape[0], c):
        s, my_la, my_ph, my_live = (states[i:i + c], la_q[i:i + c], ph_q[i:i + c],
                                    live_q[i:i + c])
        w_m = torch.where(my_live, torch.exp(2.0 * my_la.double()), 0.0)
        num += torch.sum(w_m * le.diagonal_energy(dt_q, s))
        g_la, g_ph = gather(s, my_live)
        amp = torch.where(my_live[:, None], torch.exp(g_la + my_la[:, None]), 0.0)
        h_q = h_fn(s, dt_q.yz_unique, dt_q.xy_ptr, dt_q.term_yz, dt_q.term_coeff)
        num += torch.sum(torch.sum(h_q * (amp * torch.cos(g_ph - my_ph[:, None])),
                                   dim=-1).double())
        den += torch.sum(w_m)
    return num / den


def _profiled_call(fn):
    """fn() under torch.profiler: (its result, its wall time in s, the device
    time of its kernels and copies in ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.time() - t
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    return out, wall, device / 1e3


def _profiled_step(tr):
    """One tr.step() under torch.profiler: (its wall time in s, the device time
    of its kernels and copies in ms)."""
    out, wall, device = _profiled_call(tr.step)
    if not math.isfinite(out["e_loc"]):
        raise SystemExit(f"non-finite energy in the profiled step: {out}")
    return wall, device


def _shell_inputs(model, gen, n_samples, cap):
    """sampler.sample's shell loop (beta = 1) through the same calls, keeping
    every shell's inputs: returns (the batch, the arguments of each shell's
    _split_and_compact call: a, b, counts, valid, probs, z, u, mask, j, cap,
    n_live). The caller holds the batch against sample()'s from the same
    generator state."""
    import torch

    from naqs_tpu_torch.models.nade import amp_conditional_shell
    from naqs_tpu_torch.ops.multinomial import split_draws
    from naqs_tpu_torch.sampler import _batch, _prefix_bits, _root, _split_and_compact

    dev = next(model.parameters()).device
    a, b, counts, valid, overflow = _root(cap, float(n_samples), dev)
    shells = torch.arange(model.cfg.n_shells, device=dev)
    kept, n_children = [], 1
    with torch.no_grad():
        for j in range(model.cfg.n_shells):
            _, mask, probs = amp_conditional_shell(model, j, *_prefix_bits(a, b, shells))
            z, u = split_draws(gen, cap, dev)
            args = (a, b, counts, valid, probs, z, u, mask, j, cap, n_children)
            a, b, counts, valid, n_children = _split_and_compact(*args)
            overflow = overflow | (n_children > cap)
            kept.append(args)
    return _batch(model.cfg, a, b, counts, valid, overflow, shells), kept


def _split_of(args):
    """multinomial4_split's arguments in a shell step's: (counts, probs, z, u,
    mask, valid)."""
    a, b, counts, valid, probs, z, u, mask = args[:8]
    return counts, probs, z, u, mask, valid


def _compaction_of(args):
    """compact_children's arguments after the plain split of a shell step:
    (a, b, child_counts, child_valid, j, cap)."""
    from naqs_tpu_torch.ops.multinomial import multinomial4_split_ref

    return (args[0], args[1], *multinomial4_split_ref(*_split_of(args)), args[8], args[9])


def _max_diff(got, want):
    """Largest absolute difference of two tensors of any dtype, in float64."""
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def _split_ops(live, tally):
    """(float64, float32) operations the split does on these rows, from the
    plain cascade's tally: per live row three running sums and three
    divisions; per binomial 1 - p, 1 - q, log1p, the mean, the variance, n - k
    and the count left, and in f32 1 - q and the odds; per Gaussian binomial
    sqrt, a product, a sum and rint; per inverse-CDF binomial n * log1p(-q) and
    expf, then per step of the pmf recurrence four sums and products and a
    division. An operation that is not one instruction counts the
    instructions SASS_OPS gives it."""
    binomials = tally["gauss"] + tally["cdf"]
    steps = tally["cdf_steps"] - tally["cdf"]     # each look but the last updates the pmf
    calls = {"f64_div": 3 * live, "log1p": binomials, "sqrt": tally["gauss"],
             "f32_div": binomials + steps, "expf": tally["cdf"]}
    f64 = 3 * live + 6 * binomials + 3 * tally["gauss"] + tally["cdf"]
    f32 = binomials + 4 * steps
    for op, n in calls.items():
        f64 += n * SASS_OPS[op]["f64"]
        f32 += n * SASS_OPS[op]["f32"]
    return f64, f32


def _split_tally(counts, probs, z, u, valid):
    """How the plain cascade's binomials of live rows divide: Gaussian or
    inverse CDF, the looks the kernel's CDF loops take in all and the longest
    of them, and the dead rows."""
    import torch

    from naqs_tpu_torch.ops.multinomial import _GAUSS_VAR_MIN, _SMALL_SUPPORT, _cascade

    live = counts > 0 if valid is None else (counts > 0) & valid
    tally = {"gauss": 0, "cdf": 0, "cdf_steps": 0, "cdf_longest": 0,
             "dead_rows": int((~live).sum())}
    for _, var, small in _cascade(counts, probs, z, u)[1]:
        in_cdf = live & ~(var > _GAUSS_VAR_MIN)
        # the kernel compares u with cdf_0 .. cdf_small: small + 1 looks, 127 at most
        looks = torch.clamp(small[in_cdf] + 1, max=_SMALL_SUPPORT - 1)
        tally["gauss"] += int((live & (var > _GAUSS_VAR_MIN)).sum())
        tally["cdf"] += int(in_cdf.sum())
        tally["cdf_steps"] += int(looks.sum())
        if looks.numel():
            tally["cdf_longest"] = max(tally["cdf_longest"], int(looks.max()))
    return tally


def _split_before(counts, probs, z, u, mask):
    """The split as the step ran it before its kernel: every binomial's
    inverse CDF as a (U, 127) cumprod and cumsum over all rows. A time to
    compare with, and a second opinion on the counts (it forms the pmf ratio
    first, so a count may differ by a last bit of the CDF)."""
    import torch

    rem = counts
    p = probs.to(torch.float64)
    ps = torch.cumsum(p, dim=-1)
    condp = torch.where(ps > 0, p / torch.clamp(ps, min=1e-300), 0.0)
    j = torch.arange(1, 128, device=counts.device, dtype=torch.float32)
    out = []
    for i in (3, 2, 1):
        n = rem
        p64 = torch.clamp(condp[:, i], 0.0, 1.0)
        flip = p64 > 0.5
        q = torch.where(flip, 1.0 - p64, p64)
        mean = n * q
        var = mean * (1.0 - q)
        gauss = torch.round(mean + torch.sqrt(torch.clamp(var, min=0.0)) * z[3 - i].double())
        pmf0 = torch.exp((n * torch.log1p(-torch.clamp(q, max=1.0 - 1e-15))).float())
        nf = n.float()[..., None]
        qf = q.float()
        odds = (qf / torch.clamp(1.0 - qf, min=1e-30))[..., None]
        ratio = torch.clamp(nf - j + 1.0, min=0.0) / j * odds
        pmf = torch.cat([pmf0[..., None], pmf0[..., None] * torch.cumprod(ratio, dim=-1)],
                        dim=-1)
        cdf = torch.cumsum(pmf[..., :-1], dim=-1)
        small = torch.sum(u[3 - i][..., None] > cdf, dim=-1).double()
        k = torch.where(var > 25.0, gauss, small)
        k = torch.minimum(torch.clamp(k, min=0.0), n)
        k = torch.where(q <= 0.0, 0.0, torch.where(q >= 1.0, n, k))
        c = torch.minimum(torch.where(flip, n - k, k), rem)
        out.append(c)
        rem = rem - c
    out.append(rem)
    return torch.stack(out[::-1], dim=-1) * mask


def _check_split(label, args, totals):
    """multinomial4_split against its plain version on `args` = (counts, probs,
    z, u, mask, valid): bitwise, else the stated bar; with mask=None the row
    sums must equal the counts on live rows. Adds to `totals`; returns the
    plain version's branch tally."""
    import torch

    from naqs_tpu_torch.ops.multinomial import multinomial4_split, multinomial4_split_ref

    counts, probs, z, u, mask, valid = args
    got = multinomial4_split(*args)
    want = multinomial4_split_ref(*args)
    free = multinomial4_split(counts, probs, z, u, None, valid)[0]
    torch.cuda.synchronize()
    live_counts = counts if valid is None else torch.where(valid, counts, 0.0)
    sums = torch.equal(free.sum(-1), live_counts)
    differ = (got[0] != want[0]).any(-1)
    n_diff = int(differ.sum())
    d = (got[0] - want[0])[differ].abs()
    ok = torch.equal(got[1], want[1]) if n_diff == 0 else (
        n_diff <= 1e-4 * counts.shape[0] and bool((d.amax(-1) == 1).all())
        and bool((d.sum(-1) <= 2).all()))
    totals["rows"] += counts.shape[0]
    totals["differ"] += n_diff
    totals["err"] = max(totals["err"], _max_diff(got[0], want[0]))
    if not (ok and sums):
        raise SystemExit(f"{label}: multinomial4_split disagrees with its plain version "
                         f"({n_diff} rows differ, row sums exact={sums})")
    return _split_tally(counts, probs, z, u, valid)


def _check_frontier(label, wrapper, ref, args, totals):
    """A compaction's wrapper (`_compact_children` or `_split_and_compact`)
    against its plain version on `args`, and against itself called again: all
    five outputs bitwise. Adds the largest difference seen and one case to
    `totals`; returns n_children."""
    import torch

    got = wrapper(*args)
    again = wrapper(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    same = all(g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, x)
               for g, w, x in zip(got, want, again))
    totals["err"] = max([totals["err"]] + [_max_diff(g, w) for g, w in zip(got, want)])
    totals["cases"] += 1
    if not same:
        raise SystemExit(f"{label}: {wrapper.__name__} disagrees with its plain version "
                         f"(max_abs_err={totals['err']})")
    return int(got[4])


def _graph_replays(wrapper, args, replays=3):
    """`wrapper(*args)` captured in a torch.cuda.CUDAGraph, its outputs
    overwritten with other values before each of `replays` replays: whether
    every replay gives the eager call's outputs bitwise, and the launches the
    capture counted."""
    import torch

    eager = wrapper(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wrapper(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = wrapper.launches
    with torch.cuda.graph(graph):
        captured = wrapper(*args)
    captured_launches = wrapper.launches - before
    same = True
    for fill in range(replays):
        for t in captured:
            t.fill_(fill + 3)
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(c, e) for c, e in zip(captured, eager))
    del graph
    return same, captured_launches


def _ptxas_registers(build_log, kernel):
    """{mangled entry name: registers} of each instantiation of `kernel` in
    nvcc's -Xptxas -v report (the mangled name holds the kernel's name)."""
    regs, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line and "'" in line else None
        elif entry and "Used" in line and "registers" in line:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
            entry = None
    return regs


def _shell_step(split, cap, dev, seed):
    """A shell step's arguments around the split inputs `split` = (counts,
    probs, z, u) of cap rows: every row valid, every child allowed, random
    prefix bits below 2^12, shell 12."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(0, 1 << 12, (cap,), generator=gen, device=dev)
    b = torch.randint(0, 1 << 12, (cap,), generator=gen, device=dev)
    ones = torch.ones((cap, 4), dtype=torch.bool, device=dev)
    counts, probs, z, u = split
    return a, b, counts, ones[:, 0].clone(), probs, z, u, ones, 12, cap


def _before_modules(before):
    """The kernel wrappers of the port's tree unpacked at `before`, imported
    beside this tree's, each library built from that tree's own source into
    that tree's build/ and bound while its package is loaded: {"rank_gather2":
    its ops/dyn_gather} where its rank_gather2 takes the two-channel tables of
    the first slice, {"grid", "dense_engine": its ops/grid_kernels and
    ops/dense_engine} where it has csrc/grid_engine.cu, {"sampler": its sampler, "multinomial": its
    ops/multinomial} where it has csrc/sampler_step.cu, {"sort_lookup",
    "offdiag_h", "local_energy", "dyn_gather": its ops/...} where it has
    csrc/sort_lookup.cu."""
    import importlib
    import inspect

    def ours(name):
        return name.split(".")[0] == "naqs_tpu_torch"

    def has(source):
        return os.path.exists(os.path.join(before, "naqs_tpu_torch", "csrc", source))

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, before)
    mods = {}
    try:
        dyn = importlib.import_module("naqs_tpu_torch.ops.dyn_gather")
        if len(inspect.signature(dyn.rank_gather2).parameters) == 5:   # (spec, s, xy, la, ph)
            dyn._lib()   # builds and binds that library while its package is loaded
            mods["rank_gather2"] = dyn
        if has("grid_engine.cu"):
            mods["grid"] = importlib.import_module("naqs_tpu_torch.ops.grid_kernels")
            mods["grid"]._lib()
            mods["dense_engine"] = importlib.import_module("naqs_tpu_torch.ops.dense_engine")
        if has("sampler_step.cu"):
            mods["sampler"] = importlib.import_module("naqs_tpu_torch.sampler")
            mods["multinomial"] = importlib.import_module("naqs_tpu_torch.ops.multinomial")
            importlib.import_module("naqs_tpu_torch.ops.sampler_kernels")._lib()
        if has("sort_lookup.cu"):
            for name in ("sort_lookup", "offdiag_h", "local_energy"):
                mods[name] = importlib.import_module(f"naqs_tpu_torch.ops.{name}")
            mods["sort_lookup"]._lib()
            mods["offdiag_h"]._lib()
            dyn._lib()
            mods["dyn_gather"] = dyn
    finally:
        sys.path.remove(before)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return mods


def _trainer_extras(dev, mol, hil, terms, cfg, tr2, zero_counts, wrappers):
    """Phase 12: the trainer's extras at the paper width on H2O 6-31G, in a
    temporary working directory. Returns the launch counts and wall times
    the kernels line and the summary print."""
    import shutil
    import tempfile

    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.linalg import eigsh

    import naqs_tpu_torch as nt
    from naqs_tpu_torch import native
    from naqs_tpu_torch import trainer as trainer_mod
    from naqs_tpu_torch.hamiltonian import _assemble_rows_np, diagonal_energy_np
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops import local_energy as le
    from naqs_tpu_torch.utils.spin import penalized_termdict

    walls, out = {}, {}
    kern = {w.__name__: w for w in wrappers}
    rank_quadratic_energy = kern["rank_quadratic_energy"]
    _compact_children = kern["_compact_children"]
    _split_and_compact = kern["_split_and_compact"]

    def lap(name, t):
        torch.cuda.synchronize()
        walls[name] = time.time() - t
        print(f"[extras] {name}: {walls[name]:.2f} s wall", flush=True)

    def others(allowed):
        return {w.__name__: w.launches for w in wrappers
                if w.launches and w.__name__ not in allowed}

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_extras_")
    os.chdir(work)  # the warm start's eigenvector cache path is relative
    try:
        # 1. warm starts that need no eigensolve
        t = time.time()
        # n_unq_samples_min=1: the density controller (d_p x/÷10 per try)
        # accepts any support it can hold; with a floor of 1,000 it swings
        # between an overflowing beam and a few states on a wavefunction whose
        # tail is as flat as a few steps after pre_flatten leave it
        tc = nt.TrainConfig(n_samples=1e6, n_unq_samples_min=1, n_unq_samples_max=100_000,
                            grad_clip_factor=CLIP_FACTOR, seed=12)
        tr = nt.VMCTrainer(cfg, terms, hil, tc, device=dev, save_loc=os.path.join(work, "ck"))
        lap("trainer with its DeviceTerms", t)
        eloc = kern[{"FactorTerms": "factored_cells_accumulate",
                     "DenseTerms": "dense_grid_accumulate"}[type(tr.dt.dense).__name__]]
        t = time.time()
        hf = torch.tensor([hil.hf_state()], device=dev)
        with torch.no_grad():
            bce0 = -float(log_psi(tr.model, hf)[0])
        tr.pre_train_hf(HF_EPOCHS)
        with torch.no_grad():
            bce1 = -float(log_psi(tr.model, hf)[0])
        print(f"[extras] pre_train_hf, {HF_EPOCHS} epochs: the HF state's BCE (-log|psi|) "
              f"{bce0:.4f} -> {bce1:.4f}", flush=True)
        lap("pre_train_hf", t)
        t = time.time()
        tr.pre_flatten(1, batch_size=2**17)
        lap(f"pre_flatten, 1 epoch over {hil.size} states at batch 2^17", t)
        if not (math.isfinite(bce1) and bce1 < bce0):
            raise SystemExit("pre_train_hf did not raise the HF amplitude")

        # 2. clipped steps: the ring moves once per applied update and never on
        # a withheld one
        records, rec_times, calls = [], [], []
        record_arrays, record_samples = tr._record_arrays, tr._record_samples
        update = trainer_mod.vmc_update

        def keep_records(states, counts):
            records.append((states.copy(), counts.copy()))
            record_arrays(states, counts)

        def timed_record(*a, **kw):
            t0 = time.time()
            record_samples(*a, **kw)
            rec_times.append(time.time() - t0)

        def watched(*a, **kw):
            clip = kw["clip"]
            before = clip.state_dict()
            m = update(*a, **kw)
            moved = not (torch.equal(before["norms"], clip.norms)
                         and torch.equal(before["count"], clip.count))
            calls.append((m, moved, a[4]))
            print(f"[extras] update {len(calls)}: overflow={m['overflow']} "
                  f"applied={m['applied']} grad_norm={m['grad_norm']:.5e} (before the clip) "
                  f"clip_scale={m['clip_scale']:.5f} ring moved={moved} "
                  f"(count {int(clip.count)})", flush=True)
            return m

        tr._record_arrays, tr._record_samples = keep_records, timed_record
        trainer_mod.vmc_update = watched
        steps, last_batch, t = [], {}, time.time()
        try:
            for i in range(EXTRAS_STEPS):
                torch.cuda.synchronize()
                t0 = time.time()
                recorded = tr.n_steps % tr.RECORD_FREQ == 0
                o = tr.step()
                torch.cuda.synchronize()
                steps.append((time.time() - t0, recorded, len(calls)))
                last_batch[tr.n_steps] = calls[-1][2]
                print(f"[step extras {i + 1}] {steps[-1][0]:.3f} s  record={recorded} "
                      f"n_unique={o['n_unique']} e_loc={o['e_loc']:.6f} "
                      f"grad_norm={o['grad_norm']:.5e} clip_scale={o['clip_scale']:.5f}",
                      flush=True)
                if not math.isfinite(o["e_loc"]):
                    raise SystemExit("a clipped step gave a non-finite energy")
        finally:
            trainer_mod.vmc_update = update
            tr._record_arrays, tr._record_samples = record_arrays, record_samples
        lap(f"{EXTRAS_STEPS} clipped steps", t)
        if any(m["applied"] != moved for m, moved, _ in calls):
            raise SystemExit("the clip's ring moved on a withheld update or stood still on an "
                             "applied one")
        ring = tr.clip.state_dict()
        bad = dataclasses.replace(calls[-1][2], overflow=torch.tensor(True, device=dev))
        m = trainer_mod.vmc_update(tr.model, tr.optimizer, tr.scheduler, tr.dt, bad,
                                   clip=tr.clip)
        moved = not (torch.equal(ring["norms"], tr.clip.norms)
                     and torch.equal(ring["count"], tr.clip.count))
        n_withheld = sum(not c[0]["applied"] for c in calls) + (not m["applied"])
        n_clipped = sum(c[0]["applied"] and c[0]["clip_scale"] < 1.0 for c in calls)
        print(f"[extras] a forced overflow update: applied={m['applied']}, ring moved={moved}; "
              f"{n_withheld} withheld updates in all, {n_clipped} of {len(calls)} updates "
              f"clipped (factor {CLIP_FACTOR})", flush=True)
        if m["applied"] or moved:
            raise SystemExit("a withheld update moved the clip's ring")
        rec = [s for s, r, _ in steps[1:] if r]
        plain = [s for s, r, _ in steps[1:] if not r]
        out["record_step_s"], out["plain_step_s"] = rec, plain
        print(f"[extras] step time: record steps (after the first) {rec} s, other steps "
              f"{min(plain):.3f}-{max(plain):.3f} s (median {np.median(plain):.3f}); the "
              f"record itself on steps {[i + 1 for i, st in enumerate(steps) if st[1]]}: "
              f"{[round(x, 4) for x, st in zip(rec_times, steps) if st[1]]} s (the device->host "
              f"copy of the capacity-sized buffer, which waits for the step's Adam update, and "
              f"the counter update)", flush=True)

        # 3. the counter and solve_h
        t = time.time()
        want = {}
        for s_rec, c_rec in records:
            for s, c in zip(s_rec.tolist(), c_rec.tolist()):
                want[s] = want.get(s, 0.0) + c
        rec_steps = [n for n in last_batch if (n - 1) % tr.RECORD_FREQ == 0]
        same_batches = len(rec_steps) == len(records) and all(
            np.array_equal(r[0], last_batch[n].states[:len(r[0])].cpu().numpy())
            and len(r[0]) == int(last_batch[n].n_unique) for n, r in zip(rec_steps, records))
        print(f"[extras] counter: {len(tr.sampled_counter)} states from {len(records)} recorded "
              f"steps {rec_steps}; equal to the recorded batches' sums={tr.sampled_counter == want}"
              f", the recorded arrays are the steps' batches={same_batches}", flush=True)
        if not (tr.sampled_counter == want and same_batches and len(records) >= 2):
            raise SystemExit("the counter does not hold the states of the recorded steps")
        if not native.available():
            raise SystemExit("the native host library did not build")
        e0, n0 = tr.solve_h(k_max=SOLVE_K)
        lap(f"solve_h over the counter's top {n0}", t)
        states = tr._subspace(None, True, SOLVE_K, None)
        d_min = float(diagonal_energy_np(terms, states).min())
        t = time.time()
        r, c, v = _assemble_rows_np(terms, states, 0, len(states))
        h_np = sp.csr_matrix((v, (r, c)), shape=(len(states),) * 2)
        e_np = float(eigsh(h_np, k=1, which="SA")[0][0])
        lap("the same solve, H assembled by numpy", t)
        r, c, v = native.assemble_h_coo(terms, states)
        h_nat = sp.csr_matrix((v, (r, c)), shape=(len(states),) * 2)
        e_nat = float(eigsh(h_nat, k=1, which="SA")[0][0])
        print(f"[extras] solve_h: E0 {e0:.10f} Ha over {n0} states (lowest diagonal element "
              f"{d_min:.10f}); numpy assembly {e_np:.10f}, native {e_nat:.10f}: "
              f"{abs(e_np - e_nat):.1e} Ha apart (tol 1e-8)", flush=True)
        if not (n0 == min(SOLVE_K, len(want)) and e0 <= d_min + 1e-9
                and abs(e_np - e_nat) <= 1e-8 and abs(e0 - e_nat) <= 1e-8):
            raise SystemExit("solve_h: E0 above the lowest diagonal element, or the numpy and "
                             "native assemblies disagree")

        # 4. warm start on those states; exact_energy before and after: one
        # rank_quadratic_energy launch a call (the dense A is not read), timed
        # whole and in its two parts, log_psi over the basis and quadratic_energy
        t = time.time()
        zero_counts()
        e_before = tr.exact_energy()
        out["quad_launches_exact_energy"] = rank_quadratic_energy.launches
        out["gather_launches_exact_energy"] = kern["rank_gather2"].launches
        lap(f"exact_energy over the {hil.size}-state basis", t)
        if others({"rank_quadratic_energy"}) or rank_quadratic_energy.launches != 1:
            raise SystemExit(f"exact_energy did not run one rank_quadratic_energy launch and "
                             f"nothing else: {others(set())}")
        out["exact_energy_s"] = walls[f"exact_energy over the {hil.size}-state basis"]
        basis = torch.as_tensor(hil.basis, device=dev)
        t = time.time()
        with torch.no_grad():
            la_b, ph_b = log_psi(tr.model, basis)
        lap("its log_psi over the basis", t)
        t = time.time()
        e_parts = float(le.quadratic_energy(tr.dt_h, basis, la_b, ph_b, basis.shape[0]))
        lap("its quadratic_energy over the basis", t)
        if abs(e_parts - e_before) > 1e-12 * abs(e_before):
            raise SystemExit("exact_energy differs from log_psi + quadratic_energy")
        out["exact_energy_log_psi_s"] = walls["its log_psi over the basis"]
        out["exact_energy_quadratic_s"] = walls["its quadratic_energy over the basis"]
        del basis, la_b, ph_b
        t = time.time()
        e0w, nw = tr.warm_start_from_solve_h(WS_EPOCHS, k_max=SOLVE_K, loss="overlap")
        lap(f"warm_start_from_solve_h, {WS_EPOCHS} epochs over {nw} states", t)
        t = time.time()
        e_after = tr.exact_energy()
        lap("exact_energy after the warm start", t)
        print(f"[extras] exact_energy (rank_quadratic_energy launched "
              f"{out['quad_launches_exact_energy']} time a call): {e_before:.8f} Ha before "
              f"the warm start, {e_after:.8f} after "
              f"(its subspace E0 {e0w:.8f})", flush=True)
        if not (math.isfinite(e_before) and math.isfinite(e_after) and abs(e0w - e0) <= 1e-8):
            raise SystemExit("the warm start or exact_energy failed")

        # 5. training on H + lam S^2 reports pure <H>: its trainer built with
        # NAQS_TPU_DENSE=0 (exact_energy needs no grid program)
        t = time.time()
        pen = nt.compile_pauli_terms(penalized_termdict(mol.qubit_hamiltonian, mol.n_qubits,
                                                        S2_PENALTY), mol.n_qubits)
        dense_env = os.environ.get("NAQS_TPU_DENSE")
        os.environ["NAQS_TPU_DENSE"] = "0"
        try:
            tr_pen = nt.VMCTrainer(cfg, terms, hil, tc, device=dev, train_terms=pen)
        finally:
            if dense_env is None:
                del os.environ["NAQS_TPU_DENSE"]
            else:
                os.environ["NAQS_TPU_DENSE"] = dense_env
        tr_pen.model.load_state_dict(tr.model.state_dict())
        e_pen = tr_pen.exact_energy()
        lap("the H + 0.5 S^2 trainer and its exact_energy", t)
        print(f"[extras] train_terms = H + {S2_PENALTY} S^2 ({len(pen.coeff)} off-diagonal "
              f"terms against H's {len(terms.coeff)}): exact_energy {e_pen:.10f} Ha, the plain "
              f"trainer's {e_after:.10f}, bitwise equal={e_pen == e_after}", flush=True)
        if abs(e_pen - e_after) > 1e-9 or tr_pen.dt is tr_pen.dt_h:
            raise SystemExit("the train_terms trainer does not report pure <H>")
        del tr_pen

        # 6. density training, after pre_train_hf has made the HF state hold
        # a share of the mass that no other state holds (so some threshold
        # d_p keeps the beam within capacity and finds at least one state)
        t = time.time()
        tr.pre_train_hf(DENSITY_HF_EPOCHS)
        with torch.no_grad():
            hf_mass = math.exp(2 * float(log_psi(tr.model, hf)[0]))
        lap(f"pre_train_hf, {DENSITY_HF_EPOCHS} epochs (the HF state's mass {hf_mass:.4f})", t)
        t = time.time()
        n_density = [0]
        density = trainer_mod.sample_density

        def counted_density(*a, **kw):
            n_density[0] += 1
            return density(*a, **kw)

        trainer_mod.sample_density = counted_density
        zero_counts()
        try:
            tr.run_density(DENSITY_STEPS, output_freq=1)
        finally:
            trainer_mod.sample_density = density
        out["compact_launches_run_density"] = _compact_children.launches
        out["density_calls"] = n_density[0]
        lap(f"run_density, {DENSITY_STEPS} steps", t)
        print(f"[extras] run_density: {n_density[0]} sample_density calls, compact_children "
              f"launched {_compact_children.launches} times ({cfg.n_shells} a call), "
              f"split_and_compact {_split_and_compact.launches}, {eloc.__name__} "
              f"{eloc.launches}; d_p {tr.d_p:.1e}", flush=True)
        if not (_compact_children.launches == cfg.n_shells * n_density[0] >= DENSITY_STEPS
                * cfg.n_shells and eloc.launches == DENSITY_STEPS
                and not others({"_compact_children", eloc.__name__})):
            raise SystemExit(f"run_density did not run compact_children once per shell and "
                             f"nothing else of the sampler: {others(set())}")

        # 7. save, load into a fresh trainer, one more step of each
        t = time.time()
        tr.save()
        back = nt.VMCTrainer(cfg, terms, hil, tc, device=dev, save_loc=tr.save_loc).load()
        lap("save, and load into a fresh trainer (its DeviceTerms built)", t)
        sa, sb = tr.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
        same = {
            "parameters": all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                                back.model.state_dict().values())),
            "adam": sa.keys() == sb.keys() and all(torch.equal(sa[i][k], sb[i][k])
                                                  for i in sa for k in sa[i]),
            "clip": torch.equal(tr.clip.norms, back.clip.norms)
            and torch.equal(tr.clip.count, back.clip.count),
            "generator": torch.equal(tr.gen.get_state(), back.gen.get_state()),
            "counter": tr.sampled_counter == back.sampled_counter,
            "log": tr.log == back.log,
            "controller": (tr.n_samples, tr.n_steps) == (back.n_samples, back.n_steps)}
        a, b = tr.step(), back.step()
        out["resume_bitwise"] = a["e_loc"] == b["e_loc"]
        print(f"[extras] checkpoint: equal bitwise {same}; the next step's e_loc "
              f"{a['e_loc']:.10f} (never saved) and {b['e_loc']:.10f} (loaded): bitwise "
              f"equal={out['resume_bitwise']}, {abs(a['e_loc'] - b['e_loc']):.1e} Ha apart "
              f"(tol {ENGINE_TOL})", flush=True)
        if not all(same.values()) or abs(a["e_loc"] - b["e_loc"]) > ENGINE_TOL:
            raise SystemExit("the checkpoint did not restore the trainer")
        del back

        # 8. save_psi on N2 STO-3G
        t = time.time()
        nt.trainer.save_psi(tr2, os.path.join(work, "psi"))
        amps = np.loadtxt(os.path.join(work, "psi.txt"))[:, 0]
        norm = float(np.sum(amps ** 2))
        lap(f"save_psi over N2 STO-3G's {tr2.hilbert.size} states", t)
        print(f"[extras] save_psi: {len(amps)} rows, the squares of the written amplitudes sum "
              f"to {norm:.9f} (tol 1e-6)", flush=True)
        if not (len(amps) == tr2.hilbert.size and abs(norm - 1.0) <= 1e-6):
            raise SystemExit("save_psi's amplitudes are not normalised")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out["walls"] = walls
    print(f"[extras] phase 12 wall times: {json.dumps({k: round(v, 2) for k, v in walls.items()})}; "
          f"total {sum(walls.values()):.1f} s", flush=True)
    return out


# phase 13: the CLI at the paper's width; run A's and run B's flags (the
# temporary output directory and the counts are added per run)
CLI_RUN_A = ["-m", "H2O_6-31G_gen", "-n_hid", "64", "-single_phase", "-n_hid_phase", "512",
             "-n_layer_phase", "2", "-n_lut", "4", "-lr_lut", "1e-2", "-s2_penalty", "0.5",
             "-pretrain_hf", "5", "-presolveH", "-n_train", "6", "-output_freq", "5",
             "-n_unq_samps_max", "100000", "-s", "7"]
CLI_RUN_B = ["-m", "N2_STO-3G_gen", "-n_hid", "64", "-comb_amp_phase", "-input_encoding",
             "integer", "-n_lut", "3", "-presolveH", "-n_train", "6", "-output_freq", "5",
             "-profile", "-s", "7"]


def _cli_runs(zero_counts, wrappers, t_fact, t_dense):
    """Phase 13: `naqs_tpu_torch.cli.run` in process, run A (H2O 6-31G,
    FactorTerms, four LUT shells, H + 0.5 S^2) resumed once with -c, and run B
    (N2 STO-3G, DenseTerms, combined trunk, integer inputs, three LUT shells,
    -profile). Returns each run's kernel launches by kernel name."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from naqs_tpu_torch import cli
    from naqs_tpu_torch import trainer as trainer_mod

    names = {w: w.__name__.lstrip("_") for w in wrappers}
    lut_seen = []
    step = trainer_mod.VMCTrainer.step

    def watched_step(self):
        out = step(self)
        if self.cfg.num_lut:  # the LUT tables after each step, and the groups' LRs
            tables = [p.detach().clone() for k, p in self.model.named_parameters()
                      if k.startswith("lut")]
            lut_seen.append((self.n_steps, tables, [g["lr"] for g in self.optimizer.param_groups]))
        return out

    def one(label, argv, out_dir, need):
        zero_counts()
        lut_seen.clear()
        torch.cuda.synchronize()
        t = time.time()
        summary = cli.run(argv + ["-o", out_dir])["run_0"]
        torch.cuda.synchronize()
        wall = time.time() - t
        launched = {names[w]: w.launches for w in wrappers}
        lines = [json.loads(x) for x in open(os.path.join(out_dir, "log.jsonl"))]
        e_loc = [x["value"] for x in lines if x["key"] == "E_LOC"]
        run_time = [x["value"] for x in lines if x["key"] == "TIME"]
        per_step = np.diff([0.0] + run_time)
        print(f"[cli] run {label}: {wall:.1f} s in all; {len(e_loc)} steps, E_loc {e_loc}; "
              f"step wall times {[round(float(v), 4) for v in per_step]} s; kernel launches "
              f"{launched}", flush=True)
        if not (e_loc and np.isfinite(e_loc).all()):
            raise SystemExit(f"CLI run {label}: a step's E_loc is not finite: {e_loc}")
        missing = [k for k in need if not launched[k]]
        if missing:
            raise SystemExit(f"CLI run {label}: {missing} never launched")
        return summary, launched, per_step, wall

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    trainer_mod.VMCTrainer.step = watched_step
    counts = {}
    try:
        # run A and its resumption
        dir_a = os.path.join(work, "A")
        sum_a, counts["A"], steps_a, wall_a = one(
            "A", CLI_RUN_A, dir_a, ("split_and_compact", "factored_cells_accumulate",
                                    "rank_quadratic_energy"))
        (n0, first, lrs), (n1, last, _) = lut_seen[0], lut_seen[-1]
        moved = [not torch.equal(a, b) for a, b in zip(first, last)]
        print(f"[cli] run A: LUT tables after step {n0} and step {n1}: moved {moved} "
              f"(4 amplitude tables; group LRs {lrs})", flush=True)
        if not (n1 == 6 and len(moved) == 4 and all(moved)):
            raise SystemExit("CLI run A: the LUT tables did not all change in training")
        if lrs[1] != 1e-2:
            raise SystemExit(f"CLI run A: the LUT group's LR is {lrs[1]}, not -lr_lut 1e-2")
        for f in ("summary.json", "args.json", "log.jsonl", "checkpoint.pt"):
            if not os.path.exists(os.path.join(dir_a, f)):
                raise SystemExit(f"CLI run A wrote no {f}")
        if "e_exact_final" in sum_a:
            raise SystemExit("CLI run A: e_exact_final over a basis above 200,000 states")
        resume = list(CLI_RUN_A) + ["-c"]
        resume[resume.index("-n_train") + 1] = "7"
        _, _, steps_c, wall_c = one("A resumed (-c, -n_train 7)", resume, dir_a,
                                    ("split_and_compact", "factored_cells_accumulate"))
        if len(steps_c) != 7 or lut_seen[0][0] != 7:
            raise SystemExit("CLI run A: -c did not resume for exactly one step")
        # run B
        dir_b = os.path.join(work, "B")
        sum_b, counts["B"], steps_b, wall_b = one(
            "B", CLI_RUN_B, dir_b, ("split_and_compact", "dense_grid_accumulate",
                                    "rank_quadratic_energy"))
        trace = os.path.join(dir_b, "profile", "trace.json")
        for f in ("summary.json", "args.json", "log.jsonl", "checkpoint.pt", trace):
            if not os.path.exists(os.path.join(dir_b, f)):
                raise SystemExit(f"CLI run B wrote no {f}")
        if "e_exact_final" not in sum_b:
            raise SystemExit("CLI run B: no e_exact_final over N2 STO-3G's 14,400 states")
        print(f"[cli] run B: exact energy {sum_b['e_exact_final']:.6f} Ha, the sampled "
              f"subspace's {sum_b['e_vmc_fci_subspace']:.6f} Ha; trace "
              f"{os.path.getsize(trace)} B", flush=True)
    finally:
        trainer_mod.VMCTrainer.step = step
        shutil.rmtree(work, ignore_errors=True)
    med = lambda v: float(np.median(v))
    print(f"[cli] per-step wall, steps 2-6 median: run A {med(steps_a[1:]):.4f} s against phase "
          f"6's default model (amp 64, phase 512x512, no LUT, H alone) on H2O 6-31G "
          f"{med(t_fact[1:]):.4f} s: the 4 LUT shells and the H + 0.5 S^2 terms cost "
          f"{med(steps_a[1:]) - med(t_fact[1:]):+.4f} s a step; run B {med(steps_b[1:]):.4f} s "
          f"(combined trunk amp 64 with the phase outputs, integer inputs, 3 LUT shells, "
          f"capacity 100,000, profiled) against phase 10's N2 STO-3G steps (amp 64, phase "
          f"128x128, capacity 8,192) {med(t_dense[1:]):.4f} s: "
          f"{med(steps_b[1:]) - med(t_dense[1:]):+.4f} s a step", flush=True)
    print(f"[cli] phase 13: run A {wall_a:.1f} s, its resumption {wall_c:.1f} s, run B "
          f"{wall_b:.1f} s", flush=True)
    return counts


# phase 14: exact mode at the paper width (phase 3's model and configuration)
EXACT_CHUNK = 65_536          # eloc_fwd_chunk: 26 chunks over H2O 6-31G's sector
EXACT_STEPS = 3               # 14a: exact_eloc training steps (FactorTerms)
EXACT_RANK_STEPS = 2          # 14b: the same on the rank engine
EXACT_XL_STEPS = 2            # 14c: Li2O STO-3G CISDTQ exact_eloc steps
EXACT_RUN = 5                 # 14d: run_exact full-basis steps
EXACT_BATCH = 100_000         # 14e: run_exact minibatch size
EXACT_MINI_STEPS = 2          # 14e: its steps
WINDOW_RTOL, WINDOW_ATOL = 1e-5, 1e-7   # 14d: window against sequential updates
FULL_SLICE = 1 << 18          # 14d: rows a slice when holding the whole basis's kernel
CLI_RUN_C = ["-m", "N2_STO-3G_gen", "-exact_sampling", "-n_train", "30", "-s", "7",
             "-n_hid", "64", "-single_phase", "-n_hid_phase", "512", "-n_layer_phase", "2"]


def _exact_mode(dev, hil, terms, cfg, tc, li2o, x_touched, zero_counts, wrappers):
    """Phase 14: exact mode at the paper width. 14a exact_eloc training on H2O
    6-31G (FactorTerms), 14b the rank and sort engines on the same batch and
    table, 14c Li2O STO-3G CISDTQ with exact_eloc, 14d run_exact over the
    whole basis (the window against sequential updates, a window under
    set_sync_debug_mode("error"), run_exact), 14e run_exact on minibatches.
    `li2o` is (hil3, terms3, cfg3). Returns {"launches": phase 14's launches
    of every kernel (the driven calls; not the holds against the plain
    versions nor the timings), "kernels": per kernel the exact-mode shape's
    hold, held time and bound}."""
    import numpy as np
    import torch

    import naqs_tpu_torch as nt
    from naqs_tpu_torch import trainer as trainer_mod
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops import dense_engine as de
    from naqs_tpu_torch.ops import local_energy as le
    from naqs_tpu_torch.ops.dyn_gather import rank_local_energy_ref, rank_local_energy_tolerance
    from naqs_tpu_torch.ops.grid_kernels import (factored_cells_accumulate,
                                                 factored_cells_accumulate_ref, grid_tolerance,
                                                 xl_grid_accumulate, xl_grid_accumulate_ref)
    from naqs_tpu_torch.ops.rank import build_value_table, rank_index
    from naqs_tpu_torch.ops.sort_lookup import (pack_table, sorted_local_energy_ref,
                                                sorted_local_energy_tolerance)
    from naqs_tpu_torch.utils.bits import SENTINEL
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    names = {w: w.__name__ for w in wrappers}
    kern = {w.__name__: w for w in wrappers}
    launches = dict.fromkeys(names.values(), 0)
    out = {}

    def counted(label, fn, want):
        """fn() with every count at 0 before; its launches join phase 14's.
        `want` maps a kernel's name to its expected launches (None: any
        number above 0); every other kernel must not launch."""
        zero_counts()
        res = fn()
        got = {names[w]: w.launches for w in wrappers}
        for k, v in got.items():
            launches[k] += v
        bad = {k: v for k, v in got.items()
               if (k in want and ((want[k] is None and v == 0)
                                  or (want[k] is not None and v != want[k])))
               or (k not in want and v)}
        print(f"[exact] {label}: launches {({k: v for k, v in got.items() if v})}", flush=True)
        if bad:
            raise SystemExit(f"{label}: unexpected launches {bad} (expected {want})")
        return res

    def stepped(tr, n, label, kernel):
        zero_counts()
        n_upd, times, n_draws = _steps(tr, n, label)
        got = {names[w]: w.launches for w in wrappers}
        for k, v in got.items():
            launches[k] += v
        want = {kernel: n_upd, "_split_and_compact": tr.cfg.n_shells * n_draws}
        print(f"[exact] {label}: {n} steps, {n_upd} vmc_update calls, {n_draws} sample() "
              f"calls; launches {({k: v for k, v in got.items() if v})}; step wall times "
              f"{[round(t, 4) for t in times]} s", flush=True)
        if {k: v for k, v in got.items() if v} != want or n_upd < n:
            raise SystemExit(f"{label}: launches {got}, expected {want}")
        return times

    # 14a. exact_eloc on H2O 6-31G through the default dispatch (FactorTerms)
    t = time.time()
    tc_x = dataclasses.replace(tc, exact_eloc=True, eloc_fwd_chunk=EXACT_CHUNK)
    tr = nt.VMCTrainer(cfg, terms, hil, tc_x, device=dev)
    t_setup = time.time() - t
    fn, spec, dt = tr.dt.dense, tr.dt.rank_spec, tr.dt
    t_states, t_n = tr._table
    n_basis = hil.size
    if not (t_states.shape[0] == -(-n_basis // EXACT_CHUNK) * EXACT_CHUNK
            and int(t_n) == n_basis and type(fn).__name__ == "FactorTerms"
            and bool((t_states[n_basis:] == SENTINEL).all())):
        raise SystemExit("the exact_eloc trainer's sector table or dispatch is not as expected")
    print(f"[exact] 14a: H2O 6-31G exact_eloc trainer in {t_setup:.1f} s: sector table "
          f"{t_states.shape[0]} rows ({t_states.shape[0] // EXACT_CHUNK} chunks of "
          f"{EXACT_CHUNK}), {n_basis} states", flush=True)
    t_exact = stepped(tr, EXACT_STEPS, "exact_eloc factored", "factored_cells_accumulate")
    lpt = [_timed(lambda: trainer_mod.log_psi_table(tr.model, t_states, EXACT_CHUNK))[1]
           for _ in range(3)]
    _, prof_wall, prof_dev = _profiled_call(tr.step)
    step_wall = float(np.median(t_exact[1:]))
    print(f"[exact] 14a: log_psi_table over the {t_states.shape[0]}-row table {lpt} ms; one "
          f"step under torch.profiler: {prof_dev:.2f} ms of device time, {prof_wall:.3f} s of "
          f"wall (the profiler's own cost included); the card busy {prof_dev / 1e3 / step_wall:.0%} "
          f"of an unprofiled step's {step_wall:.3f} s (median of steps 2-{EXACT_STEPS})",
          flush=True)
    out.update(exact_eloc_step_s=t_exact, log_psi_table_ms=float(np.median(lpt)),
               exact_eloc_step_device_ms=prof_dev, exact_eloc_busy=prof_dev / 1e3 / step_wall)
    # one recorded batch, the table's psi, the queries
    batch = tr._sample()
    nu, cap = int(batch.n_unique), batch.states.shape[0]
    with torch.no_grad():
        q_la, q_ph = log_psi(tr.model, batch.states)
        t_la, t_ph = trainer_mod.log_psi_table(tr.model, t_states, EXACT_CHUNK)
    queries = (batch.states, q_la, q_ph)
    table_args = (t_states, t_la, t_ph, t_n)
    e_f = counted("14a local_energy(queries=), FactorTerms",
                  lambda: le.local_energy(dt, *table_args, queries=queries),
                  {"factored_cells_accumulate": 1})
    # the kernel against its plain version on the full-sector grid, read at the
    # query rows (SENTINEL rows past n_unique read exactly 0)
    grid_x, ref_x, _ = de.value_grid(spec, t_states, t_la, t_ph, t_n, fn.sa, fn.sb)
    q_idx = rank_index(spec, batch.states)
    n_q = le._count(cap, dev)
    set_cells = int((grid_x != 0).any(-1).sum())
    if set_cells != n_basis:
        raise SystemExit(f"the sector table's grid sets {set_cells} cells, not {n_basis}")
    f_err = _check_grid_kernel("factored_cells_accumulate (exact: every sector cell set, "
                               "the query rows)", factored_cells_accumulate,
                               factored_cells_accumulate_ref, fn, grid_x, q_idx, n_q)
    de.factored_cells_accumulate = factored_cells_accumulate_ref
    e_fp, t_fp = _timed(lambda: le.local_energy(dt, *table_args, queries=queries))
    de.factored_cells_accumulate = factored_cells_accumulate
    ratio = torch.exp(torch.clamp(ref_x - q_la, -30.0, 30.0)).double()
    tol_e = ratio * grid_tolerance(fn, grid_x, q_idx, n_q).double().sum(-1)
    d_fp = max(float(((a - b).abs() - tol_e).max()) for a, b in zip(e_f, e_fp))
    live = slice(0, nu)
    rows = np.sort(np.random.default_rng(0).choice(nu, size=min(8, nu), replace=False))
    basis = hil.basis
    la_np, ph_np = (x[:n_basis].double().cpu().numpy() for x in (t_la, t_ph))
    e_or = _oracle_rows(terms, basis, la_np, ph_np,
                        np.searchsorted(basis, batch.states[:nu].cpu().numpy()[rows]))
    or_err = float(np.abs(e_f[0][live].cpu().numpy()[rows] - e_or).max())
    pad_im = bool((e_f[1][nu:] == 0).all())
    finite = bool(torch.isfinite(e_f[0]).all() and torch.isfinite(e_f[1]).all())
    print(f"[exact] 14a: local_energy(queries=) on {cap} query rows ({nu} live) against the "
          f"{n_basis}-state table: through factored_cells_accumulate_ref ({t_fp:.0f} ms) "
          f"within ratio x (the row's two grid tolerances) on every row={d_fp <= 0}; {len(rows)} rows "
          f"against the float64 oracle over the whole basis max |dE| {or_err:.3e} Ha (tol "
          f"{ENGINE_TOL}); padding query rows e_im exactly 0={pad_im}; finite={finite}",
          flush=True)
    if not (d_fp <= 0 and or_err <= ENGINE_TOL and pad_im and finite):
        raise SystemExit("14a: exact local energies disagree with the plain version or the "
                         "oracle, or a padding row read a numerator")
    f_work = _cells_work(fn, grid_x, q_idx, n_q)
    out["factored_exact"] = dict(err=f_err, work=f_work, plain_ms=t_fp)

    # 14b. the rank and the sort engine on the same batch and table
    dt_rank = dataclasses.replace(dt, dense=None)
    dt_sort = dataclasses.replace(dt, rank_spec=None, dense=None)
    c = le._chunks(dt, cap, None)
    e_r = counted("14b local_energy(queries=), rank engine",
                  lambda: le.local_energy(dt_rank, *table_args, queries=queries),
                  {"rank_local_energy": 1})
    le.rank_local_energy = rank_local_energy_ref
    e_rp, t_rp = _timed(lambda: le.local_energy(dt_rank, *table_args, queries=queries))
    le.rank_local_energy = kern["rank_local_energy"]
    table_r = build_value_table(spec, *table_args)
    terms_t = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff)
    tol_r = rank_local_energy_tolerance(spec, table_r, batch.states, q_la.float(), *terms_t,
                                        dt.diag_coeff, chunk_rows=c)
    e_s = counted("14b local_energy(queries=), sort engine",
                  lambda: le.local_energy(dt_sort, *table_args, queries=queries),
                  {"sorted_local_energy": 1})
    le.sorted_local_energy = sorted_local_energy_ref
    e_sp, t_sp = _timed(lambda: le.local_energy(dt_sort, *table_args, queries=queries))
    le.sorted_local_energy = kern["sorted_local_energy"]
    packed = pack_table(t_states, t_la, t_ph)
    tol_s = sorted_local_energy_tolerance(packed[0], packed[1], t_n, batch.states, q_la.float(),
                                          *terms_t, dt.diag_coeff, chunk_rows=c)
    errs = {}
    for label, got, want, tol in (("rank_local_energy", e_r, e_rp, tol_r),
                                  ("sorted_local_energy", e_s, e_sp, tol_s)):
        diff = [(a[live] - b[live]).abs() for a, b in zip(got, want)]
        within = all(bool((d <= tol[live]).all()) for d in diff)
        vs_f = max(float((a[live] - b[live]).abs().max()) for a, b in zip(got, e_f))
        errs[label] = max(float(d.max()) for d in diff)
        print(f"[exact] 14b: {label} on the {n_basis}-state table: vs its plain version "
              f"max_abs_err={errs[label]:.3e} Ha, within its per-row tolerance={within}; vs "
              f"14a's factored result {vs_f:.3e} Ha (tol {ENGINE_TOL})", flush=True)
        if not (within and vs_f <= ENGINE_TOL):
            raise SystemExit(f"14b: {label} disagrees with its plain version or with the "
                             f"factored engine on the full-sector table")
    sizes = torch.diff(dt.xy_ptr.long())
    work_r = _rank_work(spec, table_r, batch.states[:nu], dt.xy_unique, sizes, -1e29)
    work_s = _search_work(packed, t_n, batch.states[:nu], dt.xy_unique, sizes)
    r_bound = _row_bound(work_r, nu, cap, dt.xy_unique.numel(), dt.term_yz.numel(),
                         dt.diag_yz.numel(),
                         work_r["pairs"] * SECTOR_OPS + work_r["inside"] * RANK_OPS,
                         work_r["rows"] * 8)
    n_levels = math.ceil(math.log2(n_basis))
    s_bound = _row_bound(work_s, nu, cap, dt.xy_unique.numel(), dt.term_yz.numel(),
                         dt.diag_yz.numel(), work_s["pairs"] * (1 + SEARCH_OPS * n_levels),
                         n_basis * 8 + work_s["rows"] * 8)
    print(f"[exact] 14b: found pairs: rank {work_r['found']} of {work_r['pairs']} pairs "
          f"({work_r['inside']} inside a sector, {work_r['rows']} distinct table rows); sort "
          f"{work_s['found']} ({work_s['rows']} distinct rows); bounds rank "
          f"{r_bound[0][0]:.5f} ms ({r_bound[0][1]}), sort {s_bound[0][0]:.5f} ms "
          f"({s_bound[0][1]}, {n_levels} search levels)", flush=True)
    tr.dt = dt_rank
    t_rank_x = stepped(tr, EXACT_RANK_STEPS, "exact_eloc rank engine", "rank_local_energy")
    tr.dt = dt
    q_packed = pack_table(*queries)
    nv_t = le._count(t_n, dev)
    ker = {
        "factored_cells_accumulate (exact)": lambda: factored_cells_accumulate(
            fn, grid_x, q_idx, n_q),
        "rank_local_energy (exact)": lambda: kern["rank_local_energy"](
            spec, table_r, *q_packed, *terms_t, dt.diag_yz, dt.diag_coeff, chunk_rows=c),
        "sorted_local_energy (exact)": lambda: kern["sorted_local_energy"](
            *packed, nv_t, *q_packed, *terms_t, dt.diag_yz, dt.diag_coeff, chunk_rows=c),
    }
    times = time_in_turns(ker, REPEATS, LAUNCHES)
    for k, v in times.items():
        print(f"[time] {k}: {v[0]:.4f} ms held (spread {v[1][0]:.4f}-{v[1][1]:.4f})",
              flush=True)
    out["rank_exact"] = dict(err=errs["rank_local_energy"], work=work_r, bound=r_bound,
                             plain_ms=t_rp, time=times["rank_local_energy (exact)"],
                             step_s=t_rank_x)
    out["sort_exact"] = dict(err=errs["sorted_local_energy"], work=work_s, bound=s_bound,
                             plain_ms=t_sp, time=times["sorted_local_energy (exact)"],
                             levels=n_levels)
    out["factored_exact"]["time"] = times["factored_cells_accumulate (exact)"]
    del table_r, packed, grid_x, e_rp, e_sp, e_fp

    # 14c. Li2O STO-3G CISDTQ with exact_eloc (FactorTermsXL, queries= with the
    # true diagonal)
    hil3, terms3, cfg3 = li2o
    t = time.time()
    tr3 = nt.VMCTrainer(cfg3, terms3, hil3, tc_x, device=dev)
    xl, spec3 = tr3.dt.dense, tr3.dt.rank_spec
    print(f"[exact] 14c: Li2O STO-3G CISDTQ exact_eloc trainer in {time.time() - t:.1f} s, "
          f"sector table {tr3._table[0].shape[0]} rows for {hil3.size} states", flush=True)
    t_xl = stepped(tr3, EXACT_XL_STEPS, "exact_eloc staircase", "xl_grid_accumulate")
    with torch.no_grad():
        t3_la, t3_ph = trainer_mod.log_psi_table(tr3.model, tr3._table[0], EXACT_CHUNK)
    grid3, _ = de.xl_value_grid(xl, spec3, tr3._table[0], t3_la, t3_ph, tr3._table[1])
    set3 = int((grid3 != 0).any(-1).sum())
    print(f"[exact] 14c: the sector table's grid sets {set3} of the {LI2O_CELLS} staircase "
          f"cells (a cell reads 0 only where |psi| underflows)", flush=True)
    if set3 < 0.99 * LI2O_CELLS:
        raise SystemExit(f"Li2O's sector table sets {set3} grid cells of {LI2O_CELLS}")
    xl_err = _check_grid_kernel("xl_grid_accumulate (exact: the sector table's grid)",
                                xl_grid_accumulate, xl_grid_accumulate_ref, xl, grid3)
    _, t_xp = _timed(lambda: xl_grid_accumulate_ref(xl, grid3))
    t_x = time_in_turns({"xl": lambda: xl_grid_accumulate(xl, grid3)}, SLOW_REPEATS,
                        SLOW_LAUNCHES)["xl"]
    x_work = _xl_sampled_work(xl, grid3, x_touched)
    print(f"[time] xl_grid_accumulate (exact: the sector table's grid): {t_x[0]:.4f} ms held "
          f"(spread {t_x[1][0]:.4f}-{t_x[1][1]:.4f}); plain version {t_xp:.0f} ms; "
          f"{x_work['set_pairs']} set (mask, cell) pairs", flush=True)
    out["xl_exact"] = dict(err=xl_err, work=x_work, plain_ms=t_xp, step_s=t_xl, time=t_x)
    del tr3, grid3

    # 14d. run_exact over the whole basis
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = tr._basis_batch(basis)

    def snapshot():
        return ({k: v.detach().clone() for k, v in tr.model.state_dict().items()},
                {i: {k: v.clone() for k, v in s.items()}
                 for i, s in enumerate(tr.optimizer.state.values())},
                tr.scheduler.last_epoch)

    s0 = ({k: v.clone() for k, v in tr.model.state_dict().items()},
          {"state": {k: {kk: vv.clone() for kk, vv in v.items()}
                     for k, v in tr.optimizer.state_dict()["state"].items()},
           "param_groups": tr.optimizer.state_dict()["param_groups"]},
          tr.scheduler.state_dict())
    ms_w, applied = counted("14d vmc_update_scan(n_live=3, length=4) over the basis",
                            lambda: trainer_mod.vmc_update_scan(
                                tr.model, tr.optimizer, tr.scheduler, dt, full, 3, length=4,
                                clip=tr.clip),
                            {"factored_cells_accumulate": 3})
    after_w = snapshot()
    tr.model.load_state_dict(s0[0])
    tr.optimizer.load_state_dict(s0[1])
    tr.scheduler.load_state_dict(s0[2])
    seq = counted("14d 3 vmc_update calls over the basis",
                  lambda: [trainer_mod.vmc_update(tr.model, tr.optimizer, tr.scheduler, dt, full,
                                                  True, clip=tr.clip) for _ in range(3)],
                  {"factored_cells_accumulate": 3})
    after_s = snapshot()
    worst, bitwise = 0.0, True
    pairs = [(after_w[0][k], after_s[0][k]) for k in after_w[0]]
    for i in after_w[1]:
        pairs += [(after_w[1][i][k], after_s[1][i][k]) for k in ("exp_avg", "exp_avg_sq")]
    for a, b in pairs:
        bitwise = bitwise and torch.equal(a, b)
        worst = max(worst, float(((a - b).abs() - WINDOW_RTOL * b.abs()).max()))
    steps_w = [float(s["step"]) for s in after_w[1].values()]
    steps_s = [float(s["step"]) for s in after_s[1].values()]
    e_seq = [m["e_loc"] for m in seq]
    print(f"[exact] 14d: vmc_update_scan(n_live=3, length=4) against 3 vmc_update calls from "
          f"the same state: parameters and Adam moments within rtol {WINDOW_RTOL} / atol "
          f"{WINDOW_ATOL}={worst <= WINDOW_ATOL} (worst excess {worst:.3e}), bitwise equal="
          f"{bitwise}; step counts {sorted(set(steps_w))} vs {sorted(set(steps_s))}; LR "
          f"positions {after_w[2]} vs {after_s[2]}; applied {applied.tolist()}; e_loc "
          f"{ms_w[:3, 0].tolist()} vs {e_seq}", flush=True)
    if not (worst <= WINDOW_ATOL and steps_w == steps_s and after_w[2] == after_s[2]
            and applied.tolist() == [True, True, True, False] and np.isnan(ms_w[3]).all()):
        raise SystemExit("14d: the window and the sequential updates disagree")
    # a window with no host sync inside: torch raises on any synchronizing call
    window = trainer_mod.UpdateWindow(tr.model, tr.optimizer, tr.scheduler, 2, tr.clip)

    def no_sync_window():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                window.step(dt, full)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return window.close()

    ms_ns, applied_ns = counted("14d a window of 2 under set_sync_debug_mode('error')",
                                no_sync_window, {"factored_cells_accumulate": 2})
    print(f"[exact] 14d: 2 window steps under torch.cuda.set_sync_debug_mode('error'): no "
          f"host sync; e_loc {ms_ns[:, 0].tolist()}, applied {applied_ns.tolist()}", flush=True)
    if not (applied_ns.all() and np.isfinite(ms_ns).all()):
        raise SystemExit("14d: the window under the sync check did not apply finite steps")
    n0 = tr.n_steps
    t = time.time()
    counted(f"14d run_exact({EXACT_RUN}) over the basis", lambda: tr.run_exact(EXACT_RUN),
            {"factored_cells_accumulate": EXACT_RUN})
    torch.cuda.synchronize()
    t_run = time.time() - t
    e_run = [v for s, v in tr.log["E_LOC"] if s > n0]
    if not (len(e_run) == EXACT_RUN and np.isfinite(e_run).all()):
        raise SystemExit(f"14d: run_exact({EXACT_RUN}) logged {e_run}")
    _, w_wall, w_dev = _profiled_call(lambda: trainer_mod.vmc_update_scan(
        tr.model, tr.optimizer, tr.scheduler, dt, full, 1, length=1, clip=tr.clip))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        grid_b, _, idx_b = de.value_grid(spec, full.states, *log_psi(tr.model, full.states),
                                         full.n_unique, fn.sa, fn.sb)
    n_b = le._count(full.n_unique, dev)
    # held against its plain version in slices of rows (a row's sum reads only
    # its own cell; the plain version over every row at once holds 45 GiB)
    got_b = factored_cells_accumulate(fn, grid_b, idx_b, n_b)
    same_b = torch.equal(got_b, factored_cells_accumulate(fn, grid_b, idx_b, n_b))
    fb_err, fb_ok, t_fbp = 0.0, True, 0.0
    for i in range(0, n_basis, FULL_SLICE):
        rows_i = idx_b[i:i + FULL_SLICE]
        n_i = le._count(rows_i.shape[0], dev)
        want_i, t_i = _timed(lambda: factored_cells_accumulate_ref(fn, grid_b, rows_i, n_i))
        t_fbp += t_i
        diff_i = (got_b[i:i + FULL_SLICE] - want_i).abs()
        fb_ok = fb_ok and bool((diff_i <= grid_tolerance(fn, grid_b, rows_i, n_i)).all())
        fb_err = max(fb_err, float(diff_i.max()))
    print(f"[kernel] factored_cells_accumulate (exact: the whole basis as the batch, "
          f"{n_basis} live rows) against its plain version in slices of {FULL_SLICE} rows: "
          f"max_abs_err={fb_err:.3e}, within grid_tolerance={fb_ok}, twice bitwise equal="
          f"{same_b}, finite={bool(torch.isfinite(got_b).all())}", flush=True)
    if not (fb_ok and same_b and bool(torch.isfinite(got_b).all())):
        raise SystemExit("factored_cells_accumulate on the whole basis disagrees with its "
                         "plain version or with itself")
    del got_b
    times_b = time_in_turns({"factored_cells_accumulate (whole basis)":
                             lambda: factored_cells_accumulate(fn, grid_b, idx_b, n_b)},
                            SLOW_REPEATS, SLOW_LAUNCHES)
    t_b = times_b["factored_cells_accumulate (whole basis)"]
    fb_work = _cells_work(fn, grid_b, idx_b, n_b, chunk=32)
    print(f"[exact] 14d: run_exact({EXACT_RUN}) {t_run:.2f} s, {t_run / EXACT_RUN:.3f} s a "
          f"step over {n_basis} rows (E_loc {e_run}); one window step under torch.profiler "
          f"{w_dev:.2f} ms of device time, {w_wall:.3f} s of wall; peak device memory "
          f"{peak / 2**30:.2f} GiB; factored_cells_accumulate on the {n_basis} live rows "
          f"{t_b[0]:.4f} ms held (spread {t_b[1][0]:.4f}-{t_b[1][1]:.4f}; its plain version "
          f"{t_fbp:.0f} ms)", flush=True)
    out["full_basis"] = dict(step_s=t_run / EXACT_RUN, device_ms=w_dev, peak_gib=peak / 2**30,
                             err=fb_err, work=fb_work, time=t_b, plain_ms=t_fbp,
                             bitwise=bitwise)
    del grid_b, idx_b

    # 14e. run_exact on minibatches of the basis with exact local energies
    drawn, update = [], trainer_mod.vmc_update

    def spy(*args, **kw):
        drawn.append(args[4].states.cpu().numpy())
        return update(*args, **kw)

    trainer_mod.vmc_update = spy
    try:
        n0 = tr.n_steps
        counted(f"14e run_exact({EXACT_MINI_STEPS}, batch_size={EXACT_BATCH})",
                lambda: tr.run_exact(EXACT_MINI_STEPS, batch_size=EXACT_BATCH),
                {"factored_cells_accumulate": EXACT_MINI_STEPS})
    finally:
        trainer_mod.vmc_update = update
    rng = np.random.default_rng(tc_x.seed + 1)
    same = all(np.array_equal(d, np.sort(basis[rng.choice(n_basis, size=EXACT_BATCH,
                                                            replace=False)]))
               for d in drawn)
    e_mini = [v for s, v in tr.log["E_LOC"] if s > n0]
    print(f"[exact] 14e: run_exact({EXACT_MINI_STEPS}, batch_size={EXACT_BATCH}): minibatches "
          f"those of np.random.default_rng(seed + 1)={same}; E_loc {e_mini}", flush=True)
    if not (same and len(drawn) == EXACT_MINI_STEPS and np.isfinite(e_mini).all()):
        raise SystemExit("14e: the minibatches or their energies are not as expected")
    out["launches"] = {k.lstrip("_"): v for k, v in launches.items()}
    return out


def _cli_run_c(zero_counts, wrappers):
    """Run C: `naqs_tpu_torch.cli.run` in process with -exact_sampling on N2
    STO-3G at run A's width, 30 steps: one window of 25 and one of 5, E_LOC for
    steps 1..30, the summary's exact <psi|H|psi> at or above the basis ground
    state; then dense_grid_accumulate held against its plain version on the
    run's shape and timed. Returns (its launches by kernel, its numbers)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from naqs_tpu_torch import cli
    from naqs_tpu_torch import trainer as trainer_mod

    made, windows = [], []
    init, scan = trainer_mod.VMCTrainer.__init__, trainer_mod.vmc_update_scan

    def spy_init(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    def spy_scan(*args, **kw):
        windows.append(args[5])
        return scan(*args, **kw)

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_c_")
    trainer_mod.VMCTrainer.__init__, trainer_mod.vmc_update_scan = spy_init, spy_scan
    try:
        zero_counts()
        torch.cuda.synchronize()
        t = time.time()
        summary = cli.run(CLI_RUN_C + ["-o", work])["run_0"]
        torch.cuda.synchronize()
        wall = time.time() - t
        counts = {w.__name__.lstrip("_"): w.launches for w in wrappers}
        lines = [json.loads(x) for x in open(os.path.join(work, "log.jsonl"))]
        have_summary = os.path.exists(os.path.join(work, "summary.json"))
    finally:
        trainer_mod.VMCTrainer.__init__, trainer_mod.vmc_update_scan = init, scan
        shutil.rmtree(work, ignore_errors=True)
    e_loc = [(x["step"], x["value"]) for x in lines if x["key"] == "E_LOC"]
    e_exact, e_sub = summary.get("e_exact_final"), summary.get("e_vmc_fci_subspace")
    print(f"[cli] run C (-exact_sampling, N2 STO-3G, 30 steps): {wall:.1f} s; windows "
          f"{windows}; E_loc at steps {[s for s, _ in e_loc][:3]}..{e_loc[-1][0]}, last "
          f"{e_loc[-1][1]:.6f}; exact <psi|H|psi> {e_exact} Ha against the basis ground state "
          f"{e_sub} Ha ({summary.get('vmc_estimator')}); kernel launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    if not (have_summary and windows == [25, 5]
            and [s for s, _ in e_loc] == list(range(1, 31))
            and np.isfinite([v for _, v in e_loc]).all()
            and summary.get("vmc_estimator") == "exact_psi_H_psi"
            and e_exact is not None and math.isfinite(e_exact) and e_exact >= e_sub - 1e-6
            and counts["dense_grid_accumulate"] == 30):
        raise SystemExit("CLI run C: windows, log, summary or launches not as expected")
    # dense_grid_accumulate at the run's shape: the whole basis as the batch
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops.dense_engine import value_grid
    from naqs_tpu_torch.ops.grid_kernels import dense_grid_accumulate, dense_grid_accumulate_ref
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    tr = made[0]
    dn = tr.dt.dense
    basis = torch.as_tensor(tr.hilbert.basis, device=tr.device)
    with torch.no_grad():
        grid, _, _ = value_grid(tr.dt.rank_spec, basis, *log_psi(tr.model, basis),
                                basis.shape[0], dn.sa, dn.sb)
    err = _check_grid_kernel(f"dense_grid_accumulate (run C: the whole {basis.shape[0]}-state "
                             f"basis as the batch)", dense_grid_accumulate,
                             dense_grid_accumulate_ref, dn, grid)
    _, t_plain = _timed(lambda: dense_grid_accumulate_ref(dn, grid))
    t_k = time_in_turns({"dense": lambda: dense_grid_accumulate(dn, grid)}, REPEATS,
                        LAUNCHES)["dense"]
    print(f"[time] dense_grid_accumulate (run C's shape): {t_k[0]:.4f} ms held (spread "
          f"{t_k[1][0]:.4f}-{t_k[1][1]:.4f}); plain version {t_plain:.1f} ms", flush=True)
    return counts, dict(wall=wall, err=err, time=t_k, plain_ms=t_plain,
                        step_s=float(np.median(np.diff([0.0] + [x["value"] for x in lines
                                                               if x["key"] == "TIME"]))))


# phase 15: the natural-gradient optimizers at the paper width (phase 3's model
# and configuration)
NATGRAD_STEPS = 3             # 15a SR steps (the last with SR_KL_CLIP), 15c K-FAC steps
NATGRAD_EXACT_STEPS = 2       # 15b SR steps with exact_eloc
SR_KL_CLIP = 1e-3             # 15a: sr_kl_clip of the last step
CUT_ROWS = 4_096              # 15a/15c: live rows of the batch held against the CPU port
CUT_CG_ITERS = 5              # 15a: cg_iters of that comparison
# card against CPU, |card - CPU| / |CPU|; measured (H100, PR 18): S v 5.2e-7, the SR
# update after CUT_CG_ITERS iterations 3.9e-5 (float32 CG magnifies the last bits of
# the gradient, 7.2e-7 apart), K-FAC's factors 4.4e-6 and update 8.8e-5 (float32 LU
# solves of the damped 512 x 512 factors)
SV_RTOL = 1e-5                # 15a: S v of a seeded v
SR_UPDATE_RTOL = 2e-4         # 15a: the update after CUT_CG_ITERS iterations
KFAC_RTOL = 2e-4              # 15c: factors, nu and the update
CLI_RUN_D = ["-m", "N2_STO-3G_gen", "-n_hid", "64", "-single_phase", "-n_hid_phase", "512",
             "-n_layer_phase", "2", "-n_unq_samps_min", "1000", "-n_train", "3",
             "-output_freq", "5", "-s", "7"]


def _norm_err(got, want):
    """|got - want| / |want| of two tensors (any devices), in float64."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(torch.linalg.norm(got - want) / torch.clamp(torch.linalg.norm(want),
                                                              min=1e-300))


def _natgrad(dev, hil, terms, cfg, tc, zero_counts, wrappers):
    """Phase 15: the natural-gradient optimizers at the paper width on H2O
    6-31G (FactorTerms). 15a SR at the JAX defaults (cg_iters 50, damping
    1e-3), the last step with sr_kl_clip; 15b SR with exact_eloc; 15c K-FAC at
    its defaults; each with its step times, a profiled step's device time,
    the peak memory, one update under set_sync_debug_mode("error") and the
    card's update held against the CPU port's on a CUT_ROWS-row batch; 15d
    run D of the CLI (-sr, then -kfac with a resumption) on N2 STO-3G.
    Returns {"launches": phase 15's launches by kernel (the driven steps,
    updates and CLI runs; not the card-against-CPU holds), and its numbers}."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import naqs_tpu_torch as nt
    from naqs_tpu_torch import cli
    from naqs_tpu_torch import kfac as kfac_mod
    from naqs_tpu_torch import sr as sr_mod
    from naqs_tpu_torch import trainer as trainer_mod
    from naqs_tpu_torch.models.nade import log_psi_taps, make_zero_eps
    from naqs_tpu_torch.ops.local_energy import DeviceTerms
    from naqs_tpu_torch.sampler import SampleBatch
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    names = {w: w.__name__.lstrip("_") for w in wrappers}
    launches = dict.fromkeys(names.values(), 0)
    out = {}
    ad = {"jvp": 0, "vjp_fn": 0}
    calls = {"update": 0, "sample": 0}
    jvp0, vjp0 = sr_mod.jvp, sr_mod.vjp
    sr0, kfac0, sample0 = trainer_mod.sr_update, trainer_mod.kfac_update, trainer_mod.sample

    def jvp_counted(*args, **kw):
        ad["jvp"] += 1
        return jvp0(*args, **kw)

    def vjp_counted(*args, **kw):
        primal, fn = vjp0(*args, **kw)

        def fn_counted(*a, **k):
            ad["vjp_fn"] += 1
            return fn(*a, **k)

        return primal, fn_counted

    def count_call(fn, key):
        def counted_fn(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        return counted_fn

    def read_launches():
        got = {names[w]: w.launches for w in wrappers}
        for k, v in got.items():
            launches[k] += v
        return {k: v for k, v in got.items() if v}

    def profiled(fn):
        """fn() under torch.profiler: (its result, wall s, device ms, the device
        time by kernel name, ms)."""
        torch.cuda.synchronize()
        t = time.time()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
        wall = time.time() - t
        by_name = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        return res, wall, sum(by_name.values()), by_name

    def stepped(tr, n, label, kernel, before_step=None, profile_step=None):
        """n trainer steps with every count at 0 before; fails unless `kernel`
        ran once per update and split_and_compact once per shell of every
        sample() call, and nothing else."""
        zero_counts()
        calls.update(update=0, sample=0)
        ad.update(jvp=0, vjp_fn=0)
        rows = []
        for i in range(n):
            if before_step:
                before_step(i)
            ad_before = dict(ad)
            if i == profile_step:
                res, wall, dev_ms, by_name = profiled(tr.step)
            else:
                torch.cuda.synchronize()
                t = time.time()
                res = tr.step()
                torch.cuda.synchronize()
                wall, dev_ms, by_name = time.time() - t, None, None
            if not (math.isfinite(res["e_loc"]) and math.isfinite(res["e_loc_var"])):
                raise SystemExit(f"{label}: non-finite energy at step {i + 1}: {res}")
            res.update(wall=wall, device_ms=dev_ms, jvp=ad["jvp"] - ad_before["jvp"],
                       vjp_fn=ad["vjp_fn"] - ad_before["vjp_fn"])
            rows.append(res)
            keep = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in res.items()
                    if k not in ("time", "n_samples")}
            print(f"[natgrad] {label} step {i + 1}: {wall:.3f} s"
                  + (" (profiled)" if i == profile_step else "") + f"; {keep}", flush=True)
            if by_name:
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
                print(f"[natgrad] {label} step {i + 1} under torch.profiler: {dev_ms:.2f} ms of "
                      f"device time; by kernel (ms): "
                      f"{json.dumps({k[:60]: round(v, 3) for k, v in top})}", flush=True)
        got = read_launches()
        want = {kernel: calls["update"], "split_and_compact": tr.cfg.n_shells * calls["sample"]}
        print(f"[natgrad] {label}: {n} steps, {calls['update']} updates, {calls['sample']} "
              f"sample() calls; launches {got}", flush=True)
        if got != want or calls["update"] != n:
            raise SystemExit(f"{label}: launches {got}, expected {want}")
        return rows, got

    def no_sync(label, fn, kernel):
        """fn() under torch.cuda.set_sync_debug_mode("error") (any host sync
        raises), its counts at 0 before: one `kernel` launch."""
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = read_launches()
        print(f"[natgrad] {label} under torch.cuda.set_sync_debug_mode('error'): no host sync; "
              f"launches {got}", flush=True)
        if got != {kernel: 1}:
            raise SystemExit(f"{label}: launches {got}, expected one {kernel}")
        return res

    def live_rows(tr):
        """A sampled batch through the trainer's controller, cut to its live
        rows as step() cuts it."""
        batch, n_unq = tr._get_samples()
        return SampleBatch(batch.states[:n_unq], batch.counts[:n_unq], batch.n_unique,
                           batch.overflow), n_unq

    def cut(batch, device):
        """The first CUT_ROWS live rows of a batch as a batch of their own."""
        return SampleBatch(batch.states[:CUT_ROWS].to(device),
                           batch.counts[:CUT_ROWS].to(device),
                           torch.full((), CUT_ROWS, dtype=torch.int64, device=device),
                           torch.zeros((), dtype=torch.bool, device=device))

    sr_mod.jvp, sr_mod.vjp = jvp_counted, vjp_counted
    trainer_mod.sr_update = count_call(sr0, "update")
    trainer_mod.kfac_update = count_call(kfac0, "update")
    trainer_mod.sample = count_call(sample0, "sample")
    work = tempfile.mkdtemp(prefix="chip_smoke_natgrad_")
    try:
        # 15a. SR at the JAX defaults
        t = time.time()
        tc_sr = dataclasses.replace(tc, use_sr=True)
        tr = nt.VMCTrainer(cfg, terms, hil, tc_sr, device=dev)
        if not (tr.tc.sr_cg_iters == 50 and tr.tc.sr_damping == 1e-3
                and type(tr.dt.dense).__name__ == "FactorTerms"):
            raise SystemExit("15a: the SR trainer's defaults or dispatch are not as expected")
        torch.cuda.reset_peak_memory_stats()
        start_a = torch.cuda.memory_allocated() / 2**30

        def kl_on_last(i):
            if i == NATGRAD_STEPS - 1:
                tr.tc = dataclasses.replace(tr.tc, sr_kl_clip=SR_KL_CLIP)

        rows_a, _ = stepped(tr, NATGRAD_STEPS, "15a SR", "factored_cells_accumulate",
                            kl_on_last, profile_step=1)
        peak_a = torch.cuda.max_memory_allocated() / 2**30
        cg = tr.tc.sr_cg_iters
        for i, r in enumerate(rows_a):
            kl = i == NATGRAD_STEPS - 1
            if not (r["jvp"] == cg + 1 + kl and r["vjp_fn"] == r["jvp"] + 1
                    and 0 < r["cg_iters"] <= cg):
                raise SystemExit(f"15a step {i + 1}: {r['jvp']} jvp and {r['vjp_fn']} vjp_fn "
                                 f"calls, {r['cg_iters']} CG iterations (cg_iters {cg})")
        print(f"[natgrad] 15a: SR on H2O 6-31G at cg_iters {cg}, damping {tr.tc.sr_damping} "
              f"(sr_kl_clip {SR_KL_CLIP} on step {NATGRAD_STEPS}): step wall times "
              f"{[round(r['wall'], 3) for r in rows_a]} s, step 2's device time "
              f"{rows_a[1]['device_ms']:.2f} ms; peak device memory {peak_a:.2f} GiB "
              f"({start_a:.2f} GiB allocated before the steps); trainer and steps "
              f"{time.time() - t:.1f} s", flush=True)
        live, n_unq = live_rows(tr)
        lr = tr._current_lr()
        m = no_sync("15a one sr_update (the batch to its readback)",
                    lambda: sr_mod.sr_update(tr.model, tr.dt, live, lr, tr.tc.sr_damping,
                                             cg_iters=cg, kl_clip=SR_KL_CLIP),
                    "factored_cells_accumulate")
        vals = {k: float(v) for k, v in m.items()}
        print(f"[natgrad] 15a: that update over {n_unq} live rows: {vals}", flush=True)
        if not all(math.isfinite(v) for v in vals.values()):
            raise SystemExit(f"15a: the update under the sync check gave {vals}")
        # the card's update against the CPU port's on CUT_ROWS live rows
        t = time.time()
        dt_cpu = DeviceTerms.from_terms(terms, hilbert=hil, device="cpu")
        t_cpu_terms = time.time() - t
        b_dev, b_cpu = cut(live, dev), cut(live, "cpu")
        m_dev, m_cpu = copy.deepcopy(tr.model), copy.deepcopy(tr.model).cpu()
        s_dev = sr_mod.sr_system(m_dev, tr.dt, b_dev, tr.tc.sr_damping)
        s_cpu = sr_mod.sr_system(m_cpu, dt_cpu, b_cpu, tr.tc.sr_damping)
        v = torch.randn(s_cpu[0].numel(), generator=torch.Generator().manual_seed(0))
        sv_err = _norm_err(s_dev[3](v.to(dev)), s_cpu[3](v))
        g_err = _norm_err(s_dev[2], s_cpu[2])
        del s_dev, s_cpu
        old = torch.cat([p.detach().reshape(-1).cpu() for p in m_cpu.parameters()])
        t = time.time()
        sr_mod.sr_update(m_dev, tr.dt, b_dev, lr, tr.tc.sr_damping, cg_iters=CUT_CG_ITERS)
        torch.cuda.synchronize()
        t_dev = time.time() - t
        t = time.time()
        sr_mod.sr_update(m_cpu, dt_cpu, b_cpu, lr, tr.tc.sr_damping, cg_iters=CUT_CG_ITERS)
        t_cpu = time.time() - t
        new_dev = torch.cat([p.detach().reshape(-1).cpu() for p in m_dev.parameters()])
        new_cpu = torch.cat([p.detach().reshape(-1) for p in m_cpu.parameters()])
        upd_err = _norm_err(new_dev - old, new_cpu - old)
        print(f"[natgrad] 15a: the card against the CPU port on {CUT_ROWS} live rows, full "
              f"width: S v of a seeded v {sv_err:.3e} (tol {SV_RTOL}), the gradient "
              f"{g_err:.3e}, the update after {CUT_CG_ITERS} CG iterations {upd_err:.3e} (tol "
              f"{SR_UPDATE_RTOL}) relative; the update {t_dev:.2f} s on the card, {t_cpu:.2f} s "
              f"on the CPU (its DeviceTerms built in {t_cpu_terms:.1f} s)", flush=True)
        if not (sv_err <= SV_RTOL and upd_err <= SR_UPDATE_RTOL):
            raise SystemExit("15a: the card's SR update disagrees with the CPU port's")
        del m_dev, m_cpu
        out["sr"] = dict(step_s=[r["wall"] for r in rows_a], device_ms=rows_a[1]["device_ms"],
                         peak_gib=peak_a, start_gib=start_a,
                         cg_iters=[r["cg_iters"] for r in rows_a],
                         jvp=[r["jvp"] for r in rows_a], vjp_fn=[r["vjp_fn"] for r in rows_a],
                         sr_dx_norm=[r["sr_dx_norm"] for r in rows_a],
                         grad_norm=[r["grad_norm"] for r in rows_a], sv_err=sv_err,
                         grad_err=g_err, update_err=upd_err)

        # 15b. SR with exact local energies against the whole sector
        tc_x = dataclasses.replace(tc_sr, exact_eloc=True, eloc_fwd_chunk=EXACT_CHUNK)
        tr_x = nt.VMCTrainer(cfg, terms, hil, tc_x, device=dev)
        tr_x.model.load_state_dict(tr.model.state_dict())
        t_states = tr_x._table[0]
        torch.cuda.reset_peak_memory_stats()
        start_b = torch.cuda.memory_allocated() / 2**30
        rows_b, _ = stepped(tr_x, NATGRAD_EXACT_STEPS, "15b SR exact_eloc",
                            "factored_cells_accumulate", profile_step=1)
        peak_b = torch.cuda.max_memory_allocated() / 2**30
        print(f"[natgrad] 15b: SR with exact_eloc (the sector table of "
              f"{t_states.shape[0] // EXACT_CHUNK} chunks of {EXACT_CHUNK} rows): step wall "
              f"times {[round(r['wall'], 3) for r in rows_b]} s, step 2's device time "
              f"{rows_b[1]['device_ms']:.2f} ms; peak device memory {peak_b:.2f} GiB "
              f"({start_b:.2f} GiB allocated before the steps)", flush=True)
        out["sr_exact"] = dict(step_s=[r["wall"] for r in rows_b],
                               device_ms=rows_b[1]["device_ms"], peak_gib=peak_b,
                               start_gib=start_b)
        del tr_x

        # 15c. K-FAC at its defaults
        tr_k = nt.VMCTrainer(cfg, terms, hil, dataclasses.replace(tc, use_kfac=True),
                             device=dev)
        torch.cuda.reset_peak_memory_stats()
        start_c = torch.cuda.memory_allocated() / 2**30
        rows_c, _ = stepped(tr_k, NATGRAD_STEPS, "15c K-FAC", "factored_cells_accumulate",
                            profile_step=1)
        peak_c = torch.cuda.max_memory_allocated() / 2**30
        # the factor Grams and the solves of one update, on a real batch's taps
        live_k, n_k = live_rows(tr_k)
        with torch.no_grad():
            w = live_k.counts / live_k.counts.sum()
        eps = make_zero_eps(tr_k.model, n_k)
        for layers in eps.values():
            for e in layers:
                e.requires_grad_(True)
        (la, ph), taps = log_psi_taps(tr_k.model, live_k.states, eps)
        leaves = [e for name in eps for e in eps[name]]
        g_eps = torch.autograd.grad(torch.sum(w.float() * (la + ph)), leaves)
        layers = [(name, li) for name in eps for li in range(len(eps[name]))]
        # the parameters stand in for their gradients (the same shapes)
        gw = {(n, li): getattr(tr_k.model, n).w[li].detach() for n, li in layers}
        gb = {(n, li): getattr(tr_k.model, n).b[li].detach() for n, li in layers}
        damp = torch.full((), tr_k.tc.kfac_damping, dtype=torch.float32, device=dev)

        def grams_and_solves():
            with torch.no_grad():
                for (n, li), g in zip(layers, g_eps):
                    A, G = kfac_mod._factor_stats(taps[n][li], g, w)
                    kfac_mod._precondition({"A": A, "G": G}, gw[n, li], gb[n, li], damp)

        def grams():
            with torch.no_grad():
                for (n, li), g in zip(layers, g_eps):
                    kfac_mod._factor_stats(taps[n][li], g, w)

        gs = time_in_turns({"grams and solves": grams_and_solves, "grams": grams},
                           SLOW_REPEATS, SLOW_LAUNCHES)
        share = gs["grams and solves"][0] / max(rows_c[1]["device_ms"], 1e-9)
        print(f"[natgrad] 15c: K-FAC on H2O 6-31G (damping {tr_k.tc.kfac_damping}, decay "
              f"{tr_k.tc.kfac_decay}, kl_clip {tr_k.tc.kfac_kl_clip}): step wall times "
              f"{[round(r['wall'], 3) for r in rows_c]} s, step 2's device time "
              f"{rows_c[1]['device_ms']:.2f} ms; peak device memory {peak_c:.2f} GiB "
              f"({start_c:.2f} GiB allocated before the steps); the "
              f"factor Grams and solves of one update over {n_k} rows "
              f"{gs['grams and solves'][0]:.3f} ms held (the Grams alone "
              f"{gs['grams'][0]:.3f}): {share:.1%} of the step's device time", flush=True)
        del taps, g_eps, eps, la, ph
        ks, m = no_sync("15c one kfac_update (the batch to its readback)",
                        lambda: kfac_mod.kfac_update(tr_k.model, tr_k.kfac_state, tr_k.dt, live_k,
                                                     tr_k._current_lr(), tr_k.tc.kfac_damping,
                                                     tr_k.tc.kfac_decay, tr_k.tc.kfac_kl_clip),
                        "factored_cells_accumulate")
        vals = {k: float(v) for k, v in m.items()}
        print(f"[natgrad] 15c: that update over {n_k} live rows: {vals}, factor step "
              f"{int(ks['step'])}", flush=True)
        if not all(math.isfinite(v) for v in vals.values()):
            raise SystemExit(f"15c: the update under the sync check gave {vals}")
        tr_k.kfac_state = ks
        # the card's update against the CPU port's on CUT_ROWS live rows
        b_dev, b_cpu = cut(live_k, dev), cut(live_k, "cpu")
        m_dev, m_cpu = copy.deepcopy(tr_k.model), copy.deepcopy(tr_k.model).cpu()
        ks_cpu = trainer_mod._to_device(ks, "cpu")
        old = torch.cat([p.detach().reshape(-1).cpu() for p in m_cpu.parameters()])
        k_dev, mk_dev = kfac_mod.kfac_update(m_dev, ks, tr_k.dt, b_dev, tr_k._current_lr())
        k_cpu, mk_cpu = kfac_mod.kfac_update(m_cpu, ks_cpu, dt_cpu, b_cpu, tr_k._current_lr())
        fac_err = max(_norm_err(fd[x], fc[x]) for name in ("amp", "phase")
                      for fd, fc in zip(k_dev[name], k_cpu[name]) for x in ("A", "G"))
        nu_err = abs(float(mk_dev["nu"]) - float(mk_cpu["nu"])) / float(mk_cpu["nu"])
        new_dev = torch.cat([p.detach().reshape(-1).cpu() for p in m_dev.parameters()])
        new_cpu = torch.cat([p.detach().reshape(-1) for p in m_cpu.parameters()])
        kupd_err = _norm_err(new_dev - old, new_cpu - old)
        print(f"[natgrad] 15c: the card against the CPU port on {CUT_ROWS} live rows: the "
              f"factors {fac_err:.3e} (worst layer), nu {nu_err:.3e} ({float(mk_cpu['nu']):.4e}), "
              f"the update {kupd_err:.3e} relative (tol {KFAC_RTOL})", flush=True)
        if not max(fac_err, nu_err, kupd_err) <= KFAC_RTOL:
            raise SystemExit("15c: the card's K-FAC update disagrees with the CPU port's")
        out["kfac"] = dict(step_s=[r["wall"] for r in rows_c], device_ms=rows_c[1]["device_ms"],
                           peak_gib=peak_c, start_gib=start_c,
                           grams_solves_ms=gs["grams and solves"][0],
                           grams_ms=gs["grams"][0], share=share, factor_err=fac_err,
                           nu_err=nu_err, update_err=kupd_err)
        del m_dev, m_cpu, tr_k, tr, dt_cpu

        # 15d. run D of the CLI: -sr, then -kfac with a resumption
        def run_d(label, argv, out_dir):
            zero_counts()
            torch.cuda.synchronize()
            t = time.time()
            summary = cli.run(argv + ["-o", out_dir])["run_0"]
            torch.cuda.synchronize()
            wall = time.time() - t
            got = read_launches()
            lines = [json.loads(x) for x in open(os.path.join(out_dir, "log.jsonl"))]
            e_loc = [x["value"] for x in lines if x["key"] == "E_LOC"]
            print(f"[natgrad] 15d run D {label}: {wall:.1f} s; E_loc {e_loc}; exact energy "
                  f"{summary.get('e_exact_final')}; launches {got}", flush=True)
            need = ("split_and_compact", "dense_grid_accumulate")
            if not (e_loc and np.isfinite(e_loc).all() and all(got.get(k) for k in need)):
                raise SystemExit(f"run D {label}: energies {e_loc} or launches {got}")
            return e_loc, wall

        dir_sr, dir_k = os.path.join(work, "D_sr"), os.path.join(work, "D_kfac")
        e_sr, wall_sr = run_d("-sr", CLI_RUN_D + ["-sr"], dir_sr)
        e_k, wall_k = run_d("-kfac", CLI_RUN_D + ["-kfac"], dir_k)
        resume = CLI_RUN_D + ["-kfac", "-c"]
        resume[resume.index("-n_train") + 1] = "4"
        e_kc, wall_kc = run_d("-kfac -c (-n_train 4)", resume, dir_k)
        ckpt = torch.load(os.path.join(dir_k, "checkpoint.pt"), map_location="cpu")
        kstep = int(ckpt["kfac"]["step"])
        facs_ok = all(bool(torch.isfinite(f[x]).all()) for name in ("amp", "phase")
                      for f in ckpt["kfac"][name] for x in ("A", "G"))
        print(f"[natgrad] 15d: run D -kfac resumed for one step: E_LOC for {len(e_kc)} steps; "
              f"checkpoint.pt's K-FAC state at step {kstep}, finite={facs_ok}", flush=True)
        if not (len(e_sr) == 3 and len(e_kc) == 4 and kstep == 4 and facs_ok):
            raise SystemExit("run D: the steps or the K-FAC state read back are not as expected")
        out["cli_d"] = dict(sr_s=wall_sr, kfac_s=wall_k, kfac_resume_s=wall_kc)
    finally:
        sr_mod.jvp, sr_mod.vjp = jvp0, vjp0
        trainer_mod.sr_update, trainer_mod.kfac_update, trainer_mod.sample = sr0, kfac0, sample0
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    return out


# phase 16: data parallelism at the paper width (phase 3's model and configuration)
SHARD_PLAN = (("adam", 3), ("sr", 2), ("kfac", 2))   # 16b/16c: steps of each optimizer
SHARD_RANKS = 2               # 16b: ranks that share the card over gloo
SHARD_MAX_CARDS = 4           # 16c: NCCL across at most this many cards
SHARD_ADAM_RTOL = 1e-5        # 16a: the world of one's Adam update against vmc_update's
SHARD_GRAD_RTOL = 1e-5        # 16b: the summed gradient against the one-process composition's
SHARD_UPDATE_RTOL = 1e-4      # 16b: the update against the composition's (Adam's 4th step)
SHARD_E_TOL = 1e-8            # Ha, 16b: the pair's e_loc against the composition's
SHARD_TIMEOUT = 600           # s: 16b's and 16c's ranks


def _sharded(dev, hil, terms, cfg, tc, zero_counts, wrappers, smi):
    """Phase 16: data parallelism (naqs_tpu_torch/parallel/) at the paper width
    on H2O 6-31G (FactorTerms). 16a: a process group of one rank over NCCL in
    this process; one sharded Adam, SR and K-FAC update on a sampled batch at
    capacity 100,000, each under set_sync_debug_mode("error") and held
    against the single-device update on the same batch from the same state.
    16b: SHARD_RANKS ranks share the card over gloo (parallel/launch.spawn,
    tools/shard_drill.rank_run): VMCTrainer(n_devices=2), 50,000 rows a rank,
    SHARD_PLAN's steps each under torch.profiler with its collectives timed;
    the ranks' parameters bitwise equal; a fixed pair of batches' Adam update
    against a one-process composition over the merged rows; rank 0's E_loc
    kernels at that pair's merged table, repeated keys and all, against
    their plain versions; each rank's launches. 16c: the same over NCCL
    across min(count, SHARD_MAX_CARDS) cards where the machine has two or
    more. Returns {"launches": every rank's
    launches of the driven updates and steps, summed, and the numbers}."""
    import copy
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import naqs_tpu_torch as nt
    from naqs_tpu_torch import kfac as kfac_mod
    from naqs_tpu_torch import sr as sr_mod
    from naqs_tpu_torch import trainer as trainer_mod
    from naqs_tpu_torch.parallel import comm, initialize_distributed
    from naqs_tpu_torch.parallel import step as pstep
    from naqs_tpu_torch.parallel.launch import spawn
    from naqs_tpu_torch.sampler import sample
    from naqs_tpu_torch.tools import shard_drill

    names = {w: w.__name__.lstrip("_") for w in wrappers}
    launches = dict.fromkeys(names.values(), 0)
    out = {}

    def flat(model):
        return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

    def no_sync(label, fn):
        """fn() under set_sync_debug_mode("error"), the counts at 0 before:
        one factored_cells_accumulate launch and no other kernel."""
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = {names[w]: w.launches for w in wrappers if w.launches}
        for k, v in got.items():
            launches[k] += v
        if got != {"factored_cells_accumulate": 1}:
            raise SystemExit(f"16a {label}: launches {got}")
        return res

    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        # 16a. NCCL, a world of one, in this process
        t = time.time()
        torch.cuda.set_device(dev.index or 0)
        if not initialize_distributed(f"file://{work}/store", 1, 0, backend="nccl"):
            raise SystemExit("16a: the NCCL process group of one rank did not come up")
        print(f"[sharded] route: {comm.ROUTE}; 16a backend {dist.get_backend()}, world "
              f"{comm.world()}", flush=True)
        tr = nt.VMCTrainer(cfg, terms, hil, tc, device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        b0 = sample(tr.model, gen, 1e5, tr.capacity)
        batch = sample(tr.model, gen, 1e5, tr.capacity)
        if bool(b0.overflow) or bool(batch.overflow):
            raise SystemExit("16a: the batches overflowed")
        comm.all_reduce_sum(torch.ones(1, device=dev))   # NCCL's communicator, made once
        # Adam: one shared vmc_update first, so the compared step is not Adam's
        # first (whose ~lr * sign(g) would flip on a gradient within rounding of 0)
        opt0, sched0 = tc.make_optimizer(tr.model.parameters())
        trainer_mod.vmc_update(tr.model, opt0, sched0, tr.dt, b0)
        m_s, m_1 = copy.deepcopy(tr.model), copy.deepcopy(tr.model)
        (o_s, s_s), (o_1, s_1) = (tc.make_optimizer(m.parameters()) for m in (m_s, m_1))
        for o in (o_s, o_1):   # a copy each: load_state_dict keeps the tensors it is given
            o.load_state_dict(copy.deepcopy(opt0.state_dict()))
        for s in (s_s, s_1):
            trainer_mod._set_schedule(s.optimizer, s, sched0.last_epoch)
        old = flat(tr.model)
        window = trainer_mod.UpdateWindow(m_s, o_s, s_s, 1)
        m = no_sync("sharded Adam", lambda: pstep.sharded_adam_update(m_s, window, tr.dt, batch))
        window.settle(0 if bool(m["overflow"]) else 1)
        m1 = trainer_mod.vmc_update(m_1, o_1, s_1, tr.dt, batch)
        adam_err = _norm_err(flat(m_s) - old, flat(m_1) - old)
        adam_de = abs(float(m["e_loc"]) - m1["e_loc"])
        # SR at CUT_CG_ITERS iterations, K-FAC from fresh factors
        lr, damp = tr._current_lr(), tc.sr_damping
        m_s, m_1 = copy.deepcopy(tr.model), copy.deepcopy(tr.model)
        old = flat(tr.model)
        ms = no_sync("sharded SR", lambda: pstep.sharded_sr_update(m_s, tr.dt, batch, lr, damp,
                                                                  CUT_CG_ITERS))
        m1 = sr_mod.sr_update(m_1, tr.dt, batch, lr, damp, cg_iters=CUT_CG_ITERS)
        sr_err = _norm_err(flat(m_s) - old, flat(m_1) - old)
        sr_de = abs(float(ms["e_loc"]) - float(m1["e_loc"]))
        m_s, m_1 = copy.deepcopy(tr.model), copy.deepcopy(tr.model)
        ks_s, ks_1 = kfac_mod.kfac_init(m_s), kfac_mod.kfac_init(m_1)
        ks_s, mk = no_sync("sharded K-FAC", lambda: pstep.sharded_kfac_update(m_s, ks_s, tr.dt,
                                                                             batch, lr))
        ks_1, mk1 = kfac_mod.kfac_update(m_1, ks_1, tr.dt, batch, lr)
        kfac_err = max(_norm_err(flat(m_s) - old, flat(m_1) - old),
                       max(_norm_err(fs[x], f1[x]) for name in ("amp", "phase")
                           for fs, f1 in zip(ks_s[name], ks_1[name]) for x in ("A", "G")),
                       abs(float(mk["nu"]) - float(mk1["nu"])) / float(mk1["nu"]))
        dist.destroy_process_group()
        print(f"[sharded] 16a: NCCL, one rank, H2O 6-31G at capacity {tr.capacity} "
              f"({int(batch.n_unique)} live rows), each update under "
              f"set_sync_debug_mode('error'): no host sync; against the single-device update "
              f"on the same batch: Adam {adam_err:.3e} (tol {SHARD_ADAM_RTOL}, e_loc "
              f"{adam_de:.1e} Ha apart), SR at {CUT_CG_ITERS} CG iterations {sr_err:.3e} (tol "
              f"{SR_UPDATE_RTOL}, e_loc {sr_de:.1e}), K-FAC {kfac_err:.3e} (worst of the "
              f"update, the factors and nu; tol {KFAC_RTOL}); {time.time() - t:.1f} s; {smi}",
              flush=True)
        if not (adam_err <= SHARD_ADAM_RTOL and sr_err <= SR_UPDATE_RTOL
                and kfac_err <= KFAC_RTOL):
            raise SystemExit("16a: a sharded update of one rank disagrees with the "
                             "single-device update")
        out["world_of_one"] = dict(adam_err=adam_err, sr_err=sr_err, kfac_err=kfac_err,
                                   adam_e_diff=adam_de, sr_e_diff=sr_de)
        del tr, m_s, m_1, window, opt0, o_s, o_1

        # 16b. two ranks share the card over gloo; 16c. NCCL across cards
        count = torch.cuda.device_count()
        runs = [("16b", SHARD_RANKS, "gloo", f"cuda:{dev.index or 0}")]
        if count >= 2:
            runs.append(("16c", min(count, SHARD_MAX_CARDS), "nccl", None))
        for label, world, backend, device in runs:
            t = time.time()
            res = spawn(shard_drill.rank_run, world,
                        (hil, terms, cfg, tc, SHARD_PLAN, device), workdir=work,
                        backend=backend, timeout=SHARD_TIMEOUT)
            wall = time.time() - t
            out[label] = _check_sharded(label, res, wall, smi, cfg.n_shells)
            for r in res:
                for k, v in r["launches"].items():
                    launches[k] += v
        if count < 2:
            print(f"[sharded] 16c: NCCL across cards was not run: torch.cuda.device_count() "
                  f"= {count}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    return out


def _check_sharded(label, res, wall, smi, n_shells):
    """16b's or 16c's rank results: printed, then held to the phase's checks
    (split_and_compact n_shells times a sample() call); returns the numbers
    kept."""
    world = len(res)
    for r in res:
        for row in r["rows"]:
            print(f"[sharded] {label} rank {r['rank']} ({r['backend']}, {r['device']}) "
                  f"{row['optimizer']} step {row['step']}: {row['wall_s']:.3f} s wall, "
                  f"{row['device_ms']:.2f} ms of device time (under torch.profiler); "
                  f"{row['collectives']} collectives, {row['collective_s'] * 1e3:.1f} ms on the "
                  f"host's clock, {row['collective_bytes']} B; e_loc {row['e_loc']:.6f}, "
                  f"n_unique {row['n_unique']}, n_samples {row['n_samples']:.0e}"
                  + (f", cg_iters {row['cg_iters']}" if row["cg_iters"] is not None else ""),
                  flush=True)
        print(f"[sharded] {label} rank {r['rank']}: launches {r['launches']}; the fixed pair's "
              f"Adam update against the one-process composition over the merged rows: "
              f"gradient {r['check']['grad_err']:.3e} (tol {SHARD_GRAD_RTOL}), update "
              f"{r['check']['update_err']:.3e} (tol {SHARD_UPDATE_RTOL}), e_loc "
              f"{r['check']['e_loc']:.9f} vs {r['check']['e_loc_composed']:.9f}; "
              f"n_unique {r['check']['n_unique']}; peak {r['peak_gib']:.2f} GiB", flush=True)
    keys = res[0]["repeated_keys"]
    for eng, k in keys["engines"].items():
        print(f"[sharded] {label} rank 0: the {eng} engine's E_loc kernel at the pair's merged "
              f"table ({keys['n_valid']} live rows, {keys['repeats']} of them a second copy of "
              f"a state) for its {keys['rows']} query rows against its plain version: "
              f"max_abs_err={k['max_abs_err']:.3e}, worst row at {k['worst']:.3f} of its "
              f"tolerance, within={k['within']}; against the same table without the repeats "
              f"{k['dedup_diff']:.3e} ({'grids equal' if eng == 'fact' else 'within'}="
              f"{k['dedup_within']})", flush=True)
    digests = {r["digest"] for r in res}
    after = {r["digest_after_check"] for r in res}
    steps = sum(n for _, n in SHARD_PLAN)
    print(f"[sharded] {label}: {world} ranks, {wall:.1f} s in all (start-up, DeviceTerms, "
          f"{steps} steps a rank, the check); parameters bitwise equal across ranks after the "
          f"steps: {len(digests) == 1}, after the check: {len(after) == 1}; {smi}", flush=True)
    bad = []
    if len(digests) != 1 or len(after) != 1:
        bad.append("the ranks' parameters differ")
    if keys["repeats"] <= 0:
        bad.append("the pair's merged table holds no repeated state")
    for eng, k in keys["engines"].items():
        if not (k["within"] and k["dedup_within"]):
            bad.append(f"the {eng} engine's kernel at repeated keys: {k}")
    for r in res:
        c = r["check"]
        if not (c["grad_err"] <= SHARD_GRAD_RTOL and c["update_err"] <= SHARD_UPDATE_RTOL
                and abs(c["e_loc"] - c["e_loc_composed"]) <= SHARD_E_TOL and not c["overflow"]):
            bad.append(f"rank {r['rank']}'s pair disagrees with the composition: {c}")
        got = r["launches"]
        updates = len(r["rows"])
        if not (set(got) == {"factored_cells_accumulate", "split_and_compact"}
                and got["factored_cells_accumulate"] >= updates
                and got["split_and_compact"] % n_shells == 0):
            bad.append(f"rank {r['rank']}'s launches {got}")
        if not all(math.isfinite(x["e_loc"]) for x in r["rows"]):
            bad.append(f"rank {r['rank']}: a non-finite energy")
    if bad:
        raise SystemExit(f"{label}: " + "; ".join(bad))
    rows0 = res[0]["rows"]
    return dict(world=world, wall_s=wall, route=res[0]["route"],
                steps={f"{x['optimizer']}{x['step']}": dict(
                    wall_s=x["wall_s"], device_ms=x["device_ms"], collectives=x["collectives"],
                    collective_s=x["collective_s"], collective_bytes=x["collective_bytes"])
                    for x in rows0},
                checks=[r["check"] for r in res], launches_by_rank=[r["launches"] for r in res],
                repeated_keys=keys)


def _exact_entries(exact, cli_c, d_bound):
    """The kernels line's exact-mode keys of the five kernels phase 14 and
    run C drive at new shapes: each held time beside its plain version's and
    a bound recounted for that shape's data. Prints the bounds."""
    fq, fb = exact["factored_exact"], exact["full_basis"]
    q_bound = _bound(fq["work"]["bytes"], fq["work"]["ops"])
    b_bound = _bound(fb["work"]["bytes"], fb["work"]["ops"])
    x = exact["xl_exact"]
    x_bound = _bound(x["work"]["bytes"], x["work"]["ops"])
    cells = lambda w: {k: w[k] for k in ("live", "valid_pairs", "found_pairs", "factors")}
    for label, bd, w in (("factored_cells_accumulate, exact queries", q_bound, fq["work"]),
                         ("factored_cells_accumulate, the whole basis", b_bound, fb["work"]),
                         ("xl_grid_accumulate, the sector table's grid", x_bound, x["work"])):
        print(f"[bound] {label}: {bd[0]:.5f} ms ({bd[1]}: {w['bytes']} B, {w['ops']} "
              f"operations)", flush=True)
    rows = {}
    for name, key in (("rank_local_energy", "rank_exact"), ("sorted_local_energy", "sort_exact")):
        e = exact[key]
        rows[name] = dict(
            exact_ms=e["time"][0], exact_spread=e["time"][1], exact_plain_ms=e["plain_ms"],
            exact_max_abs_err=e["err"], exact_bound_ms=e["bound"][0][0],
            exact_bound_by=e["bound"][0][1], exact_pairs=e["work"]["pairs"],
            exact_found_pairs=e["work"]["found"], exact_table_rows_read=e["work"]["rows"],
            exact_note="local_energy(queries=) of phase 14b: H2O 6-31G, the 1,656,369-state "
                       "sector table, 100,000 query rows")
        print(f"[bound] {name}, exact queries: {e['bound'][0][0]:.5f} ms ({e['bound'][0][1]}: "
              f"{e['bound'][2]} B, {e['bound'][1]} operations)", flush=True)
    rows["rank_local_energy"]["exact_pairs_inside_sector"] = exact["rank_exact"]["work"]["inside"]
    rows["rank_local_energy"]["exact_rank_step_s"] = exact["rank_exact"]["step_s"]
    rows["sorted_local_energy"]["exact_search_levels"] = exact["sort_exact"]["levels"]
    rows["factored_cells_accumulate"] = dict(
        exact_queries_ms=fq["time"][0], exact_queries_spread=fq["time"][1],
        exact_queries_plain_ms=fq["plain_ms"], exact_queries_max_abs_err=fq["err"],
        exact_queries_bound_ms=q_bound[0], exact_queries_bound_by=q_bound[1],
        exact_queries_work=cells(fq["work"]),
        full_basis_ms=fb["time"][0], full_basis_spread=fb["time"][1],
        full_basis_plain_ms=fb["plain_ms"], full_basis_max_abs_err=fb["err"],
        full_basis_bound_ms=b_bound[0], full_basis_bound_by=b_bound[1],
        full_basis_work=cells(fb["work"]), exact_eloc_step_s=exact["exact_eloc_step_s"],
        exact_eloc_step_device_ms=exact["exact_eloc_step_device_ms"],
        exact_eloc_busy=exact["exact_eloc_busy"], log_psi_table_ms=exact["log_psi_table_ms"],
        run_exact_step_s=fb["step_s"], run_exact_step_device_ms=fb["device_ms"],
        run_exact_peak_gib=fb["peak_gib"], window_bitwise=fb["bitwise"],
        exact_note="exact_queries: phase 14a's local_energy(queries=) on H2O 6-31G, every "
                   "sector cell set, 100,000 query rows; full_basis: phase 14d, the "
                   "1,656,369-state basis as the batch")
    rows["xl_grid_accumulate"] = dict(
        exact_ms=x["time"][0], exact_spread=x["time"][1], exact_plain_ms=x["plain_ms"],
        exact_max_abs_err=x["err"], exact_bound_ms=x_bound[0], exact_bound_by=x_bound[1],
        exact_set_pairs=x["work"]["set_pairs"], exact_step_s=x["step_s"],
        exact_note="phase 14c: Li2O STO-3G CISDTQ, the sector table's grid")
    rows["dense_grid_accumulate"] = dict(
        exact_ms=cli_c["time"][0], exact_spread=cli_c["time"][1],
        exact_plain_ms=cli_c["plain_ms"], exact_max_abs_err=cli_c["err"],
        exact_bound_ms=d_bound[0], exact_bound_by=d_bound[1], cli_c_step_s=cli_c["step_s"],
        cli_c_s=cli_c["wall"],
        exact_note="run C: N2 STO-3G, the whole 14,400-state basis as the batch; the bound "
                   "counts every valid (mask, cell) pair, as phase 10's, whatever the data")
    return rows


def main(argv) -> int:
    import inspect

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import naqs_tpu_torch as nt
    from naqs_tpu_torch import sampler as sampler_mod
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops import _build
    from naqs_tpu_torch.ops import local_energy as le
    from naqs_tpu_torch.ops.dense_engine import _xl_blocked_idx, value_grid, xl_value_grid
    from naqs_tpu_torch.ops.dyn_gather import (QUAD_MISS, ROWSUM_ATOL, ROWSUM_RTOL,
                                               rank_gather2, rank_gather2_ref,
                                               rank_local_energy, rank_local_energy_ref,
                                               rank_local_energy_tolerance,
                                               rank_quadratic_energy, rank_quadratic_energy_ref,
                                               rank_quadratic_energy_tolerance,
                                               rank_ratio_rowsum, rank_ratio_rowsum_ref,
                                               ratio_rowsum, rowsum_tolerance)
    from naqs_tpu_torch.ops.dense_engine import factored_local_energy
    from naqs_tpu_torch.ops.grid_kernels import (_live_cells,
                                                 dense_grid_accumulate,
                                                 dense_grid_accumulate_ref,
                                                 factored_cells_accumulate,
                                                 factored_cells_accumulate_ref, grid_tolerance,
                                                 xl_grid_accumulate, xl_grid_accumulate_ref)
    from naqs_tpu_torch.ops.multinomial import multinomial4_split, multinomial4_split_ref
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    from naqs_tpu_torch import native
    from naqs_tpu_torch.hamiltonian import (_assemble_rows_np, assemble_sparse_hamiltonian_np,
                                            diagonal_energy_np, freeze_core)
    from naqs_tpu_torch.ops.offdiag_h import (OFFDIAG_ATOL, OFFDIAG_RTOL, offdiag_h_terms,
                                              offdiag_h_terms_ref, offdiag_tolerance,
                                              term_group)
    from naqs_tpu_torch.ops.rank import build_value_table, rank_index
    from naqs_tpu_torch.ops.sort_lookup import (DIAG_RTOL, pack_table,
                                                sorted_gather2, sorted_gather2_ref,
                                                sorted_local_energy, sorted_local_energy_ref,
                                                sorted_local_energy_tolerance, sorted_log_amps,
                                                sorted_quadratic_energy,
                                                sorted_quadratic_energy_ref,
                                                sorted_quadratic_energy_tolerance,
                                                sorted_ratio_rowsum, sorted_ratio_rowsum_ref)
    from naqs_tpu_torch.ops.sampler_kernels import launch as sampler_launch
    from naqs_tpu_torch.ops.sampler_kernels import split_tile_rows
    from naqs_tpu_torch.tools import split_timing
    from naqs_tpu_torch.sampler import (_compact_children, _compact_children_ref,
                                        _split_and_compact, _split_and_compact_ref,
                                        _split_frontier)
    from naqs_tpu_torch.utils.bits import SENTINEL, parity_pm1
    from naqs_tpu_torch.utils.cuda_timing import HOLD_CYCLES, time_in_turns

    dev = torch.device("cuda")
    t0 = time.time()
    wrappers = (rank_gather2, rank_ratio_rowsum, factored_cells_accumulate,
                dense_grid_accumulate, multinomial4_split, _compact_children, _split_and_compact,
                xl_grid_accumulate, sorted_ratio_rowsum, sorted_gather2, offdiag_h_terms,
                sorted_local_energy, rank_local_energy, rank_quadratic_energy,
                sorted_quadratic_energy)
    # the sort engine's kernels and the one-launch kernels of the spaces with no
    # dense A: none runs on the grid engines' or the rank engine's step
    row_wrappers = (sorted_ratio_rowsum, sorted_gather2, offdiag_h_terms, sorted_local_energy,
                    rank_local_energy, rank_quadratic_energy, sorted_quadratic_energy)

    def zero_counts():
        for w in wrappers:
            w.launches = 0

    # 1. build
    build_logs = _build.build_all()
    for name, out in build_logs.items():
        print(f"[build] {name}: nvcc {time.time() - t0:.1f}s\n{out.strip()}", flush=True)
    split_regs = {("f64" if "F64Row" in k else "f32"): v for k, v in _ptxas_registers(
        build_logs.get("sampler_step", ""), "split_and_compact_kernel").items()}
    split_alone_regs = list(_ptxas_registers(build_logs.get("sampler_step", ""),
                                             "multinomial4_split_kernel").values())
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
    t2 = time.time()
    tr = nt.VMCTrainer(cfg, terms, hil, tc, device=dev)
    dt = tr.dt
    fn = dt.dense
    if type(fn).__name__ != "FactorTerms":
        raise SystemExit(f"H2O 6-31G must carry FactorTerms, got {type(fn).__name__}")
    dt_rank = dataclasses.replace(dt, dense=None)
    spec = dt.rank_spec
    print(f"[setup] H2O 6-31G: {mol.n_qubits} qubits, |basis|={hil.size}, "
          f"K={len(terms.coeff)} Kxy={len(terms.xy_unique)} (pad {dt.xy_unique.shape[0]}) "
          f"Kyz={len(terms.yz_unique)} Kd={len(terms.diag_yz)}; "
          f"{sum(p.numel() for p in tr.model.parameters())} params; "
          f"{time.time() - t1:.1f}s, of which the trainer with its DeviceTerms "
          f"{time.time() - t2:.1f}s", flush=True)
    print(f"[setup] FactorTerms: Sa={fn.sa} Sb={fn.sb} Kxy_pad={fn.ga.shape[0]} "
          f"Ka={fn.pa_idx.shape[0]} Kb={fn.pb_idx.shape[0]} Kya={fn.par_a.shape[0]} "
          f"Kyb={fn.par_b.shape[0]}, factors per mask max {int(fn.n_fact.max())} mean "
          f"{float(fn.n_fact.sum()) / len(terms.xy_unique):.2f} ({fn.slots.shape[0]} packed "
          f"slots)", flush=True)

    # 4. both rank kernels against their plain versions on the real table
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    table = build_value_table(spec, batch.states, la, ph, batch.n_unique)
    chunk = le._chunks(dt, batch.states.shape[0], None)
    s = batch.states[:chunk].contiguous()
    my_la, my_ph = la[:chunk].float().contiguous(), ph[:chunk].float().contiguous()
    xy = dt.xy_unique
    h = _dense_h(dt, s)
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

    # 5. the factored cells kernel against its plain version on the real sampled
    # grid, over the whole buffer (the rows E_loc reads: the first n_unique)
    grid, _, g_idx = value_grid(spec, batch.states, la, ph, batch.n_unique, fn.sa, fn.sb)
    if bool(grid[fn.sa].any()) or bool(grid[:, fn.sb].any()):
        raise SystemExit("the value grid's pad row or column is not zero")
    g_n = batch.n_unique
    factored_err = _check_grid_kernel("factored_cells_accumulate", factored_cells_accumulate,
                                      factored_cells_accumulate_ref, fn, grid, g_idx, g_n)
    f_work = _cells_work(fn, grid, g_idx, g_n)

    # 5b. the sampler's shell step on the inputs of real sample() calls
    cap = tr.capacity
    n_shells = cfg.n_shells
    totals = {"rows": 0, "differ": 0, "err": 0.0}
    compact_totals = {"err": 0.0, "cases": 0}
    fused_totals = {"err": 0.0, "cases": 0}

    def check_fused(label, args):
        return _check_frontier(label, _split_and_compact, _split_and_compact_ref, args,
                               fused_totals)

    def check_compact(label, args):
        return _check_frontier(label, _compact_children, _compact_children_ref, args,
                               compact_totals)
    batch_fields = ("states", "counts", "n_unique", "overflow")
    fullest, fullest_live, fullest_stats = None, -1, None
    for label, n_samp in (("first", tr.n_samples), ("steady", 1e5)):
        gen_state = tr.gen.get_state()
        b_own = sampler_mod.sample(tr.model, tr.gen, n_samp, cap)
        tr.gen.set_state(gen_state)
        b_rec, shells = _shell_inputs(tr.model, tr.gen, n_samp, cap)
        if not all(torch.equal(getattr(b_rec, f), getattr(b_own, f)) for f in batch_fields):
            raise SystemExit("the kept shell loop is not sample()'s: the batches differ")
        print(f"[shell] sample() at n_samples={n_samp:.0e}, capacity {cap}: n_unique="
              f"{int(b_rec.n_unique)} overflow={bool(b_rec.overflow)}; the shell loop that "
              f"keeps its inputs gives the same batch bitwise", flush=True)
        for j, args in enumerate(shells):
            n_fused = check_fused(f"{label} shell {j}", args)
            # the f64 instantiation on the same shell (a float64 model's conditionals)
            if check_fused(f"{label} shell {j} f64", (*args[:4], args[4].double(), *args[5:])) \
                    != n_fused:
                raise SystemExit(f"{label} shell {j}: the f64 shell step counts other children")
            st = _check_split(f"{label} shell {j}", _split_of(args), totals)
            n_kids = check_compact(f"{label} shell {j}", _compaction_of(args))
            live = cap - st["dead_rows"]
            print(f"[shell] {label} j={j}: live rows {live}, binomials of live rows: "
                  f"{st['gauss']} Gaussian, {st['cdf']} inverse CDF ({st['cdf_steps']} looks, "
                  f"longest {st['cdf_longest']}); dead rows {st['dead_rows']}; n_children="
                  f"{n_kids}; split_and_compact (f32 and f64 probs), split and compaction "
                  f"bitwise equal to their plain versions and to themselves run twice",
                  flush=True)
            if n_fused != n_kids:
                raise SystemExit(f"{label} shell {j}: the fused and the two-kernel shell step "
                                 f"count other children")
            if label == "steady" and live > fullest_live:
                fullest, fullest_live, fullest_stats = args, live, st
    syn = split_timing.synthetic_split(cap, dev)
    st = _check_split("synthetic", (*syn, None, None), totals)
    n_syn = check_fused("synthetic", _shell_step(syn, cap, dev, 7))
    print(f"[shell] synthetic split of {cap} rows: {st['gauss']} Gaussian, {st['cdf']} inverse "
          f"CDF binomials ({st['cdf_steps']} looks, longest {st['cdf_longest']}), dead rows "
          f"{st['dead_rows']}; through split_and_compact (every row valid, every child "
          f"allowed): {n_syn} children, bitwise", flush=True)
    if st["gauss"] > 0.01 * st["cdf"] or st["cdf_longest"] < 40:
        raise SystemExit("the synthetic split did not force the inverse CDF")
    print(f"[kernel] multinomial4_split: {totals['differ']} of {totals['rows']} rows differ "
          f"from the plain version over {2 * n_shells} real shells and the synthetic case "
          f"(max_abs_err={totals['err']}); row sums exact with mask=None", flush=True)
    gen5 = torch.Generator(device=dev).manual_seed(6)
    over = (torch.randint(0, 1 << n_shells, (cap,), generator=gen5, device=dev),
            torch.randint(0, 1 << n_shells, (cap,), generator=gen5, device=dev),
            torch.rand((cap, 4), generator=gen5, device=dev, dtype=torch.float64),
            torch.rand((cap, 4), generator=gen5, device=dev) < 0.5, n_shells - 1, cap)
    n_kids = check_compact("overflowing compaction", over)
    gen5.manual_seed(8)
    n_over = check_fused("overflowing shell step", _shell_step(
        (torch.full((cap,), 1e12, dtype=torch.float64, device=dev),
         torch.rand((cap, 4), generator=gen5, device=dev),
         torch.randn((3, cap), generator=gen5, device=dev),
         torch.rand((3, cap), generator=gen5, device=dev)), cap, dev, 9))
    wide = 1_000_003   # more tiles than the card holds blocks at once
    wide_syn = split_timing.synthetic_split(wide, dev)
    wide_args = list(_shell_step(wide_syn, wide, dev, 10))
    wide_args[3] = torch.rand(wide, generator=gen5, device=dev) < 0.3      # valid
    wide_args[7] = torch.rand((wide, 4), generator=gen5, device=dev) < 0.8  # mask
    n_wide = check_fused("1,000,003 rows", tuple(wide_args))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = split_tile_rows()
    wide_tiles, most_blocks = -(-wide // tile), 2048 // tile * sms   # 2,048 threads an SM
    print(f"[kernel] split_and_compact: bitwise equal to its plain version and to itself run "
          f"twice in {fused_totals['cases']} cases: {2 * n_shells} real shells with f32 and "
          f"with f64 probs, the synthetic split, an overflowing step ({n_over} children into "
          f"{cap} slots) and {wide} rows in {wide_tiles} tiles of {tile} ({n_wide} children; "
          f"the card holds at most {most_blocks} such blocks at once, so later tiles start as "
          f"earlier ones finish and look back at them); max_abs_err={fused_totals['err']}; "
          f"registers by probs dtype {split_regs}", flush=True)
    if not (n_over > cap and wide_tiles > most_blocks):
        raise SystemExit("the fused cases did not overflow or had no more tiles than the card "
                         "holds blocks")
    del wide_syn, wide_args
    graph_same, graph_launches = _graph_replays(_split_and_compact, fullest)
    print(f"[kernel] split_and_compact captured in a CUDA graph on the steady-state shell with "
          f"the most live rows ({fullest_live} live), replayed 3 times with its outputs "
          f"overwritten before each: bitwise equal to the eager call={graph_same} (launches "
          f"counted at the capture: {graph_launches})", flush=True)
    if not (graph_same and graph_launches == 1):
        raise SystemExit("split_and_compact under CUDA-graph replay differs from the eager call")
    print(f"[kernel] compact_children: bitwise equal to its plain version on {2 * n_shells} "
          f"real shells and on {n_kids} valid children into {cap} slots (max_abs_err="
          f"{compact_totals['err']} over a, b, weights, flags and n_children)", flush=True)
    if n_kids <= cap:
        raise SystemExit("the overflowing compaction did not overflow")
    zero_counts()
    dens_k = sampler_mod.sample_density(tr.model, 1e-6, cap)
    dens_launches = _compact_children.launches
    sampler_mod._compact_children = _compact_children_ref
    dens_p = sampler_mod.sample_density(tr.model, 1e-6, cap)
    sampler_mod._compact_children = _compact_children
    dens_same = all(torch.equal(getattr(dens_k, f), getattr(dens_p, f))
                    for f in batch_fields)
    compact_totals["err"] = max([compact_totals["err"]] + [
        _max_diff(getattr(dens_k, f), getattr(dens_p, f)) for f in batch_fields])
    print(f"[density] sample_density(d_p=1e-6, capacity {cap}): n_unique="
          f"{int(dens_k.n_unique)} overflow={bool(dens_k.overflow)} mass="
          f"{float(dens_k.counts.sum()):.6f}; through compact_children ({dens_launches} "
          f"launches) and through its plain version: bitwise equal={dens_same}", flush=True)
    if not (dens_same and dens_launches == n_shells and int(dens_k.n_unique) > 0):
        raise SystemExit("sample_density through the kernel differs from the plain version")
    del shells, syn, over

    two_kernels = "multinomial4_split + compact_children"
    fast = ["rank_gather2", "rank_ratio_rowsum", "tab[idx]", "multinomial4_split",
            "compact_children", "split_and_compact", two_kernels]
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
    step_args = fullest
    split_args, compact_args = _split_of(step_args), _compaction_of(step_args)
    # what the wrapper's clear costs the card: torch's zero_ of as many bytes
    clear_name = "zero_ of split_and_compact's one allocation"
    clear_buf, _, clear_at, clear_words = _split_frontier(cap, dev)
    clear_buf = clear_buf.view(-1)[:3 * clear_buf.shape[1] + clear_at + clear_words]
    fast.append(clear_name)
    s_counts, s_probs, s_z, s_u, s_mask, s_valid = split_args
    free = multinomial4_split(s_counts, s_probs, s_z, s_u, None, s_valid)[0]
    p64 = s_probs.double()
    ps64 = torch.cumsum(p64, dim=-1)
    condp = torch.where(ps64 > 0, p64 / torch.clamp(ps64, min=1e-300), 0.0)
    n3 = torch.where(s_valid, s_counts, 0.0)
    binom_np = [(n3, condp[:, 3].contiguous()), (n3 - free[:, 3], condp[:, 2].contiguous()),
                (n3 - free[:, 3] - free[:, 2], condp[:, 1].contiguous())]
    flat_w, flat_valid = compact_args[2].reshape(-1), compact_args[3].reshape(-1)
    fns.update({
        "multinomial4_split": lambda: multinomial4_split(*split_args),
        "compact_children": lambda: _compact_children(*compact_args),
        "compact_children_ref": lambda: _compact_children_ref(*compact_args),
        "split_and_compact": lambda: _split_and_compact(*step_args),
        two_kernels: lambda: _compact_children(
            step_args[0], step_args[1], *multinomial4_split(*split_args), *step_args[8:10]),
        "masked_select(weights)": lambda: torch.masked_select(flat_w, flat_valid),
        clear_name: lambda: clear_buf.zero_(),
        "3 x torch.binomial": lambda: [torch.binomial(n, p) for n, p in binom_np],
    })
    before = _split_before(s_counts, s_probs, s_z, s_u, s_mask)
    want_split = multinomial4_split_ref(*split_args)[0]
    n_before = int((before != want_split).any(-1).sum())
    print(f"[shell] the steady-state shell with the most live rows: {fullest_live} live of "
          f"{cap}; the (U, 127) cumprod/cumsum split of before gives other counts than the "
          f"plain version on {n_before} rows (it forms the pmf ratio first)", flush=True)
    del before, want_split
    old_name = "two-channel rank_gather2"
    old_compact = "compact_children (earlier tree)"
    old_two = f"{two_kernels} (earlier tree)"
    old_fused = "split_and_compact (earlier tree)"
    old_mods, before_dir = {}, None
    if "--before" in argv:
        before_dir = os.path.abspath(argv[argv.index("--before") + 1])
        old_mods = _before_modules(before_dir)
        print(f"[before] built and bound from the earlier tree: {sorted(old_mods)}", flush=True)
    # 5b, continued: the decomposition of the split's time on the steady-state
    # shell with the most live rows (tools/split_timing.py: an empty launch of its
    # grid, every row dead, every live row Gaussian, the real shell, the synthetic
    # all-CDF split; split_and_compact on the real shell), this tree's kernels and,
    # with --before, DIR's in the same turns (first held bitwise against this
    # tree's); then the proof that the split's division by k is __fdiv_rn's
    trees = {"this tree": (multinomial4_split, _split_and_compact)}
    if "sampler" in old_mods:
        trees["earlier tree"] = (old_mods["multinomial"].multinomial4_split,
                                 old_mods["sampler"]._split_and_compact)
    decomp, decomp_tally = split_timing.decomposition(trees, step_args,
                                                      split_timing.synthetic_split(cap, dev), dev)
    for name, t in decomp_tally.items():
        print(f"[split] {name}: {t} (looks of the inverse CDF; warp_chain: the longest chain of "
              f"a warp of 32 rows)", flush=True)
    for name, (med, spread, held) in decomp.items():
        print(f"[split] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms", flush=True)
    proof = torch.zeros(4, dtype=torch.int64, device=dev)
    t1 = time.time()
    sampler_launch("split_division_mismatches", (proof,), dev)
    proof = proof.tolist()
    t_proof = time.time() - t1
    n_pairs = (1 << 32) * 128
    print(f"[split] the division by k of the inverse CDF (fast_div by Markstein's correction "
          f"from RN(1/k), else __fdiv_rn) against __fdiv_rn on every float x and every k = "
          f"1..128, {n_pairs} pairs of which {proof[1]} took fast_div: {proof[0]} differ "
          f"(first: {proof[2]:#x}); {t_proof:.2f} s", flush=True)
    if proof[0] != 0 or proof[1] < n_pairs // 2:
        raise SystemExit("the split's division by k differs from __fdiv_rn")
    if "sampler" in old_mods:
        compact_old = old_mods["sampler"]._compact_children
        same_old = all(torch.equal(g, w) for g, w in zip(compact_old(*compact_args),
                                                         _compact_children(*compact_args)))
        print(f"[kernel] {old_compact}: bitwise equal to this tree's={same_old}", flush=True)
        if not same_old:
            raise SystemExit(f"{old_compact} disagrees with this tree's compact_children")
        fns[old_compact] = lambda: compact_old(*compact_args)
        split_old = old_mods["multinomial"].multinomial4_split

        def two_old():
            return compact_old(step_args[0], step_args[1], *split_old(*split_args),
                               *step_args[8:10])

        same_old = all(torch.equal(g, w) for g, w in zip(two_old(),
                                                         _split_and_compact(*step_args)))
        print(f"[kernel] {old_two}: bitwise equal to this tree's split_and_compact={same_old}",
              flush=True)
        if not same_old:
            raise SystemExit(f"{old_two} disagrees with this tree's split_and_compact")
        fns[old_two] = two_old
        fast += [old_compact, old_two]
        # the earlier tree's fused shell step, with n_live where its signature has it
        fused_old = old_mods["sampler"]._split_and_compact
        old_args = step_args[:len(inspect.signature(fused_old).parameters)]
        same_old = all(torch.equal(g, w) for g, w in zip(fused_old(*old_args),
                                                         _split_and_compact(*step_args)))
        print(f"[kernel] {old_fused} ({len(old_args)} arguments): bitwise equal to this "
              f"tree's={same_old}", flush=True)
        if not same_old:
            raise SystemExit(f"{old_fused} disagrees with this tree's split_and_compact")
        fns[old_fused] = lambda: fused_old(*old_args)
        fast.append(old_fused)
    if "rank_gather2" in old_mods:
        old = old_mods["rank_gather2"]
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
    n_el, n_rows = idx.numel(), int(torch.unique(idx).numel())
    del got, want, e_got, e_want

    # 6. the main path: 5 training steps through the default dispatch
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    n_updates, t_fact, n_draws = _steps(tr, 5, "factored")
    fact_launches = factored_cells_accumulate.launches
    split_launches, compact_launches = multinomial4_split.launches, _compact_children.launches
    fused_launches = _split_and_compact.launches
    print(f"[path] default dispatch ({type(tr.dt.dense).__name__}): factored_cells_accumulate "
          f"launches in 5 steps: {fact_launches} (expected one per local_energy call, "
          f"{n_updates} vmc_update calls); rank_ratio_rowsum {rank_ratio_rowsum.launches}, "
          f"rank_gather2 {rank_gather2.launches}, dense_grid_accumulate "
          f"{dense_grid_accumulate.launches}; split_and_compact {fused_launches} ({n_shells} "
          f"shells x {n_draws} sample() calls), the standalone multinomial4_split "
          f"{split_launches} and compact_children {compact_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if (fact_launches != n_updates or n_updates < 5 or rank_ratio_rowsum.launches
            or rank_gather2.launches or dense_grid_accumulate.launches
            or xl_grid_accumulate.launches or any(w.launches for w in row_wrappers)):
        raise SystemExit("the main path did not run factored_cells_accumulate once per "
                         "E_loc call, or ran another engine's kernel")
    if not (fused_launches == n_shells * n_draws and n_draws >= 5
            and split_launches == compact_launches == 0):
        raise SystemExit("the main path did not run split_and_compact once per shell, or ran "
                         "the standalone sampler kernels")

    # 7. the earlier main path: the same trainer on the rank engine, with its
    # dense A: one rank_local_energy launch per E_loc call (the parent ran
    # rank_ratio_rowsum per chunk of 512)
    per_call = -(-tr.capacity // chunk)
    tr.dt = dt_rank
    zero_counts()
    n_updates, t_rank, n_draws = _steps(tr, 2, "rank")
    rank_a_counts = {w.__name__: w.launches for w in wrappers}
    want_rank_a = dict({w.__name__: 0 for w in wrappers}, rank_local_energy=n_updates,
                       _split_and_compact=n_shells * n_draws)
    ratio_launches = rank_a_counts["rank_ratio_rowsum"]
    print(f"[path] rank engine (dense=None, its dense A kept): launches in 2 steps "
          f"{rank_a_counts} ({n_updates} vmc_update calls: one rank_local_energy launch a "
          f"local_energy call, where the chunk loop ran {per_call} rank_ratio_rowsum launches; "
          f"{n_draws} sample() calls of {n_shells} shells)", flush=True)
    if rank_a_counts != want_rank_a or n_updates < 2:
        raise SystemExit(f"the rank path did not run one rank_local_energy launch per E_loc "
                         f"call and split_and_compact once per shell, or ran other kernels: "
                         f"{rank_a_counts} against {want_rank_a}")

    # 7b. the sort engine with its dense A at the paper's width: the same trainer
    # with no RankSpec and no grid program, as a space over 32 qubits (or a rank
    # cap set below the sector) gives it; one sorted_local_energy launch per E_loc
    # call, then one step under torch.profiler for its device time
    dt_sort = dataclasses.replace(dt, rank_spec=None, dense=None)
    if dt_sort.a_mat is None:
        raise SystemExit("H2O 6-31G's DeviceTerms must carry a dense A")
    tr.dt = dt_sort
    zero_counts()
    n_updates_s, t_sort, n_draws_s = _steps(tr, SORT_A_STEPS, "sort, dense A")
    sort_a_counts = {w.__name__: w.launches for w in wrappers}
    want_sort_a = dict({w.__name__: 0 for w in wrappers}, sorted_local_energy=n_updates_s,
                       _split_and_compact=n_shells * n_draws_s)
    print(f"[path] sort engine with the dense A (rank_spec=None, dense=None): launches in "
          f"{SORT_A_STEPS} steps {sort_a_counts} ({n_updates_s} vmc_update calls, "
          f"{n_draws_s} sample() calls of {n_shells} shells)", flush=True)
    if sort_a_counts != want_sort_a or n_updates_s < SORT_A_STEPS:
        raise SystemExit(f"the sort engine with a dense A did not run one sorted_local_energy "
                         f"launch per E_loc call and split_and_compact once per shell, or ran "
                         f"other kernels: {sort_a_counts} against {want_sort_a}")
    sort_a_wall, sort_a_device = _profiled_step(tr)
    print(f"[path] sort engine with the dense A, one more step under torch.profiler: "
          f"{sort_a_wall:.3f} s of wall time (the profiler's own cost included), "
          f"{sort_a_device:.2f} ms of device time; unprofiled steps "
          f"{', '.join(f'{t:.3f}' for t in t_sort)} s", flush=True)
    tr.dt = dt
    print(f"[path] step time, same trainer, same call: factored steps 2-5 "
          f"{min(t_fact[1:]):.3f}-{max(t_fact[1:]):.3f} s, rank steps 6-7 "
          f"{min(t_rank):.3f}-{max(t_rank):.3f} s, sort steps with the dense A "
          f"{min(t_sort):.3f}-{max(t_sort):.3f} s", flush=True)

    # 8. quadratic_energy on the rank engine with its dense A: one
    # rank_quadratic_energy launch, against the chunk loop of before composed
    # through the plain gather (rank_gather2_ref, P @ A, the eager epilogue)
    batch = tr._sample()
    with torch.no_grad():
        la, ph = log_psi(tr.model, batch.states)
    zero_counts()
    q_k = float(le.quadratic_energy(dt, batch.states, la, ph, batch.n_unique))
    quad_a_counts = {w.__name__: w.launches for w in wrappers}
    gather_launches = quad_a_counts["rank_gather2"]
    nu = int(batch.n_unique)
    live_h = torch.arange(batch.states.shape[0], device=dev) < batch.n_unique
    la_qh = torch.where(live_h, la - la[:nu].max(), QUAD_MISS).float().contiguous()
    ph_qh = ph.float().contiguous()
    nv_h = le._count(batch.n_unique, dev)
    table_qh = build_value_table(spec, batch.states, la_qh, ph_qh, batch.n_unique,
                                 miss_log_amp=QUAD_MISS)
    q_p = float(_quad_loop(le, dt, lambda sc, lv: rank_gather2_ref(spec, sc, xy, table_qh),
                           lambda sc, *_: _dense_h(dt, sc), batch.states, la_qh, ph_qh, nv_h,
                           chunk))
    q_rel = abs(q_k - q_p) / abs(q_p)
    want_quad_a = dict({w.__name__: 0 for w in wrappers}, rank_quadratic_energy=1)
    print(f"[quad] quadratic_energy (rank engine, dense A) {q_k:.10f} vs the chunk loop of "
          f"before through rank_gather2_ref ({per_call} chunks of the plain gather + P @ A + "
          f"epilogue) {q_p:.10f}: rel {q_rel:.2e} (tol {QUAD_RTOL}); launches {quad_a_counts}",
          flush=True)
    if not (q_rel <= QUAD_RTOL and quad_a_counts == want_quad_a and math.isfinite(q_k)):
        raise SystemExit(f"quadratic_energy on the rank engine with a dense A disagrees with "
                         f"the chunk loop of before, or did not run one rank_quadratic_energy "
                         f"launch and nothing else: {quad_a_counts}")

    # 9. local_energy: rank kernel vs its plain version, grid engine vs rank
    # engine, both vs the host oracle
    e_k = _engines_agree("H2O 6-31G", le, dt, terms, batch, la, ph)
    le.rank_local_energy = rank_local_energy_ref
    e_p = le.local_energy(dt_rank, batch.states, la, ph, batch.n_unique)
    le.rank_local_energy = rank_local_energy
    table2 = build_value_table(spec, batch.states, la, ph, batch.n_unique)
    tol = rank_local_energy_tolerance(spec, table2, batch.states, la.float(), xy, dt.xy_ptr,
                                      dt.term_yz, dt.yz_unique, dt.term_coeff, dt.diag_coeff,
                                      chunk_rows=chunk)[:nu]
    d_re, d_im = ((a[:nu] - b[:nu]).abs() for a, b in zip(e_k, e_p))
    eq = bool((d_re <= tol).all() and (d_im <= tol).all())
    print(f"[eloc] rank kernel (rank_local_energy) vs plain on {nu} rows: within the per-row "
          f"tolerance (rank_local_energy_tolerance)={eq}, max_abs_diff re "
          f"{float(d_re.max()):.3e} im {float(d_im.max()):.3e} Ha", flush=True)
    if not eq:
        raise SystemExit("local_energy through the kernel differs from the plain version")
    del table2

    # 10. the dense engine on N2 STO-3G
    t1 = time.time()
    mol2 = nt.load_molecule("N2_STO-3G_gen")
    hil2 = nt.Hilbert.for_molecule(mol2)
    terms2 = nt.compile_pauli_terms(mol2.qubit_hamiltonian, mol2.n_qubits)
    cfg2 = nt.NAQSConfig(n_qubits=mol2.n_qubits, sectors=hil2.sectors,
                         amp_hidden=(64,), phase_hidden=(128, 128))
    tc2 = nt.TrainConfig(n_samples=1e5, n_unq_samples_min=1000, n_unq_samples_max=8192, seed=0)
    tr2 = nt.VMCTrainer(cfg2, terms2, hil2, tc2, device=dev)
    dn = tr2.dt.dense
    if type(dn).__name__ != "DenseTerms":
        raise SystemExit(f"N2 STO-3G must carry DenseTerms, got {type(dn).__name__}")
    d_bytes, d_ops, d_pairs, d_h = _grid_work(dn)
    print(f"[setup] N2 STO-3G: {mol2.n_qubits} qubits, |basis|={hil2.size}, "
          f"K={len(terms2.coeff)} Kxy={len(terms2.xy_unique)} (pad {dn.row_map.shape[0]}), "
          f"DenseTerms Sa={dn.sa} Sb={dn.sb} Ka={dn.r1_idx.shape[0]}, h_dense "
          f"{dn.h_dense.numel() * 4 / 2**20:.1f} MiB, {d_pairs} valid (mask, cell) pairs; "
          f"{time.time() - t1:.1f}s", flush=True)
    zero_counts()
    n_updates, t_dense, n_draws = _steps(tr2, 3, "dense")
    dense_launches = dense_grid_accumulate.launches
    print(f"[path] N2 default dispatch (DenseTerms): dense_grid_accumulate launches in 3 "
          f"steps: {dense_launches} ({n_updates} vmc_update calls); others "
          f"{[w.launches for w in wrappers[:3]]}; split_and_compact "
          f"{_split_and_compact.launches} ({cfg2.n_shells} shells x {n_draws} sample() calls), "
          f"multinomial4_split {multinomial4_split.launches}, compact_children "
          f"{_compact_children.launches}", flush=True)
    if (dense_launches != n_updates or n_updates < 3 or any(w.launches for w in wrappers[:3])
            or xl_grid_accumulate.launches or any(w.launches for w in row_wrappers)):
        raise SystemExit("N2 did not run dense_grid_accumulate once per E_loc call")
    if not (_split_and_compact.launches == cfg2.n_shells * n_draws
            and multinomial4_split.launches == _compact_children.launches == 0):
        raise SystemExit("N2 did not run split_and_compact once per shell, or ran the "
                         "standalone sampler kernels")
    batch2 = tr2._sample()
    with torch.no_grad():
        la2, ph2 = log_psi(tr2.model, batch2.states)
    grid2, _, _ = value_grid(tr2.dt.rank_spec, batch2.states, la2, ph2, batch2.n_unique,
                             dn.sa, dn.sb)
    dense_err = _check_grid_kernel("dense_grid_accumulate", dense_grid_accumulate,
                                   dense_grid_accumulate_ref, dn, grid2)
    _engines_agree("N2 STO-3G", le, tr2.dt, terms2, batch2, la2, ph2)

    old_dense = "dense_grid_accumulate (earlier tree)"
    old_fle = "factored_local_energy (H2O 6-31G, earlier tree)"
    fns["dense_grid_accumulate"] = lambda: dense_grid_accumulate(dn, grid2)
    grid_old, fact_old, old_fact = old_mods.get("grid"), None, None
    if grid_old is not None:
        l_rows, l_ra, l_rb = _live_cells(g_idx, g_n, fn.sa, fn.sb)
        f_new = factored_cells_accumulate(fn, grid, g_idx, g_n)
        if hasattr(grid_old, "factored_grid_accumulate"):
            # the earlier tree's whole-grid numerator, read at the live rows'
            # cells, against this tree's rows (another order of summation)
            old_fact = "factored_grid_accumulate (earlier tree)"
            fact_old = lambda: grid_old.factored_grid_accumulate(fn, grid)   # noqa: E731
            f_diff = (fact_old()[l_rb, l_ra] - f_new[l_rows]).abs()
            f_ok = bool((f_diff <= grid_tolerance(fn, grid, g_idx, g_n)[l_rows]).all())
            how = f"read at the {l_rows.numel()} live cells, within grid_tolerance"
        elif hasattr(grid_old, "factored_cells_accumulate"):
            # the earlier tree's cells kernel on the same rows: bitwise where
            # the source is this tree's, else within grid_tolerance
            old_fact = "factored_cells_accumulate (earlier tree)"
            fact_old = lambda: grid_old.factored_cells_accumulate(  # noqa: E731
                fn, grid, g_idx, g_n)
            f_old = fact_old()
            src = os.path.join("naqs_tpu_torch", "csrc", "grid_engine.cu")
            with open(os.path.join(before_dir, src), "rb") as f_a, \
                    open(os.path.join(REPO, src), "rb") as f_b:
                same_src = f_a.read() == f_b.read()
            f_diff = (f_old - f_new).abs()
            f_ok = (torch.equal(f_old, f_new) if same_src else
                    bool((f_diff <= grid_tolerance(fn, grid, g_idx, g_n)).all()))
            how = (f"on the same {l_rows.numel()} live rows (same source={same_src}, bitwise "
                   f"equal={torch.equal(f_old, f_new)}), "
                   f"{'bitwise' if same_src else 'within grid_tolerance'}")
            del f_old
        else:
            raise SystemExit("the earlier tree has csrc/grid_engine.cu but no factored "
                             "kernel this script can compare")
        print(f"[kernel] {old_fact} on H2O 6-31G's sampled grid, {how} of this tree's "
              f"factored_cells_accumulate={f_ok} (max_abs_err={float(f_diff.max()):.3e})",
              flush=True)
        if not f_ok:
            raise SystemExit(f"{old_fact} and this tree's factored_cells_accumulate differ")
        del f_new, f_diff
        if hasattr(grid_old, "dense_grid_accumulate"):
            dense_old = grid_old.dense_grid_accumulate
            d_diff = (dense_old(dn, grid2) - dense_grid_accumulate_ref(dn, grid2)).abs()
            d_ok = bool((d_diff <= grid_tolerance(dn, grid2)).all())
            print(f"[kernel] {old_dense}: within its tolerance of the plain version={d_ok} "
                  f"(max_abs_err={float(d_diff.max()):.3e})", flush=True)
            if not d_ok:
                raise SystemExit(f"{old_dense} disagrees with its plain version")
            fns[old_dense] = lambda: dense_old(dn, grid2)

    # 10b. the staircase engine: Li2O STO-3G CISDTQ, the paper-scale model
    t1 = time.time()
    mol3 = nt.load_molecule("Li2O_STO-3G_gen")
    hil3 = nt.Hilbert.for_molecule(mol3)
    hil3 = nt.Hilbert(n_qubits=hil3.n_qubits, sectors=hil3.sectors, n_exc_max=XL_EXC)
    terms3 = nt.compile_pauli_terms(mol3.qubit_hamiltonian, mol3.n_qubits,
                                    n_excitations_max=XL_EXC)
    cfg3 = nt.NAQSConfig(n_qubits=mol3.n_qubits, sectors=hil3.sectors,
                         amp_hidden=(64,), phase_hidden=(512, 512))
    t2 = time.time()
    tr3 = nt.VMCTrainer(cfg3, terms3, hil3, tc, device=dev)
    xl = tr3.dt.dense
    if type(xl).__name__ != "FactorTermsXL" or xl.n_cells != LI2O_CELLS:
        raise SystemExit(f"Li2O CISDTQ must carry FactorTermsXL with {LI2O_CELLS} cells, got "
                         f"{type(xl).__name__} {getattr(xl, 'n_cells', None)}")
    dt3_rank = dataclasses.replace(tr3.dt, dense=None)
    spec3 = tr3.dt.rank_spec
    x_bytes, x_ops, x_pairs, x_macs, x_touched = _xl_work(xl)
    tiles = xl.tiles[:, 0]
    print(f"[setup] Li2O STO-3G CISDTQ: {mol3.n_qubits} qubits, sector {hil3.sectors[0]}, "
          f"HF {mol3.hf_energy:.4f} Ha, n_exc_max={XL_EXC}; K={len(terms3.coeff)} "
          f"Kxy={len(terms3.xy_unique)} Kyz={len(terms3.yz_unique)} Kd={len(terms3.diag_yz)}; "
          f"FactorTermsXL Sa*={xl.sa} Sb*={xl.sb} Ka={xl.pa_idx.shape[0]} "
          f"Kb={xl.pb_idx.shape[0]} Kya={xl.par_a.shape[0]} Kyb={xl.par_b.shape[0]}, blocks "
          f"(offset, rows, beta prefix) {xl.blocks}, {xl.n_cells} staircase cells of "
          f"{xl.sa * xl.sb} in the rectangle and {hil3.sector_size} in the sector; "
          f"{int((tiles == 0).sum())} column and {int((tiles == 1).sum())} row blocks; factors "
          f"per mask max {int(xl.n_fact.max())} mean {float(xl.n_fact.float().mean()):.2f}; "
          f"{x_pairs} valid (mask, cell) pairs, {x_macs} multiply-adds for H, {x_touched} grid "
          f"cells read; {sum(p.numel() for p in tr3.model.parameters())} params; "
          f"{time.time() - t1:.1f}s, of which the trainer with its DeviceTerms "
          f"{time.time() - t2:.1f}s", flush=True)
    zero_counts()
    n_updates, t_xl, n_draws = _steps(tr3, 3, "staircase")
    xl_launches = xl_grid_accumulate.launches
    others = {w.__name__: w.launches for w in wrappers
              if w not in (xl_grid_accumulate, _split_and_compact)}
    print(f"[path] Li2O default dispatch (FactorTermsXL): xl_grid_accumulate launches in 3 "
          f"steps: {xl_launches} ({n_updates} vmc_update calls); split_and_compact "
          f"{_split_and_compact.launches} ({cfg3.n_shells} shells x {n_draws} sample() calls); "
          f"the other kernels {others}; steps 2-3 {min(t_xl[1:]):.3f}-{max(t_xl[1:]):.3f} s",
          flush=True)
    if xl_launches != n_updates or n_updates < 3 or any(others.values()):
        raise SystemExit("Li2O did not run xl_grid_accumulate once per E_loc call, or ran "
                         "another engine's or the standalone sampler kernels")
    if _split_and_compact.launches != cfg3.n_shells * n_draws:
        raise SystemExit("Li2O did not run split_and_compact once per shell")
    batch3 = tr3._sample()
    with torch.no_grad():
        la3, ph3 = log_psi(tr3.model, batch3.states)
    nu3 = int(batch3.n_unique)
    st3 = batch3.states[:nu3].cpu().numpy()
    stair = hil3.contains(st3)
    ah3, bh3 = _xl_blocked_idx(xl, spec3, batch3.states[:nu3])
    rect = ((ah3 < xl.sa) & (bh3 < xl.sb)).cpu().numpy()
    w3 = batch3.counts[:nu3].cpu().numpy()
    print(f"[xl] a sampled batch at n_samples={tr3.n_samples:.0e}: {nu3} unique states, "
          f"{int((~stair).sum())} outside the staircase ({int((rect & ~stair).sum())} of them "
          f"inside the rectangle); share of the sampled weight outside the staircase "
          f"{float(w3[~stair].sum() / w3.sum()):.6f}, outside the rectangle "
          f"{float(w3[~rect].sum() / w3.sum()):.6f}", flush=True)
    grid3, _ = xl_value_grid(xl, spec3, batch3.states, la3, ph3, batch3.n_unique)
    if bool(grid3[xl.sa].any()) or bool(grid3[:, xl.sb].any()):
        raise SystemExit("the staircase value grid's pad row or column is not zero")
    xl_err = _check_grid_kernel("xl_grid_accumulate", xl_grid_accumulate,
                                xl_grid_accumulate_ref, xl, grid3)
    # every staircase cell set, as the batch of the whole filtered basis sets it
    gen3 = torch.Generator(device="cpu").manual_seed(3)
    stair3 = torch.zeros((xl.sa + 1, xl.sb + 1, 2))
    in_stair = torch.arange(xl.sb)[None, :] < xl.width[:-1].cpu()[:, None]
    stair3[:-1, :-1][in_stair] = torch.rand((xl.n_cells, 2), generator=gen3) - 0.5
    stair3 = stair3.to(dev)
    x_work = _xl_sampled_work(xl, grid3, x_touched)
    for what, g3, w3 in (("sampled", grid3, x_work),
                         ("staircase", stair3, _xl_sampled_work(xl, stair3, x_touched))):
        print(f"[xl] the {what} grid: {w3['set_cells']} set cells of {g3.numel() // 2}; "
              f"{w3['set_pairs']} set (mask, cell) pairs of the {x_pairs} valid ones (share "
              f"{w3['set_pairs'] / x_pairs:.6f}), {w3['factors']} factors on them; the "
              f"kernel stages {w3['staged_chunks']} chunks ({w3['staged_bytes']} B of "
              f"bitmap rows and program), lists {w3['listed']} (mask, set cell) entries and "
              f"probes {w3['probed']} (mask, cell) pairs", flush=True)
    _check_grid_kernel("xl_grid_accumulate (staircase grid)", xl_grid_accumulate,
                       xl_grid_accumulate_ref, xl, stair3)
    old_xl = "xl_grid_accumulate (earlier tree)"
    if "grid" in old_mods and hasattr(old_mods["grid"], "xl_grid_accumulate"):
        xl_old = old_mods["grid"].xl_grid_accumulate
        x_diff = (xl_old(xl, grid3) - xl_grid_accumulate(xl, grid3)).abs()
        x_ok = bool((x_diff <= grid_tolerance(xl, grid3)).all())
        print(f"[kernel] {old_xl} on Li2O's sampled grid: within grid_tolerance of this "
              f"tree's={x_ok} (max_abs_diff={float(x_diff.max()):.3e})", flush=True)
        if not x_ok:
            raise SystemExit(f"{old_xl} and this tree's xl_grid_accumulate differ")
    # every cell of the rectangle set: every bitmap row too full to list
    full3 = torch.zeros((xl.sa + 1, xl.sb + 1, 2))
    full3[:-1, :-1] = torch.rand((xl.sa, xl.sb, 2), generator=gen3) - 0.5
    full3 = full3.to(dev)
    # the staircase engine against the rank engine on a buffer of staircase
    # states (both read the same psi there), XL_QUERIES rows as queries=
    keep = torch.as_tensor(stair, device=dev)
    n_st = int(keep.sum())
    pad = lambda t, fill: torch.cat([t, t.new_full((64,), fill)])
    buf = (pad(batch3.states[:nu3][keep], SENTINEL), pad(la3[:nu3][keep], 0.0),
           pad(ph3[:nu3][keep], 0.0))
    rows = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
        n_st, size=min(XL_QUERIES, n_st), replace=False)), device=dev)
    q = tuple(t[rows] for t in buf)
    e_x = le.local_energy(tr3.dt, *buf, n_st, queries=q)
    e_r = le.local_energy(dt3_rank, *buf, n_st, queries=q)
    d_xr = max(float((a - b).abs().max()) for a, b in zip(e_x, e_r))
    # 8 staircase rows of the real sampled buffer against the float64 oracle,
    # psi zeroed outside the rectangle (the staircase engine reads psi there)
    e_full = le.local_energy(tr3.dt, batch3.states, la3, ph3, batch3.n_unique)
    rows8 = np.sort(np.random.default_rng(2).choice(np.flatnonzero(stair), 8, replace=False))
    in_rect = np.flatnonzero(rect)
    ref8 = _oracle_rows(terms3, st3[in_rect], la3[:nu3].double().cpu().numpy()[in_rect],
                        ph3[:nu3].double().cpu().numpy()[in_rect],
                        np.searchsorted(in_rect, rows8))
    err8 = float(np.abs(e_full[0][:nu3].cpu().numpy()[rows8] - ref8).max())
    finite = bool(torch.isfinite(e_full[0][:nu3]).all())
    print(f"[eloc] Li2O CISDTQ: FactorTermsXL vs rank engine on {len(rows)} staircase queries "
          f"over {n_st} staircase states: max_abs_diff {d_xr:.3e} Ha (tol {ENGINE_TOL}); 8 "
          f"staircase rows of the sampled buffer vs float64 local_energy_np (psi zeroed outside "
          f"the rectangle): {err8:.2e} (tol {ELOC_TOL})", flush=True)
    if not (d_xr <= ENGINE_TOL and err8 < ELOC_TOL and finite):
        raise SystemExit("Li2O: the staircase engine disagrees with the rank engine or the "
                         "oracle")

    # 10c. the sort engine (no RankSpec): on H2O 6-31G's batch of phases 8-9
    # against the rank engine, then N2 6-31G (36 qubits) at the paper's widths
    dt_seg = dataclasses.replace(dt_sort, a_mat=None)
    zero_counts()
    e_g = le.local_energy(dt_seg, batch.states, la, ph, batch.n_unique)
    seg_counts = {w.__name__: w.launches for w in wrappers}
    zero_counts()
    e_s = le.local_energy(dt_sort, batch.states, la, ph, batch.n_unique)
    q_s = float(le.quadratic_energy(dt_sort, batch.states, la, ph, batch.n_unique))
    h2o_counts = {w.__name__: w.launches for w in wrappers}
    d_sr = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_s, e_k))
    sr_same = all(torch.equal(a, b) for a, b in zip(e_s, e_g))
    d_seg = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_g, e_k))
    q_rel_s = abs(q_s - q_k) / abs(q_k)
    # the chunk loops the engines ran with a dense A before the one launch, this
    # tree's kernels composed as they ran them: per chunk of 512 rows P @ A and
    # the ratio kernel (sorted_ratio_rowsum over the sorted buffer,
    # rank_ratio_rowsum over the rank table), or the gather kernel, P @ A and the
    # eager epilogue (on phase 8's log-amps, shifted to a live maximum of 0)
    sort_table = pack_table(batch.states, la, ph)
    rank_table = build_value_table(spec, batch.states, la, ph, batch.n_unique)

    def sort_dense_loop():
        return _dense_chunk_loop(le, dt_sort, batch.states, la, ph, chunk,
                                 lambda sc, m_la, m_ph, h_c: sorted_ratio_rowsum(
                                     *sort_table, nv_h, sc, xy, m_la, m_ph, h_c))

    def rank_dense_loop():
        return _dense_chunk_loop(le, dt, batch.states, la, ph, chunk,
                                 lambda sc, m_la, m_ph, h_c: rank_ratio_rowsum(
                                     spec, sc, xy, rank_table, m_la, m_ph, h_c))

    def sort_dense_quad_loop():
        return _quad_loop(
            le, dt_sort, lambda sc, lv: sorted_gather2(batch.states, la_qh, ph_qh, nv_h, sc,
                                                       xy, lv),
            lambda sc, *_: _dense_h(dt_sort, sc), batch.states, la_qh, ph_qh, nv_h, chunk)

    def rank_dense_quad_loop():
        return _quad_loop(le, dt, lambda sc, lv: rank_gather2(spec, sc, xy, table_qh),
                          lambda sc, *_: _dense_h(dt, sc), batch.states, la_qh, ph_qh, nv_h,
                          chunk)

    zero_counts()
    e_loop = sort_dense_loop()
    q_loop = float(sort_dense_quad_loop())
    e_rloop = rank_dense_loop()
    q_rloop = float(rank_dense_quad_loop())
    loop_counts = {w.__name__: w.launches for w in wrappers}
    d_loop_k = [(a[:nu] - b[:nu]).abs() for a, b in zip(e_loop, e_k)]
    loop_ok = all(bool((d <= tol).all()) for d in d_loop_k)
    d_loop = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_s, e_loop))
    q_rel_loop = abs(q_s - q_loop) / abs(q_loop)
    d_rloop_k = [(a[:nu] - b[:nu]).abs() for a, b in zip(e_rloop, e_k)]
    rloop_ok = all(bool((d <= tol).all()) for d in d_rloop_k)
    d_rloop = max(float(d.max()) for d in d_rloop_k)
    q_rel_rloop = abs(q_k - q_rloop) / abs(q_rloop)
    want_loops = dict({w.__name__: 0 for w in wrappers}, sorted_ratio_rowsum=per_call,
                      sorted_gather2=per_call, rank_ratio_rowsum=per_call,
                      rank_gather2=per_call)
    print(f"[eloc] H2O 6-31G, sort engine with the dense A (rank_spec=None, dense=None): one "
          f"launch, launches {h2o_counts} (with quadratic_energy); vs the rank engine on {nu} "
          f"rows {d_sr:.3e} Ha (tol {ENGINE_TOL}); bitwise equal to the same call with no dense "
          f"A (a_mat=None, launches {seg_counts})={sr_same}, which is {d_seg:.3e} Ha from the "
          f"rank engine; vs the chunk loop of before ({per_call} chunks of P @ A + "
          f"sorted_ratio_rowsum) {d_loop:.3e} Ha, the loop within phase 9's per-row tolerance "
          f"of the rank engine={loop_ok}; quadratic_energy {q_s:.10f} vs phase 8's {q_k:.10f}: "
          f"rel {q_rel_s:.2e} (tol {QUAD_RTOL}), vs the chunk loop of before ({per_call} chunks "
          f"of sorted_gather2 + P @ A + epilogue) {q_loop:.10f}: rel {q_rel_loop:.2e}",
          flush=True)
    print(f"[eloc] H2O 6-31G, rank engine with the dense A: the chunk loop it ran before "
          f"({per_call} chunks of P @ A + rank_ratio_rowsum) vs its one rank_local_energy "
          f"launch (phase 9) {d_rloop:.3e} Ha, within phase 9's per-row tolerance={rloop_ok}; "
          f"its quadratic_energy loop ({per_call} chunks of rank_gather2 + P @ A + epilogue) "
          f"{q_rloop:.10f} vs phase 8's one launch: rel {q_rel_rloop:.2e} (tol {QUAD_RTOL}); "
          f"the four loops' launches {loop_counts}", flush=True)
    if not (rloop_ok and d_rloop <= ENGINE_TOL and q_rel_rloop <= QUAD_RTOL
            and loop_counts == want_loops):
        raise SystemExit("H2O 6-31G: the rank engine's dense-A chunk loop of before disagrees "
                         "with its one launch, or the loops ran other kernels")
    want_counts = {w.__name__: 0 for w in wrappers}
    want_seg = dict(want_counts, sorted_local_energy=1)
    want_counts.update(sorted_local_energy=1, sorted_quadratic_energy=1)
    if not (d_sr <= ENGINE_TOL and d_seg <= ENGINE_TOL and sr_same and q_rel_s <= QUAD_RTOL
            and h2o_counts == want_counts and seg_counts == want_seg and math.isfinite(q_s)
            and loop_ok and d_loop <= ENGINE_TOL and q_rel_loop <= QUAD_RTOL):
        raise SystemExit("H2O 6-31G: the sort engine disagrees with the rank engine or with its "
                         "chunk loop of before, or ran other kernels than its one launch")
    # the two designs of the dense-A calls of both engines in turns, held and
    # unheld: the chunk loops of before against the one launch; with --before DIR,
    # DIR's own calls in the same turns. Beside them the rank engine's calls with
    # a_mat=None (the same one launch)
    dt_rank_noa = dataclasses.replace(dt, dense=None, a_mat=None)
    le_ra, le_rn = ("local_energy (rank engine, dense A, H2O 6-31G)",
                    "local_energy (rank engine, no A, H2O 6-31G)")
    quad_ra, quad_rn = ("quadratic_energy (rank engine, dense A, H2O 6-31G)",
                        "quadratic_energy (rank engine, no A, H2O 6-31G)")
    le_sa = "local_energy (sort engine, dense A, H2O 6-31G)"
    loop_sa = f"P @ A + sorted_ratio_rowsum ({per_call} chunks)"
    quad_sa = "quadratic_energy (sort engine, dense A, H2O 6-31G)"
    qloop_sa = f"sorted_gather2 + P @ A + epilogue ({per_call} chunks)"
    loop_ra = f"P @ A + rank_ratio_rowsum ({per_call} chunks)"
    qloop_ra = f"rank_gather2 + P @ A + epilogue ({per_call} chunks)"
    dense_fns = {
        le_sa: lambda: le.local_energy(dt_sort, batch.states, la, ph, batch.n_unique),
        loop_sa: sort_dense_loop,
        quad_sa: lambda: le.quadratic_energy(dt_sort, batch.states, la, ph, batch.n_unique),
        qloop_sa: sort_dense_quad_loop,
        le_ra: lambda: le.local_energy(dt_rank, batch.states, la, ph, batch.n_unique),
        loop_ra: rank_dense_loop,
        qloop_ra: rank_dense_quad_loop,
        le_rn: lambda: le.local_energy(dt_rank_noa, batch.states, la, ph, batch.n_unique),
        quad_ra: lambda: le.quadratic_energy(dt_rank, batch.states, la, ph, batch.n_unique),
        quad_rn: lambda: le.quadratic_energy(dt_rank_noa, batch.states, la, ph,
                                             batch.n_unique),
    }
    if "local_energy" in old_mods:
        old_le_mod = old_mods["local_energy"]
        e_old = old_le_mod.local_energy(dt_sort, batch.states, la, ph, batch.n_unique)
        q_old_sa = float(old_le_mod.quadratic_energy(dt_sort, batch.states, la, ph,
                                                     batch.n_unique))
        d_old = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_old, e_s))
        print(f"[before] the earlier tree's sort engine with the dense A on the same batch: "
              f"local_energy {d_old:.3e} Ha from this tree's one launch, quadratic_energy "
              f"{q_old_sa:.10f}", flush=True)
        if d_old > ENGINE_TOL or abs(q_old_sa - q_s) > QUAD_RTOL * abs(q_s):
            raise SystemExit("the earlier tree's sort engine with a dense A disagrees")
        dense_fns[le_sa + ", earlier tree"] = lambda: old_le_mod.local_energy(
            dt_sort, batch.states, la, ph, batch.n_unique)
        dense_fns[quad_sa + ", earlier tree"] = lambda: old_le_mod.quadratic_energy(
            dt_sort, batch.states, la, ph, batch.n_unique)
        # the earlier tree's rank engine with the dense A (chunk loops, in a tree
        # before the one launch took its dense-A calls)
        e_old = old_le_mod.local_energy(dt_rank, batch.states, la, ph, batch.n_unique)
        q_old_ra = float(old_le_mod.quadratic_energy(dt_rank, batch.states, la, ph,
                                                     batch.n_unique))
        d_old = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_old, e_k))
        print(f"[before] the earlier tree's rank engine with the dense A on the same batch: "
              f"local_energy {d_old:.3e} Ha from this tree's one launch, quadratic_energy "
              f"{q_old_ra:.10f} against {q_k:.10f}", flush=True)
        if d_old > ENGINE_TOL or abs(q_old_ra - q_k) > QUAD_RTOL * abs(q_k):
            raise SystemExit("the earlier tree's rank engine with a dense A disagrees")
        dense_fns[le_ra + ", earlier tree"] = lambda: old_le_mod.local_energy(
            dt_rank, batch.states, la, ph, batch.n_unique)
        dense_fns[quad_ra + ", earlier tree"] = lambda: old_le_mod.quadratic_energy(
            dt_rank, batch.states, la, ph, batch.n_unique)
        del e_old
    dense_times = time_in_turns(dense_fns, SLOW_REPEATS, 1)
    dense_calls = time_in_turns(dense_fns, SLOW_REPEATS, 1, hold=False)
    for name, (med, spread, held) in dense_times.items():
        print(f"[time] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms; unheld median {dense_calls[name][0]:.4f} "
              f"ms, spread {dense_calls[name][1][0]:.4f}-{dense_calls[name][1][1]:.4f} ms",
              flush=True)
        if dense_calls[name][1][1] >= held:
            raise SystemExit(f"the hold did not cover the enqueue of {name}: held times invalid")
    if not (dense_times[le_sa][0] < dense_times[loop_sa][0]
            and dense_times[quad_sa][0] < dense_times[qloop_sa][0]
            and dense_times[le_ra][0] < dense_times[loop_ra][0]
            and dense_times[quad_ra][0] < dense_times[qloop_ra][0]):
        raise SystemExit("the one launch is not faster than the chunk loop it replaced")
    del e_s, e_g, e_loop, d_loop_k, e_rloop, d_rloop_k
    # the rank engine with no dense A on the same batch: local_energy one
    # rank_local_energy launch, bitwise the rank engine's with its dense A (the
    # kernel does not read A), and quadratic_energy one rank_quadratic_energy
    # launch, bitwise phase 8's
    zero_counts()
    e_rn = le.local_energy(dt_rank_noa, batch.states, la, ph, batch.n_unique)
    rn_counts = {w.__name__: w.launches for w in wrappers}
    zero_counts()
    q_rn = float(le.quadratic_energy(dt_rank_noa, batch.states, la, ph, batch.n_unique))
    qrn_counts = {w.__name__: w.launches for w in wrappers}
    d_rn = max(float((a[:nu] - b[:nu]).abs().max()) for a, b in zip(e_rn, e_k))
    rn_same = all(torch.equal(a, b) for a, b in zip(e_rn, e_k)) and q_rn == q_k
    q_rel_rn = abs(q_rn - q_k) / abs(q_k)
    # rank_quadratic_energy against its plain version per row, as quadratic_energy
    # calls it: the log-amps shifted so that the live maximum is 0 (phase 8's table)
    terms_h = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff)
    rq_args = (spec, table_qh, nv_h, batch.states, la_qh, ph_qh, *terms_h, dt.diag_yz,
               dt.diag_coeff)
    rq_got, rq_again = rank_quadratic_energy(*rq_args), rank_quadratic_energy(*rq_args)
    rq_want, rq_plain_ms = _timed(lambda: rank_quadratic_energy_ref(*rq_args, chunk_rows=chunk))
    rq_tol = rank_quadratic_energy_tolerance(spec, table_qh, nv_h, batch.states, la_qh,
                                             *terms_h, dt.diag_coeff, chunk_rows=chunk)
    rq_diff = [(a - b).abs() for a, b in zip(rq_got, rq_want)]
    rq_err = float(rq_diff[0].max())
    rq_ok = all(bool((d <= t).all()) for d, t in zip(rq_diff, rq_tol))
    rq_same = all(torch.equal(a, b) for a, b in zip(rq_got, rq_again))
    work_rq = _rank_work(spec, table_qh, batch.states[:nu], dt.xy_unique,
                         torch.diff(dt.xy_ptr.long()), QUAD_MISS)
    print(f"[eloc] H2O 6-31G, rank engine with no dense A (a_mat=None): launches {rn_counts}; "
          f"vs the rank engine with a dense A on {nu} rows {d_rn:.3e} Ha (tol {ENGINE_TOL}); "
          f"quadratic_energy {q_rn:.10f} vs phase 8's {q_k:.10f}: rel {q_rel_rn:.2e} (tol "
          f"{QUAD_RTOL}), launches {qrn_counts}; both bitwise equal to the calls with the "
          f"dense A={rn_same}", flush=True)
    print(f"[kernel] rank_quadratic_energy (H2O 6-31G, {batch.states.shape[0]} rows of which "
          f"{nu} live, Kxy={dt.xy_unique.shape[0]}): vs its plain version num max_abs_err="
          f"{rq_err:.3e}, worst row at {float((rq_diff[0] / rq_tol[0].clamp_min(1e-300)).max()):.3f} "
          f"of its tolerance, within (num and w)={rq_ok}, twice bitwise equal={rq_same}; "
          f"{work_rq}", flush=True)
    want_rn = dict({w.__name__: 0 for w in wrappers}, rank_local_energy=1)
    want_qrn = dict({w.__name__: 0 for w in wrappers}, rank_quadratic_energy=1)
    if not (d_rn <= ENGINE_TOL and q_rel_rn <= QUAD_RTOL and rn_counts == want_rn
            and qrn_counts == want_qrn and math.isfinite(q_rn) and rq_ok and rq_same
            and rn_same):
        raise SystemExit("H2O 6-31G: the rank engine with no dense A disagrees with the rank "
                         "engine with one, or ran other kernels than its own one launch, or "
                         "rank_quadratic_energy disagrees with its plain version")
    del e_rn

    t1 = time.time()
    mol4 = nt.load_molecule("N2_6-31G_gen")
    t_jw = time.time() - t1
    hil4 = nt.Hilbert.for_molecule(mol4)
    terms4 = nt.compile_pauli_terms(mol4.qubit_hamiltonian, mol4.n_qubits)
    cfg4 = nt.NAQSConfig(n_qubits=mol4.n_qubits, sectors=hil4.sectors,
                         amp_hidden=(64,), phase_hidden=(512, 512))
    t2 = time.time()
    tr4 = nt.VMCTrainer(cfg4, terms4, hil4, tc, device=dev)
    dt4 = tr4.dt
    if not (dt4.rank_spec is None and dt4.dense is None and dt4.a_mat is None):
        raise SystemExit("N2 6-31G must dispatch to the sort engine with the per-term H row")
    cap4 = tr4.capacity
    chunk4 = le._chunks(dt4, cap4, None)
    per_call4 = -(-cap4 // chunk4)
    groups4 = np.bincount(terms4.gxy)
    print(f"[setup] N2 6-31G: {mol4.n_qubits} qubits, sector {hil4.sectors[0]} of "
          f"{hil4.sector_size} states, HF {mol4.hf_energy:.6f} Ha; K={len(terms4.coeff)} "
          f"Kxy={len(terms4.xy_unique)} (pad {dt4.xy_unique.shape[0]}) Kyz="
          f"{len(terms4.yz_unique)} (pad {dt4.yz_unique.shape[0]}) Kd={len(terms4.diag_yz)}, "
          f"terms per flip mask max {int(groups4.max())} mean {groups4.mean():.2f}; no RankSpec, "
          f"no grid program, no dense A ({dt4.yz_unique.shape[0] * dt4.xy_unique.shape[0]} "
          f"entries); chunks of {chunk4} rows, {per_call4} per local_energy call at capacity "
          f"{cap4}; {sum(p.numel() for p in tr4.model.parameters())} params; "
          f"{time.time() - t1:.1f}s, of which the Jordan-Wigner transform {t_jw:.1f}s and the "
          f"trainer with its DeviceTerms {time.time() - t2:.1f}s", flush=True)
    # the three kernels on a real chunk of a sampled batch
    batch4 = tr4._sample()
    with torch.no_grad():
        la4, ph4 = log_psi(tr4.model, batch4.states)
    s4 = batch4.states[:chunk4].contiguous()
    my_la4, my_ph4 = la4[:chunk4].float().contiguous(), ph4[:chunk4].float().contiguous()
    xy4 = dt4.xy_unique
    h_args = (s4, dt4.yz_unique, dt4.xy_ptr, dt4.term_yz, dt4.term_coeff)
    h4, h4_again = offdiag_h_terms(*h_args), offdiag_h_terms(*h_args)
    h4_ref = offdiag_h_terms_ref(*h_args)
    h_diff = (h4 - h4_ref).abs()
    h_tol = offdiag_tolerance(dt4.xy_ptr, dt4.term_coeff)[None, :]
    offdiag_err = float(h_diff.max())
    h_ok = bool((h_diff <= h_tol).all()) and bool(torch.isfinite(h4).all())
    h_same = torch.equal(h4, h4_again)
    table4 = pack_table(batch4.states, la4, ph4)
    nv4 = le._count(batch4.n_unique, dev)
    r_args = (*table4, nv4, s4, xy4, my_la4, my_ph4, h4)
    r_got, r_again = sorted_ratio_rowsum(*r_args), sorted_ratio_rowsum(*r_args)
    r_want = sorted_ratio_rowsum_ref(*r_args)
    g_la4 = sorted_log_amps(table4[0], table4[1], nv4, s4, xy4)
    r_tol = rowsum_tolerance(g_la4, my_la4, h4)
    r_diff = [(g - w).abs() for g, w in zip(r_got, r_want)]
    ratio_err4 = max(float(d.max()) for d in r_diff)
    r_ok = all(bool((d <= r_tol).all()) for d in r_diff) and all(
        bool(torch.isfinite(g).all()) for g in r_got)
    r_same = all(torch.equal(a, b) for a, b in zip(r_got, r_again))
    live4 = torch.arange(chunk4, device=dev) < batch4.n_unique
    g_args = (*table4, nv4, s4, xy4, live4)
    g_got, g_again = sorted_gather2(*g_args), sorted_gather2(*g_args)
    g_want = sorted_gather2_ref(*g_args)
    g_same = all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    g_twice = all(torch.equal(a, b) for a, b in zip(g_got, g_again))
    gather_err4 = max(_max_diff(a, b) for a, b in zip(g_got, g_want))
    found4 = g_la4 > -1e29
    n_found4 = int(found4.sum())
    q4 = s4[:, None] ^ xy4[None, :]
    n_live4 = int(batch4.n_unique)
    n_rows4 = int(torch.unique(torch.searchsorted(table4[0], q4)[found4]).numel())
    n_hits4 = n_found4 - chunk4 * (xy4.shape[0] - len(terms4.xy_unique))   # pad xy = 0 finds s
    n_levels4 = max(math.ceil(math.log2(max(int(batch4.n_unique), 1))), 0)
    torch.cuda.synchronize()
    print(f"[kernel] offdiag_h_terms (C={chunk4}, Kxy={xy4.shape[0]}, {len(terms4.coeff)} "
          f"terms): max_abs_err={offdiag_err:.3e}, worst entry at "
          f"{float((h_diff / h_tol).max()):.3f} of its tolerance ({OFFDIAG_ATOL} + "
          f"{OFFDIAG_RTOL} * sum_k |coeff_k|), within={h_ok}, twice bitwise equal={h_same}",
          flush=True)
    print(f"[kernel] sorted_ratio_rowsum (C={chunk4}, Kxy={xy4.shape[0]}, a table of "
          f"{int(batch4.n_unique)} live states in {cap4}, {n_levels4} search levels, real h): "
          f"max_abs_err={ratio_err4:.3e} Ha, worst row at "
          f"{max(float((d / r_tol).max()) for d in r_diff):.3f} of its tolerance, within={r_ok}, "
          f"twice bitwise equal={r_same}; coupled states found {n_found4} of "
          f"{chunk4 * xy4.shape[0]} ({n_hits4} beyond the padded flip masks)", flush=True)
    print(f"[kernel] sorted_gather2 (C={chunk4}, Kxy={xy4.shape[0]}): bitwise equal to its "
          f"plain version={g_same}, twice bitwise equal={g_twice}", flush=True)
    if not (h_ok and h_same and r_ok and r_same and g_same and g_twice):
        raise SystemExit("a sort-engine kernel disagrees with its plain version or itself")

    # sorted_local_energy on the whole sampled buffer at capacity 100,000, as the
    # training step's E_loc call gives it: against its plain version, against this
    # tree's two kernels composed over the same chunks as the chunk loop ran them,
    # twice bitwise, and with SENTINEL query rows between live ones
    e_args = (*table4, nv4, *table4, xy4, dt4.xy_ptr, dt4.term_yz, dt4.yz_unique,
              dt4.term_coeff, dt4.diag_yz, dt4.diag_coeff)
    tol_args = (table4[0], table4[1], nv4, table4[0], table4[1], xy4, dt4.xy_ptr, dt4.term_yz,
                dt4.yz_unique, dt4.term_coeff, dt4.diag_coeff)
    e_new, e_twice = sorted_local_energy(*e_args), sorted_local_energy(*e_args)
    e_plain = sorted_local_energy_ref(*e_args, chunk_rows=chunk4)
    e_tol = sorted_local_energy_tolerance(*tol_args, chunk_rows=chunk4)
    e_diff = [(a - b).abs() for a, b in zip(e_new, e_plain)]
    eloc_err4 = max(float(d.max()) for d in e_diff)
    e_ok = all(bool((d <= e_tol).all()) for d in e_diff) and all(
        bool(torch.isfinite(a).all()) for a in e_new)
    e_same = all(torch.equal(a, b) for a, b in zip(e_new, e_twice))
    chunks4 = [(slice(i, i + chunk4), table4[0][i:i + chunk4], table4[1][i:i + chunk4],
                table4[2][i:i + chunk4]) for i in range(0, cap4, chunk4)]

    def composition(h_fn, r_fn):
        """the chunk loop's two kernels over the whole buffer: (re, im) f32"""
        out = [r_fn(*table4, nv4, s, xy4, my_la, my_ph,
                    h_fn(s, dt4.yz_unique, dt4.xy_ptr, dt4.term_yz, dt4.term_coeff))
               for _, s, my_la, my_ph in chunks4]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    diag4 = le.diagonal_energy(dt4, table4[0])
    comp4 = composition(offdiag_h_terms, sorted_ratio_rowsum)
    comp_tol = sorted_local_energy_tolerance(*tol_args, chunk_rows=chunk4, h_exact=True)
    c_diff = [(e_new[0] - diag4 - comp4[0].double()).abs(),
              (e_new[1] - comp4[1].double()).abs()]
    comp_err4 = max(float(d.max()) for d in c_diff)
    c_ok = all(bool((d <= comp_tol).all()) for d in c_diff)
    im_bits = torch.equal(e_new[1], comp4[1].double())
    # queries=: the first live rows with two SENTINEL rows after every one of them
    n_q = min(2048, n_live4)
    pads = torch.full((3 * n_q,), SENTINEL, dtype=torch.int64, device=dev)
    q_rows = [pads.clone(), torch.zeros(3 * n_q, device=dev), torch.zeros(3 * n_q, device=dev)]
    for q_t, src_t in zip(q_rows, (batch4.states, la4, ph4)):
        q_t[::3] = src_t[:n_q].to(q_t.dtype)
    before_q = sorted_local_energy.launches
    q_e = le.local_energy(dt4, batch4.states, la4, ph4, batch4.n_unique, queries=tuple(q_rows))
    q_launches = sorted_local_energy.launches - before_q
    pad_q = q_rows[0] == SENTINEL
    pad_diag = le.diagonal_energy(dt4, q_rows[0][pad_q])
    diag_tol = DIAG_RTOL * float(dt4.diag_coeff.abs().sum())
    q_ok = (bool((q_e[1][pad_q] == 0).all())
            and float((q_e[0][pad_q] - pad_diag).abs().max()) <= diag_tol
            and torch.equal(q_e[0][~pad_q], e_new[0][:n_q])
            and torch.equal(q_e[1][~pad_q], e_new[1][:n_q]) and q_launches == 1)
    # what the call searches and finds: the live rows' coupled states, the real
    # found pairs (a flip mask with terms) and their groups' terms, the distinct
    # table rows found
    sizes4 = torch.diff(dt4.xy_ptr.long())
    real4 = sizes4 > 0
    work4 = _search_work(table4, nv4, table4[0][:n_live4], xy4, sizes4)
    n_found_pairs, n_found_terms, n_found_rows = (work4[k] for k in ("found", "terms", "rows"))
    torch.cuda.synchronize()
    print(f"[kernel] sorted_local_energy ({cap4} query rows of which {n_live4} live, Kxy="
          f"{xy4.shape[0]} ({int(real4.sum())} with terms), Kd={dt4.diag_yz.shape[0]}): vs its "
          f"plain version max_abs_err={eloc_err4:.3e} Ha, worst row at "
          f"{max(float((d / e_tol).max()) for d in e_diff):.3f} of its tolerance (rowsum "
          f"{ROWSUM_ATOL} + {ROWSUM_RTOL} sum|h||r|, + sum_k |r_k| offdiag_tolerance_k, + "
          f"{DIAG_RTOL} sum|diag_coeff| = {diag_tol:.2e}), within={e_ok}; vs this tree's "
          f"offdiag_h_terms + sorted_ratio_rowsum composed over {len(chunks4)} chunks "
          f"{comp_err4:.3e} Ha, within (no H term)={c_ok}, e_im bitwise equal={im_bits}; "
          f"twice bitwise equal={e_same}; queries= with {int(pad_q.sum())} SENTINEL rows "
          f"between {n_q} live ones: padding rows e_im 0 and e_re their diagonal, live rows "
          f"bitwise as in the whole call, one launch={q_ok}; the live rows' {n_live4} x "
          f"{int(real4.sum())} coupled states found {n_found_pairs} (flip masks with terms), "
          f"{n_found_terms} terms walked, {n_found_rows} distinct table rows", flush=True)
    if not (e_ok and c_ok and e_same and q_ok):
        raise SystemExit("sorted_local_energy disagrees with its plain version, with the two "
                         "kernels composed or with itself, or mishandles SENTINEL query rows")

    zero_counts()
    n_updates4, t_n2, n_draws4 = _steps(tr4, N2_STEPS, "sort (N2 6-31G)")
    n2_counts = {w.__name__: w.launches for w in wrappers}
    want_counts = {w.__name__: 0 for w in wrappers}
    want_counts.update(sorted_local_energy=n_updates4,
                       _split_and_compact=cfg4.n_shells * n_draws4)
    print(f"[path] N2 6-31G default dispatch (sort engine, no dense A): launches in {N2_STEPS} "
          f"steps {n2_counts} ({n_updates4} vmc_update calls, one sorted_local_energy launch "
          f"per local_energy call; {n_draws4} sample() calls of {cfg4.n_shells} shells); steps "
          f"{', '.join(f'{t:.3f}' for t in t_n2)} s", flush=True)
    if n2_counts != want_counts or n_updates4 < N2_STEPS:
        raise SystemExit(f"N2 6-31G did not run sorted_local_energy once per E_loc call and "
                         f"split_and_compact once per shell, or ran other kernels: "
                         f"{n2_counts} against {want_counts}")
    sort_launches = n2_counts["sorted_ratio_rowsum"]
    offdiag_launches = n2_counts["offdiag_h_terms"]
    energy_launches = n2_counts["sorted_local_energy"]
    # 8 rows of a fresh batch against the float64 oracle: 4 at random and the 4
    # whose off-diagonal part is largest (few sampled states couple at random weights)
    batch4 = tr4._sample()
    with torch.no_grad():
        la4, ph4 = log_psi(tr4.model, batch4.states)
    nu4 = int(batch4.n_unique)
    e4 = le.local_energy(dt4, batch4.states, la4, ph4, batch4.n_unique)
    off4 = (e4[0][:nu4] - le.diagonal_energy(dt4, batch4.states[:nu4])).abs()
    top4 = torch.topk(off4, 4).indices.cpu().numpy()
    rest4 = np.setdiff1d(np.arange(nu4), top4)
    rows8 = np.sort(np.concatenate([top4, np.random.default_rng(3).choice(rest4, 4,
                                                                          replace=False)]))
    t1 = time.time()
    ref4 = _oracle_rows(terms4, batch4.states[:nu4].cpu().numpy(),
                        la4[:nu4].double().cpu().numpy(), ph4[:nu4].double().cpu().numpy(), rows8)
    err4 = float(np.abs(e4[0][:nu4].cpu().numpy()[rows8] - ref4).max())
    finite4 = bool(torch.isfinite(e4[0][:nu4]).all() and torch.isfinite(e4[1][:nu4]).all())
    print(f"[eloc] N2 6-31G, sort engine: {nu4} live rows, all finite={finite4}, rows with a "
          f"found coupled state {int((off4 > 0).sum())}; 8 rows (the 4 of the largest "
          f"off-diagonal part and 4 at random) vs float64 local_energy_np: {err4:.2e} Ha (tol "
          f"{ELOC_TOL}; the oracle "
          f"{time.time() - t1:.1f}s); their E_loc - E_diag up to "
          f"{float(np.abs(ref4 - diagonal_energy_np(terms4, batch4.states[:nu4].cpu().numpy()[rows8])).max()):.3e} Ha",
          flush=True)
    if not (err4 < ELOC_TOL and finite4):
        raise SystemExit("N2 6-31G: the sort engine disagrees with the float64 oracle")
    # quadratic_energy on the same batch: one sorted_quadratic_energy launch (before:
    # sorted_gather2 and the per-term H row once per chunk), against the same call
    # through its plain version; the kernel against its plain version per row
    zero_counts()
    qe4 = float(le.quadratic_energy(dt4, batch4.states, la4, ph4, batch4.n_unique))
    quad4_counts = {w.__name__: w.launches for w in wrappers}
    le.sorted_quadratic_energy = sorted_quadratic_energy_ref
    try:
        qe4_plain = float(le.quadratic_energy(dt4, batch4.states, la4, ph4, batch4.n_unique))
    finally:
        le.sorted_quadratic_energy = sorted_quadratic_energy
    qe4_rel = abs(qe4 - qe4_plain) / abs(qe4_plain)
    want_counts = dict({w.__name__: 0 for w in wrappers}, sorted_quadratic_energy=1)
    live4q = torch.arange(cap4, device=dev) < batch4.n_unique
    la_q4 = torch.where(live4q, la4 - la4[:nu4].max(), QUAD_MISS).float().contiguous()
    ph_q4 = ph4.float().contiguous()
    nv4q = le._count(batch4.n_unique, dev)
    terms4_dev = (dt4.xy_unique, dt4.xy_ptr, dt4.term_yz, dt4.yz_unique, dt4.term_coeff)
    sq_args = (batch4.states, la_q4, ph_q4, nv4q, *terms4_dev, dt4.diag_yz, dt4.diag_coeff)
    sq_got, sq_again = sorted_quadratic_energy(*sq_args), sorted_quadratic_energy(*sq_args)
    sq_want, sq_plain_ms = _timed(lambda: sorted_quadratic_energy_ref(*sq_args,
                                                                      chunk_rows=chunk4))
    sq_tol = sorted_quadratic_energy_tolerance(batch4.states, la_q4, ph_q4, nv4q, *terms4_dev,
                                               dt4.diag_coeff, chunk_rows=chunk4)
    sq_diff = [(a - b).abs() for a, b in zip(sq_got, sq_want)]
    sq_err = float(sq_diff[0].max())
    sq_ok = all(bool((d <= t).all()) for d, t in zip(sq_diff, sq_tol))
    sq_same = all(torch.equal(a, b) for a, b in zip(sq_got, sq_again))
    work_sq = _search_work((batch4.states, la_q4, ph_q4), nv4q, batch4.states[:nu4], xy4,
                           sizes4)
    print(f"[quad] N2 6-31G: quadratic_energy through sorted_quadratic_energy {qe4:.10f} vs "
          f"through its plain version {qe4_plain:.10f}: rel {qe4_rel:.2e} (tol {QUAD_RTOL}); "
          f"launches {quad4_counts}", flush=True)
    print(f"[kernel] sorted_quadratic_energy ({cap4} rows of which {nu4} live, Kxy="
          f"{xy4.shape[0]}): vs its plain version num max_abs_err={sq_err:.3e}, worst row at "
          f"{float((sq_diff[0] / sq_tol[0].clamp_min(1e-300)).max()):.3f} of its tolerance, "
          f"within (num and w)={sq_ok}, twice bitwise equal={sq_same}; {work_sq}", flush=True)
    if not (quad4_counts == want_counts and math.isfinite(qe4) and qe4_rel <= QUAD_RTOL
            and sq_ok and sq_same):
        raise SystemExit(f"N2 6-31G: quadratic_energy through sorted_quadratic_energy disagrees "
                         f"with its plain version, or did not run it once and nothing else: "
                         f"{quad4_counts} against {want_counts}")
    quad_launches = quad4_counts["sorted_gather2"]
    sq_launches = quad4_counts["sorted_quadratic_energy"]

    # 10d. frozen-core N2 6-31G (32 qubits, a RankSpec, no grid program, no dense A):
    # the rank engine's one-launch E_loc on the training path
    t1 = time.time()
    terms5 = freeze_core(terms4, 4)
    hil5 = nt.Hilbert(n_qubits=mol4.n_qubits - 4, sectors=((5, 5),))
    cfg5 = nt.NAQSConfig(n_qubits=hil5.n_qubits, sectors=hil5.sectors,
                         amp_hidden=(64,), phase_hidden=(512, 512))
    tr5 = nt.VMCTrainer(cfg5, terms5, hil5, tc, device=dev)
    dt5 = tr5.dt
    spec5 = dt5.rank_spec
    if not (spec5 is not None and dt5.dense is None and dt5.a_mat is None):
        raise SystemExit("frozen-core N2 6-31G must dispatch to the rank engine with no dense "
                         "A and no grid program")
    cap5 = tr5.capacity
    chunk5 = le._chunks(dt5, cap5, None)
    per_call5 = -(-cap5 // chunk5)
    sizes5 = torch.diff(dt5.xy_ptr.long())
    print(f"[setup] frozen-core N2 6-31G: freeze_core(N2 6-31G's terms, 4): "
          f"{hil5.n_qubits} qubits, sector {hil5.sectors[0]} of {hil5.sector_size} states (table "
          f"{(spec5.size + 1) * 8} B); K={len(terms5.coeff)} Kxy={len(terms5.xy_unique)} (pad "
          f"{dt5.xy_unique.shape[0]}) Kyz={len(terms5.yz_unique)} Kd={len(terms5.diag_yz)}, terms "
          f"per flip mask max {int(sizes5.max())}; the dispatch: rank engine (RankSpec), no grid "
          f"program, no dense A ({dt5.yz_unique.shape[0] * dt5.xy_unique.shape[0]} entries): "
          f"one rank_local_energy launch a local_energy call (the earlier chunk loop: "
          f"{per_call5} chunks of {chunk5} rows at capacity {cap5}); {time.time() - t1:.1f}s",
          flush=True)
    batch5 = tr5._sample()
    with torch.no_grad():
        la5, ph5 = log_psi(tr5.model, batch5.states)
    nu5 = int(batch5.n_unique)
    table5 = build_value_table(spec5, batch5.states, la5, ph5, batch5.n_unique)
    q5 = pack_table(batch5.states, la5, ph5)
    terms5_dev = (dt5.xy_unique, dt5.xy_ptr, dt5.term_yz, dt5.yz_unique, dt5.term_coeff)
    r5_args = (spec5, table5, *q5, *terms5_dev, dt5.diag_yz, dt5.diag_coeff)
    e5, e5_twice = rank_local_energy(*r5_args), rank_local_energy(*r5_args)
    e5_plain, e5_plain_ms = _timed(lambda: rank_local_energy_ref(*r5_args, chunk_rows=chunk5))
    e5_tol = rank_local_energy_tolerance(spec5, table5, q5[0], q5[1], *terms5_dev,
                                         dt5.diag_coeff, chunk_rows=chunk5)
    e5_diff = [(a - b).abs() for a, b in zip(e5, e5_plain)]
    eloc_err5 = max(float(d.max()) for d in e5_diff)
    e5_ok = all(bool((d <= e5_tol).all()) for d in e5_diff) and all(
        bool(torch.isfinite(a).all()) for a in e5)
    e5_same = all(torch.equal(a, b) for a, b in zip(e5, e5_twice))
    chunks5 = [(q5[0][i:i + chunk5], q5[1][i:i + chunk5], q5[2][i:i + chunk5])
               for i in range(0, cap5, chunk5)]

    def composition5(h_fn, r_fn):
        """the parent's chunk loop's two kernels over the whole buffer: (re, im) f32"""
        out = [r_fn(spec5, s, dt5.xy_unique, table5, my_la, my_ph,
                    h_fn(s, dt5.yz_unique, dt5.xy_ptr, dt5.term_yz, dt5.term_coeff))
               for s, my_la, my_ph in chunks5]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    comp5 = composition5(offdiag_h_terms, rank_ratio_rowsum)
    diag5 = le.diagonal_energy(dt5, q5[0])
    comp5_tol = rank_local_energy_tolerance(spec5, table5, q5[0], q5[1], *terms5_dev,
                                            dt5.diag_coeff, chunk_rows=chunk5, h_exact=True)
    c5_diff = [(e5[0] - diag5 - comp5[0].double()).abs()[:nu5],
               (e5[1] - comp5[1].double()).abs()[:nu5]]
    comp_err5 = max(float(d.max()) for d in c5_diff)
    c5_ok = all(bool((d <= comp5_tol[:nu5]).all()) for d in c5_diff)
    im5_bits = torch.equal(e5[1][:nu5], comp5[1][:nu5].double())
    pad5 = q5[0] == SENTINEL
    pad5_ok = bool((e5[1][pad5] == 0).all()) and float(
        (e5[0][pad5] - le.diagonal_energy(dt5, q5[0][pad5])).abs().max()) <= DIAG_RTOL * float(
        dt5.diag_coeff.abs().sum())
    work5 = _rank_work(spec5, table5, q5[0][:nu5], dt5.xy_unique, sizes5, -1e29)
    torch.cuda.synchronize()
    print(f"[kernel] rank_local_energy (frozen-core N2 6-31G, {cap5} query rows of which {nu5} "
          f"live, Kxy={dt5.xy_unique.shape[0]}): vs its plain version max_abs_err="
          f"{eloc_err5:.3e} Ha, worst row at {max(float((d / e5_tol).max()) for d in e5_diff):.3f} "
          f"of its tolerance, within={e5_ok}; vs this tree's offdiag_h_terms + "
          f"rank_ratio_rowsum composed over {len(chunks5)} chunks on the live rows "
          f"{comp_err5:.3e} Ha, within (no H term)={c5_ok}, e_im bitwise equal={im5_bits}; "
          f"padding rows their diagonal and 0={pad5_ok}; twice bitwise equal={e5_same}; the "
          f"live rows' pairs with terms {work5['pairs']}, inside a sector {work5['inside']} "
          f"({work5['inside'] / work5['pairs']:.2%}: table rows read, {work5['rows']} distinct), "
          f"found {work5['found']}, terms walked {work5['terms']}", flush=True)
    if not (e5_ok and c5_ok and e5_same and pad5_ok):
        raise SystemExit("rank_local_energy disagrees with its plain version, with the chunk "
                         "loop's kernels composed or with itself, or mishandles padding rows")
    zero_counts()
    n_updates5, t_fc, n_draws5 = _steps(tr5, FROZEN_STEPS, "rank, no A (frozen-core N2 6-31G)")
    fc_counts = {w.__name__: w.launches for w in wrappers}
    want_counts = dict({w.__name__: 0 for w in wrappers}, rank_local_energy=n_updates5,
                       _split_and_compact=cfg5.n_shells * n_draws5)
    print(f"[path] frozen-core N2 6-31G default dispatch (rank engine, no dense A): launches "
          f"in {FROZEN_STEPS} steps {fc_counts} ({n_updates5} vmc_update calls: one "
          f"rank_local_energy launch and no offdiag_h_terms a local_energy call; {n_draws5} "
          f"sample() calls of {cfg5.n_shells} shells); steps "
          f"{', '.join(f'{t:.3f}' for t in t_fc)} s", flush=True)
    if fc_counts != want_counts or n_updates5 < FROZEN_STEPS:
        raise SystemExit(f"frozen-core N2 6-31G did not run rank_local_energy once per E_loc "
                         f"call and split_and_compact once per shell, or ran other kernels: "
                         f"{fc_counts} against {want_counts}")
    fc_launches = fc_counts["rank_local_energy"]

    # the host layer: the native library against numpy, and N2 STO-3G's ground state
    t1 = time.time()
    if not native.available():
        raise SystemExit("the native host library did not build")
    basis2 = hil2.basis
    coo = native.assemble_h_coo(terms2, basis2)
    t_nat = time.time() - t1
    h_nat = sp.csr_matrix((coo[2], (coo[0], coo[1])), shape=(len(basis2), len(basis2)))
    t1 = time.time()
    coo_np = _assemble_rows_np(terms2, basis2, 0, len(basis2))
    t_np = time.time() - t1
    h_np = sp.csr_matrix((coo_np[2], (coo_np[0], coo_np[1])), shape=h_nat.shape)
    d_csr = abs(h_nat - h_np)
    csr_diff = float(d_csr.max()) if d_csr.nnz else 0.0
    h_csr = assemble_sparse_hamiltonian_np(terms2, basis2)
    e0 = float(eigsh(h_csr, k=1, which="SA")[0][0])
    fci_err = abs(e0 - mol2.fci_energy)
    print(f"[host] native library {native._LIB}: N2 STO-3G's {len(basis2)}-state sector, "
          f"{h_nat.nnz} nonzeros, native COO {t_nat:.2f}s and numpy {t_np:.2f}s: max difference "
          f"{csr_diff:.1e}; assemble_sparse_hamiltonian_np's ground state {e0:.8f} Ha vs FCI "
          f"{mol2.fci_energy:.8f}: {fci_err:.1e} Ha (tol 1e-6)", flush=True)
    if not (csr_diff <= 1e-12 and h_nat.nnz == h_np.nnz and fci_err < 1e-6):
        raise SystemExit("the host layer: native and numpy assembly differ, or the ground "
                         "state misses FCI")

    # 11. times, in turns

    def check_hold(names, launches, unheld):
        # the held times are the card's only where the hold outlasted the unheld run
        slow = [n for n in names if unheld[n][1][1] * launches >= times[n][2]]
        if slow:
            raise SystemExit(f"the hold did not cover the enqueue of {slow}: held times "
                             f"invalid")

    times = time_in_turns(fns, REPEATS, LAUNCHES)
    calls = time_in_turns({n: fns[n] for n in fast}, REPEATS, LAUNCHES, hold=False)
    # the split_and_compact wrapper's host side, piece by piece, unheld: its input
    # checks (as the wrapper builds them), its one allocation and the whole call
    a0, b0, c0, v0, p0, z0, u0, m0, j0, cap0, nl0 = step_args
    i64, f32, bl = (torch.int64,), (torch.float32,), (torch.bool,)
    host_fns = {
        "split_and_compact: check_tensors": lambda: _build.check_tensors(
            "split_and_compact", a0, {
                "a": (a0, i64, (cap0,)), "b": (b0, i64, (cap0,)),
                "counts": (c0, (torch.float64,), (cap0,)), "valid": (v0, bl, (cap0,)),
                "probs": (p0, (torch.float32, torch.float64), (cap0, 4)),
                "z": (z0, f32, (3, cap0)), "u": (u0, f32, (3, cap0)),
                "mask": (m0, bl, (cap0, 4)),
                **({"n_live": (nl0, i64, ())} if torch.is_tensor(nl0) else {})}, align=16),
        "split_and_compact: its one allocation": lambda: _split_frontier(cap0, dev),
        "split_and_compact": fns["split_and_compact"],
    }
    host_calls = time_in_turns(host_fns, REPEATS, LAUNCHES, hold=False)
    for name, (med, spread, _) in host_calls.items():
        print(f"[time] host side, unheld: {name}: median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms", flush=True)
    fle_name = "factored_local_energy (H2O 6-31G)"
    slow_fns = {
        "factored_cells_accumulate": lambda: factored_cells_accumulate(fn, grid, g_idx, g_n),
        "factored_cells_accumulate_ref": lambda: factored_cells_accumulate_ref(fn, grid, g_idx,
                                                                               g_n),
        "dense_grid_accumulate_ref": lambda: dense_grid_accumulate_ref(dn, grid2),
        fle_name: lambda: factored_local_energy(fn, spec, batch.states, la, ph, batch.n_unique),
        "local_energy (rank engine)": lambda: le.local_energy(
            dt_rank, batch.states, la, ph, batch.n_unique),
        "xl_grid_accumulate": lambda: xl_grid_accumulate(xl, grid3),
        "xl_grid_accumulate (full grid)": lambda: xl_grid_accumulate(xl, full3),
        "xl_grid_accumulate (staircase grid)": lambda: xl_grid_accumulate(xl, stair3),
        "xl_grid_accumulate_ref": lambda: xl_grid_accumulate_ref(xl, grid3),
        "local_energy (FactorTermsXL, Li2O)": lambda: le.local_energy(
            tr3.dt, batch3.states, la3, ph3, batch3.n_unique),
        "local_energy (rank engine, Li2O)": lambda: le.local_energy(
            dt3_rank, batch3.states, la3, ph3, batch3.n_unique),
        "multinomial4_split_ref": lambda: multinomial4_split_ref(*split_args),
        "split_and_compact_ref": lambda: _split_and_compact_ref(*step_args),
        "(U, 127) cumprod/cumsum split": lambda: _split_before(s_counts, s_probs, s_z, s_u,
                                                               s_mask),
        "sample() at capacity 100,000": lambda: sampler_mod.sample(tr.model, tr.gen, 1e5, cap),
    }
    if fact_old is not None:
        slow_fns[old_fact] = fact_old
        slow_fns[old_fle] = lambda: old_mods["dense_engine"].factored_local_energy(
            fn, spec, batch.states, la, ph, batch.n_unique)
    if "grid" in old_mods and hasattr(old_mods["grid"], "xl_grid_accumulate"):
        slow_fns[old_xl] = lambda: xl_old(xl, grid3)
        slow_fns[f"{old_xl} (full grid)"] = lambda: xl_old(xl, full3)
        slow_fns[f"{old_xl} (staircase grid)"] = lambda: xl_old(xl, stair3)
    old_sample = "sample() at capacity 100,000 (earlier tree)"
    if "sampler" in old_mods:
        slow_fns[old_sample] = lambda: old_mods["sampler"].sample(tr.model, tr.gen, 1e5, cap)
    times.update(time_in_turns(slow_fns, SLOW_REPEATS, SLOW_LAUNCHES))
    # the sort engine's kernels on N2 6-31G's chunk, their plain versions and the
    # library calls (each computes less than its kernel: no found test, no ratio,
    # no row sum; the segment sum of products computed beforehand)
    group4 = term_group(dt4.xy_ptr, dt4.term_yz.shape[0])
    contrib4 = (parity_pm1(s4[:, None] & dt4.yz_unique[None, :]).float()[:, dt4.term_yz.long()]
                * dt4.term_coeff)
    h_zero = torch.zeros_like(h4)

    def searchsorted_gather():
        pos = torch.searchsorted(table4[0], q4)
        return table4[1][pos], table4[2][pos]

    sort_fns = {
        "sorted_ratio_rowsum": lambda: sorted_ratio_rowsum(*r_args),
        "sorted_gather2": lambda: sorted_gather2(*g_args),
        "offdiag_h_terms": lambda: offdiag_h_terms(*h_args),
        "searchsorted + gather": searchsorted_gather,
        "index_add (precomputed products)": lambda: h_zero.index_add(1, group4, contrib4),
        "sorted_ratio_rowsum_ref": lambda: sorted_ratio_rowsum_ref(*r_args),
        "sorted_gather2_ref": lambda: sorted_gather2_ref(*g_args),
        "offdiag_h_terms_ref": lambda: offdiag_h_terms_ref(*h_args),
    }
    times.update(time_in_turns(sort_fns, REPEATS, SORT_LAUNCHES))
    calls.update(time_in_turns(sort_fns, REPEATS, SORT_LAUNCHES, hold=False))
    check_hold(sort_fns, SORT_LAUNCHES, calls)
    # sorted_local_energy on the N2 call; then in turns with the chunk loop's two
    # kernels composed over the same rows (this tree's, and with --before DIR's,
    # first held against the kernel) and with the plain version
    e_name = "sorted_local_energy"
    energy_fns = {e_name: lambda: sorted_local_energy(*e_args)}
    e_old = f"{e_name} (earlier tree)"
    if "sort_lookup" in old_mods:   # DIR's own build of the kernel
        e_prev = old_mods["sort_lookup"].sorted_local_energy(*e_args)
        prev_ok = all(bool(((a - b).abs() <= e_tol).all()) for a, b in zip(e_prev, e_new))
        print(f"[before] the earlier tree's sorted_local_energy vs this tree's: within "
              f"sorted_local_energy_tolerance={prev_ok}, bitwise equal="
              f"{all(torch.equal(a, b) for a, b in zip(e_prev, e_new))}", flush=True)
        if not prev_ok:
            raise SystemExit("the earlier tree's sorted_local_energy disagrees with this tree's")
        energy_fns[e_old] = lambda: old_mods["sort_lookup"].sorted_local_energy(*e_args)
    times.update(time_in_turns(energy_fns, REPEATS, ENERGY_LAUNCHES))
    calls.update(time_in_turns(energy_fns, REPEATS, ENERGY_LAUNCHES, hold=False))
    check_hold(energy_fns, ENERGY_LAUNCHES, calls)
    e_comp = "offdiag_h_terms + sorted_ratio_rowsum (782 chunks)"
    e_comp_old = f"{e_comp}, earlier tree"
    e_plain_name = "sorted_local_energy_ref"
    comp_fns = {e_name: energy_fns[e_name],
                e_comp: lambda: composition(offdiag_h_terms, sorted_ratio_rowsum),
                e_plain_name: lambda: sorted_local_energy_ref(*e_args, chunk_rows=chunk4)}
    if "sort_lookup" in old_mods:
        comp_old = composition(old_mods["offdiag_h"].offdiag_h_terms,
                               old_mods["sort_lookup"].sorted_ratio_rowsum)
        d_old = [(e_new[0] - diag4 - comp_old[0].double()).abs(),
                 (e_new[1] - comp_old[1].double()).abs()]
        old_ok = all(bool((d <= comp_tol).all()) for d in d_old)
        print(f"[before] the earlier tree's offdiag_h_terms + sorted_ratio_rowsum over "
              f"{len(chunks4)} chunks vs sorted_local_energy: "
              f"{max(float(d.max()) for d in d_old):.3e} Ha, within={old_ok}, e_im bitwise "
              f"equal={torch.equal(e_new[1], comp_old[1].double())}", flush=True)
        if not old_ok:
            raise SystemExit("the earlier tree's composition disagrees with sorted_local_energy")
        comp_fns[e_comp_old] = lambda: composition(old_mods["offdiag_h"].offdiag_h_terms,
                                                   old_mods["sort_lookup"].sorted_ratio_rowsum)
    comp_times = time_in_turns(comp_fns, SLOW_REPEATS, 1)
    comp_calls = time_in_turns(comp_fns, SLOW_REPEATS, 1, hold=False)
    times.update({n: t for n, t in comp_times.items() if n != e_name})
    check_hold([n for n in comp_fns if n != e_name], 1, comp_calls)
    calls.update({n: t for n, t in comp_calls.items() if n != e_name})
    # one whole local_energy call at capacity 100,000 through the kernel (first held
    # against the call through its plain version) and, with --before, through the
    # earlier tree's chunk loop, unheld: the call's wall time on the card, host included

    def plain_call():
        le.sorted_local_energy = sorted_local_energy_ref
        try:
            return le.local_energy(dt4, batch4.states, la4, ph4, batch4.n_unique)
        finally:
            le.sorted_local_energy = sorted_local_energy

    e4_plain = plain_call()
    d_plain = max(float((a[:nu4] - b[:nu4]).abs().max()) for a, b in zip(e4, e4_plain))
    print(f"[eloc] N2 6-31G: local_energy through the plain version vs through the kernel on "
          f"{nu4} rows: max_abs_diff {d_plain:.3e} Ha (tol {ENGINE_TOL})", flush=True)
    if d_plain > ENGINE_TOL:
        raise SystemExit("N2 6-31G: local_energy through the kernel and through its plain "
                         "version differ")
    del e4_plain
    le_name = "local_energy (sort engine, N2 6-31G)"
    le_old = f"{le_name}, earlier tree"
    e2e_fns = {le_name: lambda: le.local_energy(dt4, batch4.states, la4, ph4, batch4.n_unique)}
    if "local_energy" in old_mods:
        e2e_fns[le_old] = lambda: old_mods["local_energy"].local_energy(
            dt4, batch4.states, la4, ph4, batch4.n_unique)
    e2e = time_in_turns(e2e_fns, SLOW_REPEATS, 1, hold=False)
    calls.update(e2e)
    # the one-launch kernels of the spaces with no dense A, each alone (held
    # and unheld), then in turns with the chunk loop it replaced (this tree's
    # kernels composed as the parent's loop ran them and, with --before DIR, DIR's
    # own call) and with its plain version, held and unheld; one whole call of
    # each path unheld, this tree's and DIR's

    def sort_gather4(s, live_q):
        return sorted_gather2(batch4.states, la_q4, ph_q4, nv4q, s, xy4, live_q)

    def rank_gather_h(s, live_q):
        return rank_gather2(spec, s, dt.xy_unique, table_qh)

    # the loops of before, held against the kernels' totals
    loop4 = float(_quad_loop(le, dt4, sort_gather4, offdiag_h_terms, batch4.states, la_q4,
                             ph_q4, nv4q, chunk4))
    loop_h = float(_quad_loop(le, dt_rank_noa, rank_gather_h, offdiag_h_terms, batch.states,
                              la_qh, ph_qh, nv_h, chunk))
    q_sq = float(sq_got[0].sum() / sq_got[1].sum())
    q_rq = float(rq_got[0].sum() / rq_got[1].sum())
    print(f"[quad] the chunk loops of before on the same inputs (this tree's gather kernel and "
          f"offdiag_h_terms): N2 6-31G {loop4:.10f} vs sorted_quadratic_energy's {q_sq:.10f}, "
          f"H2O 6-31G {loop_h:.10f} vs rank_quadratic_energy's {q_rq:.10f}", flush=True)
    if not (abs(loop4 - q_sq) <= QUAD_RTOL * abs(loop4)
            and abs(loop_h - q_rq) <= QUAD_RTOL * abs(loop_h)):
        raise SystemExit("a one-launch quadratic form disagrees with the chunk loop of before")
    row_fns = {"rank_local_energy": lambda: rank_local_energy(*r5_args),
               "sorted_quadratic_energy": lambda: sorted_quadratic_energy(*sq_args),
               "rank_quadratic_energy": lambda: rank_quadratic_energy(*rq_args)}
    times.update(time_in_turns(row_fns, REPEATS, ENERGY_LAUNCHES))
    calls.update(time_in_turns(row_fns, REPEATS, ENERGY_LAUNCHES, hold=False))
    check_hold(row_fns, ENERGY_LAUNCHES, calls)
    rcomp = f"offdiag_h_terms + rank_ratio_rowsum ({len(chunks5)} chunks)"
    qcomp = f"sorted_gather2 + offdiag_h_terms + epilogue ({per_call4} chunks)"
    hcomp = f"rank_gather2 + offdiag_h_terms + epilogue ({per_call} chunks)"
    quad_n2 = "quadratic_energy (N2 6-31G)"
    quad_h2o = "quadratic_energy (H2O 6-31G, no dense A)"
    quad_h2o_a = "quadratic_energy (H2O 6-31G, dense A)"
    le_fc = "local_energy (rank engine, no A, frozen-core N2 6-31G)"
    old_tag = ", earlier tree"
    row_cmp = {
        "rank_local_energy": lambda: rank_local_energy(*r5_args),
        rcomp: lambda: composition5(offdiag_h_terms, rank_ratio_rowsum),
        "sorted_quadratic_energy": lambda: sorted_quadratic_energy(*sq_args),
        qcomp: lambda: _quad_loop(le, dt4, sort_gather4, offdiag_h_terms, batch4.states,
                                  la_q4, ph_q4, nv4q, chunk4),
        quad_n2: lambda: le.quadratic_energy(dt4, batch4.states, la4, ph4, batch4.n_unique),
        "rank_quadratic_energy": lambda: rank_quadratic_energy(*rq_args),
        hcomp: lambda: _quad_loop(le, dt_rank_noa, rank_gather_h, offdiag_h_terms,
                                  batch.states, la_qh, ph_qh, nv_h, chunk),
        quad_h2o: lambda: le.quadratic_energy(dt_rank_noa, batch.states, la, ph,
                                              batch.n_unique),
        quad_h2o_a: lambda: le.quadratic_energy(dt, batch.states, la, ph, batch.n_unique),
    }
    if "dyn_gather" in old_mods:
        old_le, old_dg, old_oh = (old_mods[k] for k in ("local_energy", "dyn_gather",
                                                        "offdiag_h"))
        comp5_old = composition5(old_oh.offdiag_h_terms, old_dg.rank_ratio_rowsum)
        d5_old = [(e5[0] - diag5 - comp5_old[0].double()).abs()[:nu5],
                  (e5[1] - comp5_old[1].double()).abs()[:nu5]]
        q_old = [float(old_le.quadratic_energy(dt4, batch4.states, la4, ph4, batch4.n_unique)),
                 float(old_le.quadratic_energy(dt_rank_noa, batch.states, la, ph,
                                               batch.n_unique))]
        old_ok = (all(bool((d <= comp5_tol[:nu5]).all()) for d in d5_old)
                  and abs(q_old[0] - q_sq) <= QUAD_RTOL * abs(q_old[0])
                  and abs(q_old[1] - q_rq) <= QUAD_RTOL * abs(q_old[1]))
        print(f"[before] the earlier tree's rank chunk loop composed over {len(chunks5)} chunks "
              f"vs rank_local_energy on the live rows {max(float(d.max()) for d in d5_old):.3e} "
              f"Ha; its quadratic_energy on N2 6-31G {q_old[0]:.10f}, on H2O 6-31G with no "
              f"dense A {q_old[1]:.10f}; within={old_ok}", flush=True)
        if not old_ok:
            raise SystemExit("the earlier tree's chunk loops disagree with the one-launch "
                             "kernels")
        row_cmp[rcomp + old_tag] = lambda: composition5(old_oh.offdiag_h_terms,
                                                        old_dg.rank_ratio_rowsum)
        row_cmp[quad_n2 + old_tag] = lambda: old_le.quadratic_energy(
            dt4, batch4.states, la4, ph4, batch4.n_unique)
        row_cmp[quad_h2o + old_tag] = lambda: old_le.quadratic_energy(
            dt_rank_noa, batch.states, la, ph, batch.n_unique)
    row_times = time_in_turns(row_cmp, SLOW_REPEATS, 1)
    row_calls = time_in_turns(row_cmp, SLOW_REPEATS, 1, hold=False)
    # the plain versions (seconds a call): the wall time of their one call above
    for name, ms in (("rank_local_energy_ref", e5_plain_ms),
                     ("sorted_quadratic_energy_ref", sq_plain_ms),
                     ("rank_quadratic_energy_ref", rq_plain_ms)):
        times[name] = (ms, [ms, ms], 0.0)
    for n in row_cmp:
        if n not in row_fns:
            times[n], calls[n] = row_times[n], row_calls[n]
    check_hold([n for n in row_cmp if n not in row_fns], 1, calls)
    fc_fns = {le_fc: lambda: le.local_energy(dt5, batch5.states, la5, ph5, batch5.n_unique)}
    if "local_energy" in old_mods:
        fc_fns[le_fc + old_tag] = lambda: old_mods["local_energy"].local_energy(
            dt5, batch5.states, la5, ph5, batch5.n_unique)
    fc_e2e = time_in_turns(fc_fns, SLOW_REPEATS, 1, hold=False)
    calls.update(fc_e2e)
    e2e.update(fc_e2e)
    print(f"[time] {REPEATS} repeats of {LAUNCHES} launches ({SLOW_REPEATS} of "
          f"{SLOW_LAUNCHES} for the factored and staircase kernels, the grid kernels' plain "
          f"versions, "
          f"local_energy, the split's and the shell step's plain versions, the split of "
          f"before and sample()), the "
          f"functions in turns; held: behind a card sleep of twice the function's unheld run "
          f"(at least {HOLD_CYCLES} cycles), so the launches run back to back (the card's "
          f"time); unheld: a plain loop (the host's rate where that is slower)", flush=True)
    for name, (med, spread, held) in times.items():
        unheld = (f"; unheld median {calls[name][0]:.4f} ms, spread {calls[name][1][0]:.4f}-"
                  f"{calls[name][1][1]:.4f} ms" if name in calls else "")
        print(f"[time] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms{unheld}", flush=True)
    print(f"[time] the sort engine's kernels, plain versions and library calls: {REPEATS} "
          f"repeats of {SORT_LAUNCHES} launches in turns, held and unheld; one whole "
          f"local_energy call: "
          f"{SLOW_REPEATS} repeats of 1, unheld (the host's side included)", flush=True)
    for name, (med, spread, _) in e2e.items():
        print(f"[time] {name}: unheld median {med:.2f} ms, spread {spread[0]:.2f}-"
              f"{spread[1]:.2f} ms", flush=True)
    print(f"[time] sorted_local_energy in turns with the {len(chunks4)}-chunk compositions and "
          f"its plain version: {SLOW_REPEATS} repeats of 1, held and unheld", flush=True)
    for name, (med, spread, held) in comp_times.items():
        print(f"[time] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms; unheld median {comp_calls[name][0]:.4f} "
              f"ms, spread {comp_calls[name][1][0]:.4f}-{comp_calls[name][1][1]:.4f} ms",
              flush=True)
    print(f"[time] the one-launch kernels of the spaces with no dense A in turns with the chunk "
          f"loops they replaced and whole quadratic_energy calls: {SLOW_REPEATS} repeats of 1, "
          f"held and unheld (their plain versions: the wall time of one call, between two "
          f"synchronizes, above)", flush=True)
    for name, (med, spread, held) in row_times.items():
        print(f"[time] {name}: held ({held:.1f} ms) median {med:.4f} ms, spread "
              f"{spread[0]:.4f}-{spread[1]:.4f} ms; unheld median {row_calls[name][0]:.4f} "
              f"ms, spread {row_calls[name][1][0]:.4f}-{row_calls[name][1][1]:.4f} ms",
              flush=True)
    check_hold(fast, LAUNCHES, calls)
    head = s.numel() * 8 + xy.numel() * 8 + n_rows * 8
    g_bytes = head + 2 * n_el * 4
    g_bound = _bound(g_bytes, n_el * RANK_OPS)
    r_bytes = head + h.numel() * 4 + 2 * chunk * 4 + 2 * chunk * 4
    r_ops = n_el * RANK_OPS + n_found * EPILOGUE_OPS
    r_bound = _bound(r_bytes, r_ops)
    f_bound, d_bound = _bound(f_work["bytes"], f_work["ops"]), _bound(d_bytes, d_ops)
    x_dense = _bound(x_bytes, x_ops)
    x_bound = _bound(x_work["bytes"], x_work["ops"])
    print(f"[bound] rank_gather2 {g_bound[0]:.5f} ms ({g_bound[1]}: {g_bytes} B = s, xy, "
          f"{n_rows} touched table rows x 8 B, outputs 2 x {n_el} x 4 B; "
          f"{n_el * RANK_OPS} ops)", flush=True)
    print(f"[bound] rank_ratio_rowsum {r_bound[0]:.5f} ms ({r_bound[1]}: {r_bytes} B = s, xy, "
          f"{n_rows} touched rows x 8 B, h {h.numel() * 4} B, my_la, my_ph, outputs "
          f"{2 * chunk * 4} B; {r_ops} ops of which {3 * n_found} transcendentals on the "
          f"{n_found} found elements, {3 * n_el} if every element counted)", flush=True)
    fw = f_work
    print(f"[bound] factored_cells_accumulate {f_bound[0]:.5f} ms ({f_bound[1]} set it: "
          f"{fw['ops']} operations = 4 x {fw['valid_pairs']} valid (mask, live cell) pairs + "
          f"2 x {fw['factors']} factors + 4 x {fw['found_pairs']} found pairs, "
          f"{fw['ops'] / H100_FP32_OPS_PER_S * 1e3:.5f} ms; {fw['bytes']} B = the image rows "
          f"of the {fw['distinct_ra']} distinct ra and {fw['distinct_rb']} distinct rb of the "
          f"{fw['live']} live cells, (ga, gb) of {fw['masks']} masks, the factor slots of the "
          f"masks of found pairs, the {fw['grid_cells']} grid cells the valid pairs read, idx "
          f"and the output, {fw['bytes'] / H100_BYTES_PER_S * 1e3:.5f} ms)", flush=True)
    print(f"[bound] xl_grid_accumulate {x_bound[0]:.5f} ms on the sampled grid ({x_bound[1]}: "
          f"{x_work['bytes']} B = the {x_touched} grid cells the valid pairs read x 8 B, every "
          f"map, word table and the program once and the {xl.n_cells} packed cells written, "
          f"{x_work['bytes'] / H100_BYTES_PER_S * 1e3:.5f} ms; {x_work['ops']} operations = "
          f"one a grid cell, one a listed entry or probe ({x_work['listed']} + "
          f"{x_work['probed']}), 4 a set pair ({x_work['set_pairs']}) and 2 a factor of a set "
          f"pair ({x_work['factors']}), {x_work['ops'] / H100_FP32_OPS_PER_S * 1e3:.5f} ms)",
          flush=True)
    print(f"[bound] xl_grid_accumulate dense count (every valid pair): "
          f"{x_dense[0]:.5f} ms ({x_dense[1]}: {x_ops} float32 operations = 2 x {x_macs} "
          f"multiply-adds for H + 4 x {x_pairs} valid pairs, "
          f"{x_ops / H100_FP32_OPS_PER_S * 1e3:.5f} ms; {x_bytes} B = the {x_touched} grid cells "
          f"the valid pairs read x 8 B, the maps, factor lists and word tables, the par_a / "
          f"par_b columns the programs read and the {xl.n_cells} packed cells written, "
          f"{x_bytes / H100_BYTES_PER_S * 1e3:.5f} ms)", flush=True)
    print(f"[bound] dense_grid_accumulate {d_bound[0]:.5f} ms ({d_bound[1]}: {d_bytes} B = "
          f"h_dense {d_h['sectors']} B (the 32-byte sectors that hold the {d_pairs} valid "
          f"pairs of the masks that are not padding; its rows with a valid beta image "
          f"{d_h['rows']} B, the whole tensor {d_h['whole']} B) + the maps, the grid and the "
          f"output once {d_bytes - d_h['sectors']} B; {d_ops} float32 operations)", flush=True)

    # the sort engine's kernels on N2 6-31G's chunk: each input read once (of the
    # table the keys of the n_valid live states and la and ph of the distinct rows
    # found, as the rank kernels' bound counts the rows they touch; the SENTINEL
    # padding beyond n_valid is never read), each output written once; per coupled state
    # the xor, SEARCH_OPS per level of the search and the equality test, per found
    # state the epilogue's operations; per term and row of the H row an and, a
    # popcount, a sign flip and an add
    n_q4 = s4.numel() * xy4.numel()
    tab_bytes = n_live4 * 8 + n_rows4 * 8
    head4 = s4.numel() * 8 + xy4.numel() * 8 + tab_bytes + 8
    search_ops = n_q4 * (2 + SEARCH_OPS * n_levels4)
    sr_bytes = head4 + h4.numel() * 4 + 4 * chunk4 * 4
    sr_bound = _bound(sr_bytes, search_ops + n_found4 * EPILOGUE_OPS)
    sg_bytes = head4 + chunk4 + 2 * n_q4 * 4
    sg_bound = _bound(sg_bytes, search_ops)
    oh_bytes = (s4.numel() * 8 + dt4.yz_unique.numel() * 8 + dt4.xy_ptr.numel() * 4
                + dt4.term_yz.numel() * 8 + h4.numel() * 4)
    oh_ops = chunk4 * dt4.term_yz.numel() * 4
    oh_bound = _bound(oh_bytes, oh_ops)
    print(f"[bound] sorted_ratio_rowsum {sr_bound[0]:.5f} ms ({sr_bound[1]}: {sr_bytes} B = h "
          f"{h4.numel() * 4} B, the table {tab_bytes} B = {n_live4} live keys x 8 B + la, ph "
          f"of the {n_rows4} distinct rows found x 8 B, s, xy, my_la, my_ph, outputs; "
          f"{search_ops + n_found4 * EPILOGUE_OPS} operations = {n_q4} coupled states x (2 + "
          f"{SEARCH_OPS} x {n_levels4} levels) + {n_found4} found x {EPILOGUE_OPS})", flush=True)
    print(f"[bound] sorted_gather2 {sg_bound[0]:.5f} ms ({sg_bound[1]}: {sg_bytes} B = outputs "
          f"{2 * n_q4 * 4} B, the table's live keys and found rows, s, xy, live; {search_ops} "
          f"operations)", flush=True)
    # sorted_local_energy on the N2 call, counted over the live rows (a padding row's
    # result is known in advance): per coupled state of a flip mask with terms the xor
    # and SEARCH_OPS per level, per found pair 3 per term of its group and the
    # epilogue, 3 per diagonal term; each input read once (of the table the live keys
    # and la, ph of the rows found; the terms of the groups walked), each output
    # written once
    n_real4 = int(real4.sum())
    le_ops = (n_live4 * n_real4 * (1 + SEARCH_OPS * n_levels4) + 3 * n_found_terms
              + EPILOGUE_OPS * n_found_pairs + 3 * n_live4 * dt4.diag_yz.numel())
    le_bytes = (n_live4 * 8 + n_found_rows * 8 + xy4.numel() * 12 + n_found_terms * 16
                + dt4.diag_yz.numel() * 16 + cap4 * 8 + n_live4 * 8 + cap4 * 16)
    le_bound = _bound(le_bytes, le_ops)
    print(f"[bound] sorted_local_energy {le_bound[0]:.5f} ms ({le_bound[1]}: {le_ops} "
          f"operations = {n_live4} live rows x {n_real4} flip masks with terms x (1 + "
          f"{SEARCH_OPS} x {n_levels4} levels) + 3 x {n_found_terms} terms of the "
          f"{n_found_pairs} found pairs + {EPILOGUE_OPS} a found pair + 3 x "
          f"{dt4.diag_yz.numel()} diagonal terms a live row, "
          f"{le_ops / H100_FP32_OPS_PER_S * 1e3:.5f} ms; {le_bytes} B = the live keys, la and "
          f"ph of the {n_found_rows} rows found, xy and xy_ptr, the walked terms, the "
          f"diagonal terms, the query rows and the outputs, "
          f"{le_bytes / H100_BYTES_PER_S * 1e3:.5f} ms)", flush=True)
    print(f"[bound] offdiag_h_terms {oh_bound[0]:.5f} ms ({oh_bound[1]}: {oh_bytes} B = h "
          f"{h4.numel() * 4} B, the grouped terms, yz_unique, xy_ptr, s; {oh_ops} integer and "
          f"float32 operations = {chunk4} rows x {dt4.term_yz.numel()} terms x 4)", flush=True)
    # the one-launch kernels with no dense A, counted over their live rows (a
    # row not walked costs a load and two stores, in the bytes): rank_local_energy on
    # the frozen-core N2 call, per pair with terms SECTOR_OPS, per pair inside a
    # sector RANK_OPS and its table row (8 B, each distinct row once; at 153 MB the
    # table is out of L2, so these are HBM reads); rank_quadratic_energy the same on
    # H2O 6-31G's batch; sorted_quadratic_energy on N2 6-31G's, as sorted_local_energy
    rle_bound, rle_ops, rle_bytes = _row_bound(
        work5, nu5, cap5, dt5.xy_unique.numel(), dt5.term_yz.numel(), dt5.diag_yz.numel(),
        work5["pairs"] * SECTOR_OPS + work5["inside"] * RANK_OPS, work5["rows"] * 8)
    rq_bound, rq_ops, rq_bytes = _row_bound(
        work_rq, nu, batch.states.shape[0], dt.xy_unique.numel(), dt.term_yz.numel(),
        dt.diag_yz.numel(),
        work_rq["pairs"] * SECTOR_OPS + work_rq["inside"] * RANK_OPS, work_rq["rows"] * 8)
    n_levels_q4 = max(math.ceil(math.log2(max(nu4, 1))), 0)
    sq_bound, sq_ops, sq_bytes = _row_bound(
        work_sq, nu4, cap4, xy4.numel(), dt4.term_yz.numel(), dt4.diag_yz.numel(),
        work_sq["pairs"] * (1 + SEARCH_OPS * n_levels_q4), nu4 * 8 + work_sq["rows"] * 8)
    for name, (bd, ops, n_bytes), wk, look in (
            ("rank_local_energy", (rle_bound, rle_ops, rle_bytes), work5,
             f"{SECTOR_OPS} a pair + {RANK_OPS} a pair inside a sector"),
            ("rank_quadratic_energy", (rq_bound, rq_ops, rq_bytes), work_rq,
             f"{SECTOR_OPS} a pair + {RANK_OPS} a pair inside a sector"),
            ("sorted_quadratic_energy", (sq_bound, sq_ops, sq_bytes), work_sq,
             f"1 + {SEARCH_OPS} x {n_levels_q4} levels a pair")):
        print(f"[bound] {name} {bd[0]:.5f} ms ({bd[1]}: {ops} operations = {look} over "
              f"{wk['pairs']} live (row, flip mask with terms) pairs"
              f"{' of which ' + str(wk['inside']) + ' inside a sector' if 'inside' in wk else ''}"
              f", 3 x {wk['terms']} terms of the {wk['found']} found pairs + {EPILOGUE_OPS} a "
              f"found pair + 3 a diagonal term of a live row, "
              f"{ops / H100_FP32_OPS_PER_S * 1e3:.5f} ms; {n_bytes} B = the {wk['rows']} distinct "
              f"table rows read x 8 B{' and the live keys' if name.startswith('sorted') else ''}, "
              f"xy and xy_ptr, the grouped terms walked (at most all), the diagonal terms, the "
              f"rows and the outputs, "
              f"{n_bytes / H100_BYTES_PER_S * 1e3:.5f} ms)", flush=True)

    # the sampler's kernels: a dead row reads its count and its flag and writes zeros; a
    # live row also reads its probs, mask and six draws. The compaction reads the flags,
    # a and b of the rows with a valid child and each kept child's weight, and writes
    # every slot of the four outputs.
    st = fullest_stats
    p_size = s_probs.element_size() * 4
    sp_bytes = cap * (8 + 1 + 32 + 4) + fullest_live * (p_size + 4 + 24)
    sp_f64, sp_f32 = _split_ops(fullest_live, st)
    sp_ops_ms = (sp_f64 / H100_FP64_OPS_PER_S + sp_f32 / H100_FP32_OPS_PER_S) * 1e3
    sp_bytes_ms = sp_bytes / H100_BYTES_PER_S * 1e3
    sp_bound = (max(sp_bytes_ms, sp_ops_ms), "bytes" if sp_bytes_ms >= sp_ops_ms else "operations")
    flags = compact_args[3]
    n_parents, n_kids = int(flags.any(-1).sum()), int(flags.sum())
    cp_bytes = cap * 4 + n_parents * 16 + min(n_kids, cap) * 8 + cap * (24 + 1) + 8
    cp_bound = _bound(cp_bytes, cap * COMPACT_ROW_OPS)
    # the fused step reads the previous count, the count and flag of the rows below
    # it, the split's other inputs of the live rows and the parents' prefix bits, and
    # writes the compaction's outputs; the split's outputs never reach device memory.
    # The earlier design's count read the count and flag of every row.
    n_gate = min(int(step_args[10]), cap)
    fu_bytes = (8 + n_gate * (8 + 1) + fullest_live * (p_size + 4 + 24) + n_parents * 16
                + cap * 25 + 8)
    fu_ops_ms = sp_ops_ms + n_gate * COMPACT_ROW_OPS / H100_FP32_OPS_PER_S * 1e3
    fu_bytes_ms = fu_bytes / H100_BYTES_PER_S * 1e3
    fu_bound = (max(fu_bytes_ms, fu_ops_ms), "bytes" if fu_bytes_ms >= fu_ops_ms else "operations")
    fu_every = (cap * (8 + 1) + fullest_live * (p_size + 4 + 24) + n_parents * 16 + cap * 25
                + 8) / H100_BYTES_PER_S * 1e3
    print(f"[bound] multinomial4_split {sp_bound[0]:.5f} ms ({sp_bound[1]}: {sp_bytes} B = "
          f"{cap} rows x 45 B (count, flag, outputs) + {fullest_live} live rows x "
          f"{p_size + 28} B (probs, mask, six draws); {sp_f64} float64 operations at "
          f"{H100_FP64_OPS_PER_S:.3g}/s + {sp_f32} float32 operations ({st['gauss']} Gaussian "
          f"and {st['cdf']} inverse-CDF binomials, {st['cdf_steps']} looks; instructions a "
          f"division, log1p, sqrt or expf takes: {SASS_OPS}): {sp_ops_ms:.5f} ms)", flush=True)
    print(f"[bound] compact_children {cp_bound[0]:.5f} ms ({cp_bound[1]}: {cp_bytes} B = flags "
          f"{cap * 4} B, a and b of {n_parents} parents, {min(n_kids, cap)} weights, four "
          f"outputs {cap * 25} B; {cap * COMPACT_ROW_OPS} integer operations)", flush=True)
    print(f"[bound] split_and_compact {fu_bound[0]:.5f} ms ({fu_bound[1]}: {fu_bytes} B = "
          f"the previous count + the {n_gate} rows below it x 9 B (count, flag) + "
          f"{fullest_live} live rows x {p_size + 28} B (probs, mask, six draws) + a and b of "
          f"{n_parents} parents + four outputs {cap * 25 + 8} B, {fu_bytes_ms:.5f} ms; the "
          f"split's operations and {n_gate * COMPACT_ROW_OPS} integer operations: "
          f"{fu_ops_ms:.5f} ms); the earlier count over the count and flag of all {cap} rows "
          f"{fu_every:.5f} ms", flush=True)

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        kernel_of = {"split_and_compact_kernel": _split_and_compact,
                     "compact_children_kernel": _compact_children,
                     "multinomial4_split_kernel": multinomial4_split,
                     "factored_cells_kernel": factored_cells_accumulate,
                     "rank_ratio_rowsum_kernel": rank_ratio_rowsum,
                     "xl_grid_accumulate_kernel": xl_grid_accumulate,
                     "sorted_ratio_rowsum_kernel": sorted_ratio_rowsum,
                     "sorted_gather2_kernel": sorted_gather2,
                     "offdiag_h_terms_kernel": offdiag_h_terms,
                     "SearchLookup, row_energy::LocalEnergy": sorted_local_energy,
                     "RankLookup, row_energy::LocalEnergy": rank_local_energy,
                     "SearchLookup, row_energy::Quadratic": sorted_quadratic_energy,
                     "RankLookup, row_energy::Quadratic": rank_quadratic_energy}
        xl_dt = tr3.dt
        for label, trainer, terms_dev in (("factored", tr, dt), ("rank", tr, dt_rank),
                                          ("staircase (Li2O CISDTQ)", tr3, xl_dt),
                                          ("sort (N2 6-31G)", tr4, dt4),
                                          ("rank, no A (frozen-core N2 6-31G)", tr5, dt5)):
            trainer.dt = terms_dev
            for name, step in (("sample", trainer._sample), ("step", trainer.step)):
                torch.cuda.synchronize()
                t = time.time()
                step()
                torch.cuda.synchronize()
                wall = time.time() - t
                print(f"[profile] {label} {name}: {wall:.3f} s", flush=True)
            zero_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.step()
                torch.cuda.synchronize()
            events = prof.key_averages()
            seen = {name: sum(e.count for e in events if e.device_type == DeviceType.CUDA
                              and name in e.key) for name in kernel_of}
            launched = {name: w.launches for name, w in kernel_of.items()}
            print(f"[profile] {label}: device kernels {seen}, wrapper calls {launched}",
                  flush=True)
            if seen != launched or not launched["split_and_compact_kernel"]:
                raise SystemExit(f"the {label} step's device kernels are not one per wrapper "
                                 f"call")
            print(f"[profile] one step on the {label} path", flush=True)
            print(events.table(sort_by="cuda_time_total", row_limit=25), flush=True)
            total = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
            print(f"[profile] {label}: {total / 1e3:.1f} ms device time in the step; the step "
                  f"before it (not profiled) took {wall:.3f} s of wall time: the card busy "
                  f"{total / 1e6 / wall:.0%} of it", flush=True)
            for e in events:
                if any(k in e.key for k in ("rank_", "grid_accumulate", "factored_cells",
                                            "multinomial4_split",
                                            "compact_children", "split_and_compact", "cumsum",
                                            "cumprod", "sorted_", "offdiag_h",
                                            "row_energy")) \
                        and e.self_device_time_total > 0:
                    print(f"[profile] {label} {e.key}: {e.count} launches, "
                          f"{e.self_device_time_total / 1e3:.3f} ms device time, "
                          f"{e.self_device_time_total / e.count:.2f} us each", flush=True)
        tr.dt = dt
        tr3.dt = xl_dt

    # 12. the trainer's extras at the paper width on H2O 6-31G
    extras = _trainer_extras(dev, mol, hil, terms, cfg, tr2, zero_counts, wrappers)

    # 13. the CLI at the paper's width
    cli_counts = _cli_runs(zero_counts, wrappers, t_fact, t_dense)

    # 14. exact mode at the paper width, then the CLI's run C (-exact_sampling)
    print(f"[exact] phase 14 starts with {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"device memory allocated", flush=True)
    exact = _exact_mode(dev, hil, terms, cfg, tc, (hil3, terms3, cfg3), x_touched, zero_counts,
                        wrappers)
    cli_counts["C"], cli_c = _cli_run_c(zero_counts, wrappers)
    exact_extra = _exact_entries(exact, cli_c, d_bound)

    # 15. the natural-gradient optimizers at the paper width, and run D
    print(f"[natgrad] phase 15 starts with {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"device memory allocated", flush=True)
    t15 = time.time()
    natgrad = _natgrad(dev, hil, terms, cfg, tc, zero_counts, wrappers)
    print(f"[natgrad] phase 15: {time.time() - t15:.1f} s in all", flush=True)

    # 16. data parallelism at the paper width
    t16 = time.time()
    sharded = _sharded(dev, hil, terms, cfg, tc, zero_counts, wrappers, smi)
    print(f"[sharded] phase 16: {time.time() - t16:.1f} s in all", flush=True)

    def entry(name, launches, err, t_plain, bound, t_library,
              source="naqs_tpu_torch/csrc/rank_gather.cu",
              replaces="naqs_tpu/ops/dyn_gather.py:83", **more):
        fast_keys = {"unheld_ms": calls[name][0]} if name in calls else {}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": times[name][0],
                "spread": times[name][1], **fast_keys, "plain_ms": times[t_plain][0],
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": times[t_library][0] if t_library else None, **more}

    def before(name):
        """the earlier tree's time of a kernel, timed in turns with this tree's"""
        return {"before_ms": times[name][0], "before_spread": times[name][1]} \
            if name in times else {}

    unfused = "rank_gather2 + eager epilogue"
    no_call = "no single PyTorch call computes the gather by two static maps fused with " \
              "the sum over masks"
    kernels = [
        entry("rank_gather2", gather_launches, gather_err, "rank_gather2_ref", g_bound,
              "tab[idx]",
              library_note="tab[idx] on a precomputed idx: skips the rank arithmetic",
              launches_exact_energy=extras["gather_launches_exact_energy"],
              launches_dense_a_loop=loop_counts["rank_gather2"],
              dense_a_loop_ms=dense_times[qloop_ra][0],
              dense_a_loop_unheld_ms=dense_calls[qloop_ra][0],
              path_note="superseded where A is dense too: no path launches it (launches: "
                        "quadratic_energy on the rank engine with its dense A, phase 8; "
                        "launches_exact_energy: exact_energy(), phase 12); held here on a real "
                        "chunk; dense_a_loop_ms: the chunk loop it ran there before (it, P @ A "
                        "and the eager epilogue per chunk, launches_dense_a_loop launches), in "
                        "turns with rank_quadratic_energy's one launch",
              **before(old_name)),
        entry("rank_ratio_rowsum", ratio_launches, rowsum_err, "rank_ratio_rowsum_ref",
              r_bound, None,
              library_note="no single PyTorch call computes the fused gather, ratio and "
                           "row sum",
              unfused_ms=times[unfused][0], unfused_spread=times[unfused][1],
              **({"before_composition_ms": times[f"{old_name} + eager epilogue"][0]}
                 if old_name in times else {}),
              launches_dense_a_loop=loop_counts["rank_ratio_rowsum"],
              dense_a_loop_ms=dense_times[loop_ra][0],
              dense_a_loop_unheld_ms=dense_calls[loop_ra][0],
              path_note="superseded where A is dense too: no path launches it (launches: the "
                        "rank engine's training steps with the dense A, phase 7); held here on "
                        "a real chunk; dense_a_loop_ms: the chunk loop it ran there before (P @ "
                        "A and this kernel per chunk, launches_dense_a_loop launches), in turns "
                        "with rank_local_energy's one launch"),
        entry("factored_cells_accumulate", fact_launches, factored_err,
              "factored_cells_accumulate_ref", f_bound, None,
              replaces="naqs_tpu/ops/dense_engine.py:496-540", library_note=no_call,
              **before(old_fact), **{k: f_work[k] for k in ("live", "valid_pairs",
                                                            "found_pairs", "factors")},
              local_energy_ms=times[fle_name][0],
              **({"local_energy_before_ms": times[old_fle][0]} if old_fle in times else {}),
              **GRID_SRC),
        entry("dense_grid_accumulate", dense_launches, dense_err, "dense_grid_accumulate_ref",
              d_bound, None, replaces="naqs_tpu/ops/dense_engine.py:279",
              library_note=no_call, **before(old_dense), **GRID_SRC),
        entry("xl_grid_accumulate", xl_launches, xl_err, "xl_grid_accumulate_ref", x_bound,
              None, replaces="naqs_tpu/ops/dense_engine.py:877", library_note=no_call,
              dense_bound_ms=x_dense[0], set_pairs=x_work["set_pairs"],
              set_pair_share=x_work["set_pairs"] / x_pairs,
              full_grid_ms=times["xl_grid_accumulate (full grid)"][0],
              staircase_grid_ms=times["xl_grid_accumulate (staircase grid)"][0],
              local_energy_ms=times["local_energy (FactorTermsXL, Li2O)"][0],
              rank_local_energy_ms=times["local_energy (rank engine, Li2O)"][0],
              **({"before_full_grid_ms": times[f"{old_xl} (full grid)"][0],
                  "before_staircase_grid_ms": times[f"{old_xl} (staircase grid)"][0]}
                 if f"{old_xl} (full grid)" in times else {}),
              **before(old_xl), **GRID_SRC),
        entry("sorted_local_energy", energy_launches, eloc_err4, e_plain_name, le_bound, None,
              source="naqs_tpu_torch/csrc/sort_lookup.cu",
              replaces="naqs_tpu/ops/local_energy.py:183 + :209 + :164",
              library_note="none: no single call computes the search, the per-group H and "
                           "the row sum",
              path_note="N2 6-31G (36 qubits, no RankSpec, no dense A): one launch per "
                        "training step's E_loc call",
              **before(e_comp_old), composition_ms=times[e_comp][0],
              **({"kernel_before_ms": times[e_old][0], "kernel_before_spread": times[e_old][1]}
                 if e_old in times else {}),
              composition_unheld_ms=calls[e_comp][0],
              in_turns_with_compositions_ms=comp_times[e_name][0],
              found_pairs=n_found_pairs, live_rows=n_live4,
              dense_a_call_ms=dense_times[le_sa][0], dense_a_call_unheld_ms=dense_calls[le_sa][0],
              **({"dense_a_call_before_ms": dense_times[le_sa + ", earlier tree"][0],
                  "dense_a_call_before_unheld_ms": dense_calls[le_sa + ", earlier tree"][0]}
                 if le_sa + ", earlier tree" in dense_times else {}),
              launches_dense_a_steps=sort_a_counts["sorted_local_energy"],
              dense_a_step_s=t_sort, dense_a_step_device_ms=sort_a_device,
              local_energy_ms=calls[le_name][0],
              **({"local_energy_before_ms": calls[le_old][0]} if le_old in calls else {})),
        entry("sorted_ratio_rowsum", sort_launches, ratio_err4, "sorted_ratio_rowsum_ref",
              sr_bound, "searchsorted + gather", source="naqs_tpu_torch/csrc/sort_lookup.cu",
              replaces="naqs_tpu/ops/local_energy.py:183",
              library_note="torch.searchsorted of the (C, K) coupled states and two gathers: no "
                           "found test, ratio or row sum",
              launches_dense_a_call=h2o_counts["sorted_ratio_rowsum"],
              launches_dense_a_steps=sort_a_counts["sorted_ratio_rowsum"],
              dense_a_loop_ms=dense_times[loop_sa][0],
              dense_a_loop_unheld_ms=dense_calls[loop_sa][0],
              path_note="superseded where A is dense too: no path launches it "
                        "(launches: N2 6-31G's training steps; launches_dense_a_call: the H2O "
                        "6-31G call on the sort engine with its dense A, phase 10c; "
                        "launches_dense_a_steps: that engine's steps, phase 7b); held here on a "
                        "real chunk; dense_a_loop_ms: the chunk loop it ran there before (P @ A "
                        "and this kernel per chunk), in turns with sorted_local_energy"),
        entry("sorted_gather2", quad_launches, gather_err4, "sorted_gather2_ref", sg_bound,
              "searchsorted + gather", source="naqs_tpu_torch/csrc/sort_lookup.cu",
              replaces="naqs_tpu/ops/local_energy.py:363",
              library_note="torch.searchsorted of the (C, K) coupled states and two gathers: no "
                           "found test or live mask",
              launches_dense_a_call=h2o_counts["sorted_gather2"],
              dense_a_loop_ms=dense_times[qloop_sa][0],
              dense_a_loop_unheld_ms=dense_calls[qloop_sa][0],
              path_note="superseded by sorted_quadratic_energy, where there is no dense A "
                        "and where A is dense too: no path launches it (launches: "
                        "N2 6-31G's quadratic_energy; launches_dense_a_call: the H2O 6-31G call "
                        "on the sort engine with its dense A, phase 10c); held here on a real "
                        "chunk; dense_a_loop_ms: the chunk loop it ran there before, in turns "
                        "with sorted_quadratic_energy"),
        entry("offdiag_h_terms", offdiag_launches, offdiag_err, "offdiag_h_terms_ref", oh_bound,
              "index_add (precomputed products)", source="naqs_tpu_torch/csrc/offdiag_h.cu",
              replaces="naqs_tpu/ops/local_energy.py:209",
              library_note="Tensor.index_add of the (C, K) products computed beforehand: the "
                           "segment sum alone",
              launches_quadratic_energy=quad4_counts["offdiag_h_terms"],
              launches_frozen_core_steps=fc_counts["offdiag_h_terms"],
              path_note="superseded by rank_local_energy, sorted_local_energy, "
                        "sorted_quadratic_energy and rank_quadratic_energy, which sum H only "
                        "for found pairs: no path launches it (launches: N2 6-31G's steps; "
                        "launches_quadratic_energy: its quadratic_energy call; "
                        "launches_frozen_core_steps: the frozen-core N2 steps); held here on a "
                        "real chunk"),
        entry("rank_local_energy", fc_launches, eloc_err5, "rank_local_energy_ref", rle_bound,
              None, replaces="naqs_tpu/ops/local_energy.py:216-247 + :209 + :164",
              library_note="none: no single call computes the rank lookup, the per-group H and "
                           "the row sum",
              path_note="frozen-core N2 6-31G (32 qubits, a RankSpec, no grid program, no "
                        "dense A): one launch per training step's E_loc call, where the "
                        "parent ran offdiag_h_terms + rank_ratio_rowsum per chunk",
              body="naqs_tpu_torch/csrc/row_energy.cuh", **before(rcomp + old_tag),
              composition_ms=times[rcomp][0], composition_unheld_ms=calls[rcomp][0],
              local_energy_ms=calls[le_fc][0],
              **({"local_energy_before_ms": calls[le_fc + old_tag][0]}
                 if le_fc + old_tag in calls else {}),
              live_rows=nu5, pairs=work5["pairs"], pairs_inside_sector=work5["inside"],
              table_rows_read=work5["rows"], found_pairs=work5["found"],
              h2o_call_ms=dense_times[le_rn][0], h2o_call_unheld_ms=dense_calls[le_rn][0],
              h2o_dense_a_call_ms=dense_times[le_ra][0],
              h2o_dense_a_call_unheld_ms=dense_calls[le_ra][0],
              **({"h2o_dense_a_call_before_ms": dense_times[le_ra + ", earlier tree"][0],
                  "h2o_dense_a_call_before_unheld_ms": dense_calls[le_ra + ", earlier tree"][0]}
                 if le_ra + ", earlier tree" in dense_times else {}),
              launches_dense_a_steps=rank_a_counts["rank_local_energy"],
              dense_a_step_s=t_rank),
        entry("rank_quadratic_energy", qrn_counts["rank_quadratic_energy"], rq_err,
              "rank_quadratic_energy_ref", rq_bound, None,
              replaces="naqs_tpu/ops/local_energy.py:330-381 + :209 + :164",
              library_note="none: no single call computes the rank lookup, the per-group H and "
                           "the symmetric row sum",
              path_note="quadratic_energy with a RankSpec, with a dense A or without: "
                        "one launch per call (launches: H2O 6-31G's batch with a_mat=None; "
                        "launches_dense_a_call: with its dense A, phase 8; "
                        "launches_exact_energy: exact_energy(), phase 12), where the chunk "
                        "loops ran rank_gather2 + offdiag_h_terms (no dense A) or rank_gather2 "
                        "+ P @ A (dense A) + an eager epilogue per chunk",
              launches_dense_a_call=quad_a_counts["rank_quadratic_energy"],
              launches_exact_energy=extras["quad_launches_exact_energy"],
              exact_energy_s=extras["exact_energy_s"],
              exact_energy_log_psi_s=extras["exact_energy_log_psi_s"],
              exact_energy_quadratic_s=extras["exact_energy_quadratic_s"],
              dense_a_loop_ms=dense_times[qloop_ra][0],
              dense_a_loop_unheld_ms=dense_calls[qloop_ra][0],
              **({"h2o_dense_a_call_before_ms": dense_times[quad_ra + ", earlier tree"][0],
                  "h2o_dense_a_call_before_unheld_ms":
                      dense_calls[quad_ra + ", earlier tree"][0]}
                 if quad_ra + ", earlier tree" in dense_times else {}),
              body="naqs_tpu_torch/csrc/row_energy.cuh", **before(quad_h2o + old_tag),
              composition_ms=times[hcomp][0], quadratic_energy_ms=times[quad_h2o][0],
              dense_a_quadratic_energy_ms=times[quad_h2o_a][0],
              h2o_in_turns_ms=dense_times[quad_rn][0],
              h2o_in_turns_unheld_ms=dense_calls[quad_rn][0],
              h2o_dense_a_in_turns_ms=dense_times[quad_ra][0],
              h2o_dense_a_in_turns_unheld_ms=dense_calls[quad_ra][0],
              live_rows=nu, pairs=work_rq["pairs"], pairs_inside_sector=work_rq["inside"],
              found_pairs=work_rq["found"]),
        entry("sorted_quadratic_energy", sq_launches, sq_err, "sorted_quadratic_energy_ref",
              sq_bound, None, source="naqs_tpu_torch/csrc/sort_lookup.cu",
              replaces="naqs_tpu/ops/local_energy.py:330-381 + :209 + :164",
              library_note="none: no single call computes the search, the per-group H and the "
                           "symmetric row sum",
              path_note="quadratic_energy with no RankSpec and no dense A (N2 6-31G): one "
                        "launch per call, where the parent ran sorted_gather2 + "
                        "offdiag_h_terms + an eager epilogue per chunk",
              body="naqs_tpu_torch/csrc/row_energy.cuh", **before(quad_n2 + old_tag),
              composition_ms=times[qcomp][0], quadratic_energy_ms=times[quad_n2][0],
              live_rows=nu4, pairs=work_sq["pairs"], found_pairs=work_sq["found"],
              dense_a_call_ms=dense_times[quad_sa][0],
              dense_a_call_unheld_ms=dense_calls[quad_sa][0],
              **({"dense_a_call_before_ms": dense_times[quad_sa + ", earlier tree"][0],
                  "dense_a_call_before_unheld_ms": dense_calls[quad_sa + ", earlier tree"][0]}
                 if quad_sa + ", earlier tree" in dense_times else {})),
        entry("split_and_compact", fused_launches, fused_totals["err"], "split_and_compact_ref",
              fu_bound, None,
              replaces="naqs_tpu/ops/multinomial.py:76 + naqs_tpu/sampler.py:49",
              library_note="no single PyTorch call computes the split and the compaction",
              two_kernel_ms=times[two_kernels][0], two_kernel_spread=times[two_kernels][1],
              two_kernel_unheld_ms=calls[two_kernels][0],
              sample_call_ms=times["sample() at capacity 100,000"][0],
              **({"sample_call_before_ms": times[old_sample][0]} if old_sample in times else {}),
              **before(old_fused),
              **({"before_two_kernel_ms": times[old_two][0]} if old_two in times else {}),
              registers=split_regs, clear_ms=times[clear_name][0],
              host_check_unheld_ms=host_calls["split_and_compact: check_tensors"][0],
              host_allocation_unheld_ms=host_calls["split_and_compact: its one allocation"][0],
              bound_ms_every_row=fu_every, graph_replays_bitwise=graph_same,
              **SHELL_SRC),
        entry("multinomial4_split", split_launches, totals["err"], "multinomial4_split_ref",
              sp_bound, "3 x torch.binomial", replaces="naqs_tpu/ops/multinomial.py:76",
              library_note="three torch.binomial calls on the cascade's (n, p): the same "
                           "distribution by another algorithm, without the mask",
              path_note="not on the main path: sample() runs split_and_compact, which does "
                        "this kernel's arithmetic (one device function)",
              cumprod_split_ms=times["(U, 127) cumprod/cumsum split"][0],
              rows_differing=totals["differ"],
              decomposition_ms={k.split(": ", 1)[-1]: v[0] for k, v in decomp.items()
                                if not k.startswith("earlier tree")},
              decomposition_before_ms={k.split(": ", 1)[1]: v[0] for k, v in decomp.items()
                                       if k.startswith("earlier tree")},
              decomposition_tally=decomp_tally, registers=split_alone_regs,
              division_proof={"pairs": n_pairs, "fast_div_pairs": proof[1],
                              "differ": proof[0], "seconds": t_proof},
              **SHELL_SRC),
        entry("compact_children", compact_launches, compact_totals["err"],
              "compact_children_ref", cp_bound, "masked_select(weights)",
              replaces="naqs_tpu/sampler.py:49",
              library_note="torch.masked_select of the weights: one of the three arrays, "
                           "no zero fill, no flags, no count",
              path_note="not on the main path: sample() runs split_and_compact; "
                        "sample_density launches this kernel",
              launches_sample_density=dens_launches,
              launches_run_density=extras["compact_launches_run_density"],
              run_density_steps=DENSITY_STEPS,
              run_density_sample_density_calls=extras["density_calls"],
              **before(old_compact), **SHELL_SRC),
    ]
    for k in kernels:  # phase 13's to 16's launches, each run counted from zero
        k["launches_cli_a"], k["launches_cli_b"], k["launches_cli_c"] = (
            cli_counts[r][k["name"]] for r in "ABC")
        k["launches_exact"] = exact["launches"][k["name"]]
        k["launches_natgrad"] = natgrad["launches"][k["name"]]
        k["launches_sharded"] = sharded["launches"][k["name"]]
        k.update(exact_extra.get(k["name"], {}))
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {smi}; total {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
