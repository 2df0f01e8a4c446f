"""The data-parallel drill that `chip_smoke.py` phase 16 runs on each rank.

`rank_run` is started on every rank by `naqs_tpu_torch.parallel.launch.spawn`
(two ranks sharing one card over gloo, or one rank a card over NCCL): a
`VMCTrainer(n_devices=D)` at the caller's configuration takes the planned
steps of each optimizer (Adam, SR, K-FAC: the trainer's step is rebuilt for
each), each step under torch.profiler, with every collective timed and its
bytes counted; then one fixed pair of batches (seeded per rank) goes through
one data-parallel Adam update, which is held against a one-process
composition over the merged rows (`composed_adam`), and rank 0 holds the
E_loc kernels of three engines against their plain versions at that pair's
merged table, where a state drawn on both ranks lies twice
(`repeated_keys`). It needs a CUDA card and imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from naqs_tpu_torch.models.nade import NADE, NAQSConfig, log_psi
from naqs_tpu_torch.ops.local_energy import local_energy
from naqs_tpu_torch.parallel import comm
from naqs_tpu_torch.parallel.multihost import rank_generator
from naqs_tpu_torch.parallel.step import merge_shards, sample_shard, sharded_adam_update
from naqs_tpu_torch.trainer import (TrainConfig, UpdateWindow, VMCTrainer, _grad_norm,
                                    _set_schedule)

# the fixed pair of batches: CHECK_SAMPLES samples over the ranks, each rank's
# share drawn by rank_generator(CHECK_SEED, rank)
CHECK_SAMPLES = 1e5
CHECK_SEED = 11


def wrappers():
    """The port's kernel wrappers, each counting its launches, in the three
    groups chip_smoke.py keeps: (the engines', sampler's and chemistry's
    kernels, whose launches a phase holds to 0 where it does not expect them;
    the model's glue, ops/nade_glue.py, which every step launches; the grid
    and rank engines' E_loc glue, ops/rank.py's rank_index and
    ops/grid_glue.py's grid_scatter and grid_readout, which every grid-engine
    and rank-engine call launches)."""
    from naqs_tpu_torch.ops.dyn_gather import (rank_gather2, rank_local_energy,
                                               rank_quadratic_energy, rank_ratio_rowsum)
    from naqs_tpu_torch.ops.grid_glue import grid_readout, grid_scatter
    from naqs_tpu_torch.ops.grid_kernels import (dense_grid_accumulate,
                                                 factored_cells_accumulate, xl_grid_accumulate)
    from naqs_tpu_torch.ops.multinomial import multinomial4_split
    from naqs_tpu_torch.ops.nade_glue import (shell_epilogue, shell_features, state_features,
                                              tables_epilogue, tables_epilogue_jvp,
                                              tables_epilogue_vjp)
    from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms
    from naqs_tpu_torch.ops.rank import rank_index
    from naqs_tpu_torch.ops.sort_lookup import (sorted_gather2, sorted_local_energy,
                                                sorted_quadratic_energy, sorted_ratio_rowsum)
    from naqs_tpu_torch.sampler import _compact_children, _split_and_compact
    from naqs_tpu_torch.chem.integrals import eri_tensor

    return ((rank_gather2, rank_ratio_rowsum, factored_cells_accumulate, dense_grid_accumulate,
             multinomial4_split, _compact_children, _split_and_compact, xl_grid_accumulate,
             sorted_ratio_rowsum, sorted_gather2, offdiag_h_terms, sorted_local_energy,
             rank_local_energy, rank_quadratic_energy, sorted_quadratic_energy, eri_tensor),
            (shell_features, shell_epilogue, state_features, tables_epilogue,
             tables_epilogue_vjp, tables_epilogue_jvp),
            (rank_index, grid_scatter, grid_readout))


class CollectiveClock:
    """Times every `torch.distributed.all_reduce` (the one collective of
    `parallel/comm.py`) on the host's clock, with the bytes it reduces, while
    installed. Over gloo a collective of card tensors stages them through the
    host and returns when done; over NCCL it returns once enqueued."""

    def __init__(self):
        self.calls, self.seconds, self.bytes = 0, 0.0, 0
        self._orig = None

    def __enter__(self):
        self._orig = dist.all_reduce

        def timed(t, *args, **kw):
            t0 = time.perf_counter()
            out = self._orig(t, *args, **kw)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig

    def take(self) -> dict:
        out = {"collectives": self.calls, "collective_s": self.seconds,
               "collective_bytes": self.bytes}
        self.calls, self.seconds, self.bytes = 0, 0.0, 0
        return out


def _profiled(fn):
    """fn() under torch.profiler, ending in a synchronize: (its result, wall
    s, device ms: the self time of every kernel and copy on the card)."""
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.time() - t
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e3
    return out, wall, dev


def _digest(model) -> str:
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def composed_adam(model, optimizer, scheduler, clip, tc: TrainConfig, dt, states, counts,
                  live):
    """The Adam update of a one-process composition over the merged rows of
    every rank (states, counts, live: the ranks' buffers end to end): a copy
    of the model and of the optimizer's state, E_loc of every row against the
    sorted merged table, weights normalized over all rows, the surrogate loss
    over all rows in one sum, the clip (a copy of its ring) and torch's Adam
    formula (`UpdateWindow`). Returns
    (the gradients, the parameters after, e_mean)."""
    m = NADE(model.cfg).to(states.device)
    m.load_state_dict(model.state_dict())
    named = list(m.named_parameters())
    opt, sched = tc.make_optimizer([p for k, p in named if not k.startswith("lut")],
                                   [p for k, p in named if k.startswith("lut")])
    opt.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    _set_schedule(opt, sched, scheduler.last_epoch)
    la, ph = log_psi(m, states)
    t_states, order = torch.sort(states, stable=True)
    e_re, e_im = local_energy(dt, t_states, la.detach()[order], ph.detach()[order], live.sum(),
                              queries=(states, la.detach(), ph.detach()))
    w = torch.where(live, counts, 0.0)
    w = w / w.sum()
    e_re, e_im = torch.where(live, e_re, 0.0), torch.where(live, e_im, 0.0)
    e_mean, e_mean_im = torch.sum(w * e_re), torch.sum(w * e_im)
    e_var = torch.sum(w * (e_re - e_mean) ** 2)
    d_re, d_im = (e_re - e_mean).to(torch.float32), (e_im - e_mean_im).to(torch.float32)
    opt.zero_grad(set_to_none=True)
    (2.0 * torch.sum(w.to(torch.float32) * (la * d_re + ph * d_im))).backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    grads = {k: p.grad.clone() for k, p in named}
    window = UpdateWindow(m, opt, sched, 1, copy.deepcopy(clip))
    window.apply(params, _grad_norm(params), torch.ones((), dtype=torch.bool,
                                                        device=states.device), e_mean, e_var)
    window.settle(1)
    return grads, {k: p.detach().clone() for k, p in named}, e_mean


def _dedup(states, la, ph, n_valid):
    """The sorted table with each live state once (its first copy)."""
    live = torch.arange(states.shape[0], device=states.device) < n_valid
    keep = live.clone()
    keep[1:] &= states[1:] != states[:-1]
    n = int(keep.sum())
    return states[keep], la[keep], ph[keep], n


def repeated_keys(dts: dict, table, queries, n_live) -> dict:
    """Each engine's E_loc kernel at a merged table that holds repeated keys
    (a state drawn on several ranks lies in it once a rank), for one rank's
    query rows, on the card: against its plain version on the same tensors,
    per row within the kernel's own tolerance, and against itself at the
    table with each state once. dts: engine -> DeviceTerms; "fact", "dense"
    and "xl" hold the grid kernel's output (`grid_tolerance`; the grid the
    repeated keys set must equal the grid of the table without them), "rank"
    and "sort" the E_loc of `local_energy(queries=)` through the one-launch
    row kernel and through its plain version (`rank_local_energy_tolerance`,
    `sorted_local_energy_tolerance`). table: (states, la, ph, n_valid),
    sorted, SENTINEL last; queries: (states, la, ph), the first n_live of
    them live (the row kernels are held on those). Returns per engine
    {max_abs_err, worst (the largest share of its tolerance), within,
    dedup_diff (the largest difference from the table without the repeats)
    and dedup_within (the grids equal; the row kernels' E_loc within their
    tolerance)}."""
    from naqs_tpu_torch.ops import dense_engine as de
    from naqs_tpu_torch.ops import grid_kernels as gk
    from naqs_tpu_torch.ops import local_energy as le
    from naqs_tpu_torch.ops.dyn_gather import (rank_local_energy_ref,
                                               rank_local_energy_tolerance)
    from naqs_tpu_torch.ops.rank import build_value_table, rank_index
    from naqs_tpu_torch.ops.sort_lookup import (pack_table, sorted_local_energy_ref,
                                                sorted_local_energy_tolerance)

    states, la, ph, n_valid = table
    q_s, q_la, q_ph = queries
    dedup = _dedup(states, la, ph, n_valid)
    out = {}
    for name, dt in dts.items():
        fn, spec = dt.dense, dt.rank_spec
        if name in ("fact", "dense", "xl"):
            if name == "xl":
                grid = de.xl_value_grid(fn, spec, states, la, ph, n_valid)[0]
                again = de.xl_value_grid(fn, spec, *dedup)[0]
            else:
                grid = de.value_grid(spec, states, la, ph, n_valid, fn.sa, fn.sb)[0]
                again = de.value_grid(spec, *dedup, fn.sa, fn.sb)[0]
            kernel, plain = {"fact": (gk.factored_cells_accumulate,
                                      gk.factored_cells_accumulate_ref),
                             "dense": (gk.dense_grid_accumulate, gk.dense_grid_accumulate_ref),
                             "xl": (gk.xl_grid_accumulate, gk.xl_grid_accumulate_ref)}[name]
            rows = ((rank_index(spec, q_s), de._count(q_s.shape[0], q_s.device))
                    if name == "fact" else ())
            got, want = kernel(fn, grid, *rows), plain(fn, grid, *rows)
            tol = gk.grid_tolerance(fn, grid, *rows)
            diff = (got - want).abs()
            dedup_diff = float((grid - again).abs().max())
            dedup_ok = torch.equal(grid, again)
        else:
            terms_t = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff)
            c = le._chunks(dt, q_s.shape[0], None)
            attr = "rank_local_energy" if name == "rank" else "sorted_local_energy"
            kern = getattr(le, attr)
            got = le.local_energy(dt, states, la, ph, n_valid, queries=queries)
            setattr(le, attr, rank_local_energy_ref if name == "rank" else sorted_local_energy_ref)
            try:
                want = le.local_energy(dt, states, la, ph, n_valid, queries=queries)
            finally:
                setattr(le, attr, kern)
            if name == "rank":
                tol = rank_local_energy_tolerance(spec, build_value_table(spec, *table), q_s,
                                                  q_la.float(), *terms_t, dt.diag_coeff,
                                                  chunk_rows=c)
            else:
                packed = pack_table(states, la, ph)
                tol = sorted_local_energy_tolerance(packed[0], packed[1], n_valid, q_s,
                                                    q_la.float(), *terms_t, dt.diag_coeff,
                                                    chunk_rows=c)
            live = slice(0, int(n_live))
            got, want = torch.stack(got, -1)[live], torch.stack(want, -1)[live]
            tol = tol[live, None]
            diff = (got - want).abs()
            again = torch.stack(le.local_energy(dt, *dedup, queries=queries), -1)[live]
            dedup_diff = float((got - again).abs().max())
            dedup_ok = bool(((got - again).abs() <= tol).all())
        out[name] = dict(max_abs_err=float(diff.max()), worst=float((diff / tol).max()),
                         within=bool((diff <= tol).all()) and bool(torch.isfinite(got).all()),
                         dedup_diff=dedup_diff, dedup_within=dedup_ok)
    return out


def _rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def rank_run(hilbert, terms, cfg: NAQSConfig, tc: TrainConfig, plan, device=None) -> dict:
    """One rank's drill: `plan` is ((optimizer, steps), ...) with optimizer
    "adam", "sr" or "kfac". Returns the rows of every step (wall s and device
    ms under torch.profiler, the step's collectives: count, host s, bytes;
    e_loc, n_unique, n_samples, cg_iters), the launches in those steps of
    every kernel of the first group of `wrappers()` that ran and of each of
    the E_loc glue's kernels, a digest of the parameters after them, and the
    fixed pair's check (e_loc, the summed gradient's and the update's
    distance from the composition's, relative)."""
    rank, world = comm.rank(), comm.world()
    tr = VMCTrainer(cfg, terms, hilbert, tc, device=device, n_devices=world)
    dev = tr.device
    ws, model_glue, eloc_glue = wrappers()
    for w in ws + model_glue + eloc_glue:
        w.launches = 0
    rows = []
    with CollectiveClock() as clock:
        for opt_name, n in plan:
            tr.tc = dataclasses.replace(tr.tc, use_sr=opt_name == "sr",
                                        use_kfac=opt_name == "kfac")
            tr._sharded = tr._make_sharded_step()
            clock.take()
            for i in range(n):
                out, wall, dev_ms = _profiled(tr.step)
                rows.append(dict(optimizer=opt_name, step=i + 1, wall_s=wall, device_ms=dev_ms,
                                 **clock.take(), e_loc=out["e_loc"], n_unique=out["n_unique"],
                                 n_samples=out["n_samples"], cg_iters=out.get("cg_iters")))
        launches = {w.__name__.lstrip("_"): w.launches for w in ws if w.launches}
        eloc_launches = {w.__name__: w.launches for w in eloc_glue}
        digest = _digest(tr.model)
        # the fixed pair: one data-parallel Adam update, held against the composition
        tr.tc = dataclasses.replace(tr.tc, use_sr=False, use_kfac=False)
        cap = max(64, tr.capacity // world)
        gen = rank_generator(CHECK_SEED, rank, dev)
        batch, _ = sample_shard(tr.model, gen, CHECK_SAMPLES, cap)
        n = batch.states.shape[0]
        g_states, g_counts = comm.all_gather_rows(batch.states, batch.counts)
        g_n = comm.all_gather_rows(batch.n_unique.reshape(1))
        live = torch.arange(n, device=dev)[None, :] < g_n[:, None]
        with torch.no_grad():
            la, ph = log_psi(tr.model, batch.states)
        merged = merge_shards(batch.states, la, ph, live[rank], batch.counts)   # a collective
        keys = None
        if rank == 0:   # the E_loc kernels at this pair's merged table, repeats and all
            keys = repeated_keys(
                {"fact": tr.dt, "rank": dataclasses.replace(tr.dt, dense=None),
                 "sort": dataclasses.replace(tr.dt, dense=None, rank_spec=None)},
                (merged.states, merged.la, merged.ph, merged.n_valid), (batch.states, la, ph),
                batch.n_unique)
            keys = dict(engines=keys, rows=n, n_valid=int(merged.n_valid),
                        repeats=int(merged.n_valid - merged.n_unique))
        before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
        ref = composed_adam(tr.model, tr.optimizer, tr.scheduler, tr.clip, tr.tc, tr.dt,
                            g_states, g_counts, live.reshape(-1))
        window = UpdateWindow(tr.model, tr.optimizer, tr.scheduler, 1, tr.clip)
        grads = {}
        apply = window.apply

        def capture(params, *rest):
            grads.update({k: p.grad.clone() for k, p in tr.model.named_parameters()})
            apply(params, *rest)

        window.apply = capture
        m = sharded_adam_update(tr.model, window, tr.dt, batch)
        overflow = bool(m["overflow"])
        window.settle(0 if overflow else 1)
        check = clock.take()
    after = {k: p.detach() for k, p in tr.model.named_parameters()}
    return dict(
        rank=rank, world=world, device=str(dev), backend=dist.get_backend(), route=comm.ROUTE,
        rows=rows, launches=launches, eloc_launches=eloc_launches, digest=digest,
        digest_after_check=_digest(tr.model),
        repeated_keys=keys,
        check=dict(n_unique=int(m["n_unique"]), overflow=overflow, e_loc=float(m["e_loc"]),
                   e_loc_composed=float(ref[2]), grad_err=_rel(grads, ref[0]),
                   update_err=_rel({k: after[k] - before[k] for k in after},
                                   {k: ref[1][k] - before[k] for k in after}), **check),
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
