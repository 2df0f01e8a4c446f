"""Data-parallel VMC steps over the unique-sample batch, one process a rank.

Port of `naqs_tpu/parallel/step.py` (its `shard_map`-ed steps over the mesh
axis "dp") to `torch.distributed` (`parallel/comm.py`):

  * each rank samples n_samples / D under its own generator, into a buffer
    of `capacity_per_device` rows (a state may be drawn on several ranks:
    count weights stay right, since each copy carries its own count), cut
    to the longest live prefix of any rank (`sample_shard`: the one
    readback before the update), so that no model pass runs over padding
    that every rank has;
  * the ranks' (state, log psi, count) rows are gathered and sorted into one
    merged buffer, so that every rank computes the local energies of its OWN
    rows against the global support (`shard_energy`);
  * energies, weights and gradients are summed over the ranks; the
    parameters stay replicated, bit for bit, on every rank;
  * three optimizers: Adam (`make_sharded_train_step`, with the trainer's LR
    groups and gradient clip on the summed gradient), SR
    (`make_sharded_sr_step`, S v summed over the ranks, CG replicated) and
    K-FAC (`make_sharded_kfac_step`, the factors summed over the ranks).

Every update is withheld on the device when any rank's batch overflowed; no
update reads anything back to the host. The `make_sharded_*_step` closures
do not run the update at all when `sample_shard` read back an overflow.
The JAX package also splits the grid engines' mask loop over the mesh and
sums the numerator grid; here each rank calls the single-device engine on
its own query rows (the same function, up to float32 summation order): see
`ROADMAP.md`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from naqs_tpu_torch.kfac import kfac_apply
from naqs_tpu_torch.models.nade import NADE, log_psi
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy
from naqs_tpu_torch.parallel.comm import (all_gather_rows, all_reduce_sum, all_reduce_sum_,
                                          rank, world)
from naqs_tpu_torch.sampler import SampleBatch, sample
from naqs_tpu_torch.sr import sr_step, sr_system
from naqs_tpu_torch.trainer import UpdateWindow, _grad_norm, log_psi_table


@dataclass(frozen=True)
class Merged:
    """The ranks' sample buffers gathered and sorted by state (SENTINEL rows
    last, equal states in rank order): the merged psi table and the sampled
    state counter's record."""

    states: torch.Tensor     # (D * cap,) int64
    la: torch.Tensor         # (D * cap,) log|psi|
    ph: torch.Tensor         # (D * cap,) arg psi
    counts: torch.Tensor     # (D * cap,) f64, 0 on dead rows
    n_valid: torch.Tensor    # () int64: live rows, each copy of a state counted
    n_unique: torch.Tensor   # () int64: distinct live states


def merge_shards(states, la, ph, live, counts) -> Merged:
    """Gather every rank's rows and sort them (a stable sort, as the JAX
    package's argsort): the global table the local energies read."""
    g_states, g_la, g_ph, g_live, g_counts = all_gather_rows(
        states, la, ph, live, torch.where(live, counts, 0.0))
    g_states, order = torch.sort(g_states, stable=True)
    g_live = g_live[order]
    new = torch.ones_like(g_live)
    new[1:] = g_states[1:] != g_states[:-1]
    return Merged(g_states, g_la[order], g_ph[order], g_counts[order],
                  g_live.sum(), (new & g_live).sum())


@dataclass(frozen=True)
class ShardEnergy:
    """`shard_energy`'s results: this rank's rows and the global statistics."""

    batch: SampleBatch
    live: torch.Tensor       # (cap,) bool: the rank's live rows
    w: torch.Tensor          # (cap,) f64 weights, summing to 1 over every rank
    e_re: torch.Tensor       # (cap,) f64 local energies, 0 on dead rows
    e_im: torch.Tensor
    e_mean: torch.Tensor     # () f64, global
    e_mean_im: torch.Tensor
    e_var: torch.Tensor
    overflow: torch.Tensor   # () bool: some rank's batch overflowed
    merged: Merged


def shard_energy(model: NADE, dt: DeviceTerms, batch: SampleBatch,
                 reweight_by_psi: bool = False, table=None, fwd_chunk: int = 65536,
                 rows=None) -> ShardEnergy:
    """The shared middle of the sharded steps on this rank's batch: the merged
    buffer, local energies of the rank's own rows against it, weights
    normalized over every rank and the global mean, variance and overflow
    (the JAX package's `_sample_and_energy` after its `sample`).

    reweight_by_psi: |psi|^2 weights, each divided by its state's
    multiplicity in the merged buffer (a state drawn on k ranks would
    otherwise count k times). table=(t_states, t_n) (`trainer.sector_table`
    padded for D ranks): exact local energies; each rank evaluates psi over
    its contiguous 1/D slice of the sector and the slices are gathered.
    rows: the batch's (log_amp, phase) when the caller computed them."""
    states = batch.states
    live = torch.arange(states.shape[0], device=states.device) < batch.n_unique
    if rows is None:
        with torch.no_grad():
            rows = log_psi(model, states)
    la, ph = rows
    merged = merge_shards(states, la, ph, live, batch.counts)
    if table is not None:
        t_states, t_n = table
        d = world()
        if t_states.shape[0] % d:
            raise ValueError(f"the sector table's {t_states.shape[0]} rows do not split "
                             f"over {d} ranks: pad it with sector_table(..., n_devices={d})")
        per = t_states.shape[0] // d
        mine = log_psi_table(model, t_states[rank() * per:(rank() + 1) * per], fwd_chunk)
        lookup = (t_states, *all_gather_rows(*mine), t_n)
    else:
        lookup = (merged.states, merged.la, merged.ph, merged.n_valid)
    e_re, e_im = local_energy(dt, *lookup, queries=(states, la, ph))
    e_re = torch.where(live, e_re, 0.0)
    e_im = torch.where(live, e_im, 0.0)
    if reweight_by_psi:
        mult = (torch.searchsorted(merged.states, states, right=True)
                - torch.searchsorted(merged.states, states))
        raw = torch.where(live, torch.exp(2.0 * la.to(torch.float64))
                          / torch.clamp(mult, min=1).to(torch.float64), 0.0)
    else:
        raw = torch.where(live, batch.counts, 0.0)
    total, n_over = all_reduce_sum(torch.stack([raw.sum(),
                                                batch.overflow.to(torch.float64)]))
    w = raw / total
    e_mean, e_mean_im = all_reduce_sum(torch.stack([torch.sum(w * e_re), torch.sum(w * e_im)]))
    e_var = all_reduce_sum(torch.sum(w * (e_re - e_mean) ** 2))
    return ShardEnergy(batch, live, w, e_re, e_im, e_mean, e_mean_im, e_var, n_over > 0,
                       merged)


def sample_shard(model: NADE, gen: torch.Generator, n_samples: float,
                 capacity_per_device: int, beta: float = 1.0):
    """This rank's share of a sharded step's samples: n_samples / D drawn
    under `gen` into capacity_per_device rows, then cut to the longest live
    prefix of any rank (at least one row), the same length on every rank.
    Rows past a rank's n_unique carry zero weight in every sum, so the cut
    changes no result; it spares the update's model passes the padding.
    One gather of (n_unique, overflow) and one readback. Returns (the cut
    batch, whether any rank's batch overflowed)."""
    batch = sample(model, gen, n_samples / world(), capacity_per_device, beta=beta)
    mine = torch.stack([batch.n_unique.to(torch.int64), batch.overflow.to(torch.int64)])
    n_max, n_over = all_gather_rows(mine[None]).amax(dim=0).tolist()
    n = max(int(n_max), 1)
    return (SampleBatch(batch.states[:n], batch.counts[:n], batch.n_unique, batch.overflow),
            bool(n_over))


def _metrics(se: ShardEnergy, **more) -> dict:
    """A sharded step's device metrics, as the JAX package's (the record
    is the merged buffer for the host's sampled-state counter)."""
    return {"e_loc": se.e_mean, "e_loc_var": se.e_var, "n_unique": se.merged.n_unique,
            "overflow": se.overflow, **more, "rec_states": se.merged.states,
            "rec_counts": se.merged.counts, "rec_n_valid": se.merged.n_valid}


def sharded_adam_update(model: NADE, window: UpdateWindow, dt: DeviceTerms,
                        batch: SampleBatch, reweight_by_psi: bool = False, table=None,
                        fwd_chunk: int = 65536) -> dict:
    """One data-parallel Adam update on this rank's batch: the surrogate loss
    over the rank's rows with the global weights, its gradients summed over
    the ranks, then `window.apply` (the clip on the global gradient norm and
    Adam, withheld where any rank overflowed). Returns the device metrics,
    with grad_norm before the clip."""
    optimizer = window.optimizer
    optimizer.zero_grad(set_to_none=True)
    la, ph = log_psi(model, batch.states)
    se = shard_energy(model, dt, batch, reweight_by_psi, table, fwd_chunk,
                      rows=(la.detach(), ph.detach()))
    d_re = (se.e_re - se.e_mean).to(torch.float32)
    d_im = (se.e_im - se.e_mean_im).to(torch.float32)
    loss = 2.0 * torch.sum(se.w.to(torch.float32) * (la * d_re + ph * d_im))
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    all_reduce_sum_([p.grad for p in params if p.grad is not None])
    gnorm = _grad_norm(params)
    window.apply(params, gnorm, ~se.overflow, se.e_mean, se.e_var)
    return _metrics(se, grad_norm=gnorm)


def make_sharded_train_step(model: NADE, capacity_per_device: int, table=None,
                            fwd_chunk: int = 65536, reweight_by_psi: bool = False,
                            sample_beta: float = 1.0):
    """step(window, dt, gen, n_samples) -> device metrics, or None where some
    rank's batch overflowed: `sample_shard` on this rank under `gen`, then
    `sharded_adam_update` through the `UpdateWindow` of one step that the
    caller made (it holds the optimizer, the schedule and the clip, and
    after the caller's readback its `settle` books the update). On None the
    host controller backs off n_samples and resamples. table: the sector
    table for exact local energies, padded for D ranks."""
    def step(window: UpdateWindow, dt: DeviceTerms, gen: torch.Generator, n_samples: float):
        batch, overflow = sample_shard(model, gen, n_samples, capacity_per_device, sample_beta)
        if overflow:
            return None
        return sharded_adam_update(model, window, dt, batch, reweight_by_psi, table, fwd_chunk)

    return step


def _keep_unless(flag: torch.Tensor, new, old):
    """`old` where the device bool flag holds, else `new`, over a nested
    dict/list of tensors."""
    if isinstance(new, dict):
        return {k: _keep_unless(flag, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [_keep_unless(flag, n, o) for n, o in zip(new, old)]
    return torch.where(flag, old, new)


def sharded_kfac_update(model: NADE, kstate: dict, dt: DeviceTerms, batch: SampleBatch,
                        lr: float, damping: float = 1e-2, decay: float = 0.95,
                        kl_clip: float = 1e-3):
    """One data-parallel K-FAC update (count weights, as the JAX package's):
    `kfac_apply` with its loss, gradients and factors summed over the ranks;
    parameters and factors kept as they were where any rank overflowed.
    Returns (new kstate, device metrics with nu)."""
    se = shard_energy(model, dt, batch)
    params = list(model.parameters())
    old = [p.detach().clone() for p in params]
    new_state, m = kfac_apply(model, kstate, batch.states, se.w, se.e_re - se.e_mean,
                              se.e_im - se.e_mean_im, lr, damping, decay, kl_clip,
                              psum=all_reduce_sum)
    with torch.no_grad():
        for p, o in zip(params, old):
            p.copy_(torch.where(se.overflow, o, p))
    return _keep_unless(se.overflow, new_state, kstate), _metrics(se, nu=m["nu"])


def make_sharded_kfac_step(model: NADE, capacity_per_device: int):
    """step(kstate, dt, gen, n_samples, lr, damping, decay, kl_clip) -> (new
    kstate, device metrics), or (kstate, None) where some rank's batch
    overflowed: `sample_shard` on this rank, then `sharded_kfac_update`."""
    def step(kstate, dt, gen, n_samples, lr, damping, decay, kl_clip):
        batch, overflow = sample_shard(model, gen, n_samples, capacity_per_device)
        if overflow:
            return kstate, None
        return sharded_kfac_update(model, kstate, dt, batch, lr, damping, decay, kl_clip)

    return step


def sharded_sr_update(model: NADE, dt: DeviceTerms, batch: SampleBatch, lr: float,
                      damping: float, cg_iters: int = 50, reweight_by_psi: bool = False,
                      kl_clip: Optional[float] = None, fisher_mix: float = 0.0) -> dict:
    """One data-parallel SR update: `sr_system` with the global weights and
    its gradient, centring sums, S v and fisher_mix's live count summed over
    the ranks, so that CG and the KL clip run on the same values on every
    rank; withheld where any rank overflowed (or on a non-finite energy or
    step, as on one device). Returns the device metrics with grad_norm,
    sr_dx_norm and cg_iters."""
    se = shard_energy(model, dt, batch, reweight_by_psi)
    centred = (se.w, se.e_re - se.e_mean, se.e_im - se.e_mean_im, se.e_mean, se.e_var)
    flat0, params, grad, s_matvec, _, _ = sr_system(
        model, dt, batch, damping, fisher_mix=fisher_mix, psum=all_reduce_sum,
        centred=centred)
    x, n_iter = sr_step(flat0, params, grad, s_matvec, se.e_mean, lr, cg_iters, kl_clip,
                        se.overflow)
    return _metrics(se, grad_norm=torch.linalg.norm(grad), sr_dx_norm=torch.linalg.norm(x),
                    cg_iters=n_iter)


def make_sharded_sr_step(model: NADE, capacity_per_device: int, cg_iters: int = 50,
                         reweight_by_psi: bool = False, kl_clip: Optional[float] = None,
                         fisher_mix: float = 0.0):
    """step(dt, gen, n_samples, lr, damping) -> device metrics, or None where
    some rank's batch overflowed: `sample_shard` on this rank, then
    `sharded_sr_update`."""
    def step(dt, gen, n_samples, lr, damping):
        batch, overflow = sample_shard(model, gen, n_samples, capacity_per_device)
        if overflow:
            return None
        return sharded_sr_update(model, dt, batch, lr, damping, cg_iters, reweight_by_psi,
                                 kl_clip, fisher_mix)

    return step
