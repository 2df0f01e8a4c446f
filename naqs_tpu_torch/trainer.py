"""VMC training: surrogate loss, Adam or a natural gradient, adaptive
sample-count controller.

Port of the single-device `VMCTrainer` of `naqs_tpu/trainer.py`:

  * surrogate loss 2 * sum_s w_s [log|psi| * Re(dE) + arg(psi) * Im(dE)]
    with dE = E_loc - <E_loc> held constant, weights in f64 from sample
    counts or from |psi|^2 (reweight_by_psi);
  * torch.optim.Adam (betas 0.9/0.99, eps 1e-15; its update
    m_hat / (sqrt(v_hat) + eps) equals optax.adam's) with a two-phase LR,
    and with `num_lut` a second parameter group, the LUT tables, at the
    constant `lr_lut` (the JAX package's optax.multi_transform), optionally
    behind the adaptive trailing-mean gradient clip (`TrailingClip`, the JAX
    package's `adaptive_trailing_clip`) over both groups;
  * the update is withheld on capacity overflow or any non-finite loss,
    gradient norm or energy: the decision is read back with the step's one
    host sync, before the clip or optimizer.step() mutates parameters, Adam
    state or the clip's ring;
  * exact mode: local energies resolved against psi over the whole
    enumerated sector (`TrainConfig.exact_eloc`: the SENTINEL-padded sector
    table, `log_psi_table`, `table=` of the update), and exact-sampling
    training over the whole basis with |psi|^2 weights (`run_exact`), whose
    full-basis windows of steps run on the card with the withholding, Adam,
    the LR schedule and the clip decided there, and one readback a window
    (`UpdateWindow`, `vmc_update_scan`);
  * the natural-gradient updates in place of Adam (`TrainConfig.use_sr`:
    matrix-free SR, `sr.py`; `use_kfac`: K-FAC, `kfac.py`, its running
    factors in `VMCTrainer.kfac_state` and in checkpoints): `step()` then
    samples through the controller, updates at the LR of `_current_lr()`
    (keyed on the steps taken) and reads back once;
  * data parallelism (`n_devices=D`, the JAX package's sharded trainer): one
    process a rank in a `torch.distributed` group of D
    (`parallel.initialize_distributed`), each rank sampling its share and
    every update summed over the ranks (`parallel/step.py`), withheld on the
    card when any rank overflowed, one readback a step (`_step_sharded`);
    the state stays bitwise equal on every rank, and rank 0 alone writes;
  * the host sample-count controller: x10 when too few unique samples,
    /10 on too many or on overflow, with overflow hysteresis;
  * the sampled-state counter (every RECORD_FREQ-th step) that feeds
    `solve_h`, the subspace diagonalization ("VMC+FCI"), and the warm starts
    `pre_flatten`, `pre_train_hf`, `pre_train_targets` and
    `warm_start_from_solve_h`; density-sampling training (`run_density`);
    training on another operator than the reported one (`train_terms`, e.g.
    H + lam S^2 from `utils/spin.py`); checkpoints (`save`/`load`, which
    also reads the JAX package's `.msgpack`), `save_log` and `save_psi`.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from dataclasses import dataclass
from itertools import repeat
from operator import add
from typing import Optional

import numpy as np
import torch

from naqs_tpu_torch.hamiltonian import PauliTerms, assemble_sparse_hamiltonian_np
from naqs_tpu_torch.kfac import kfac_init, kfac_update
from naqs_tpu_torch.models.convert import kfac_state_from_jax, params_from_jax
from naqs_tpu_torch.models.nade import NADE, NAQSConfig, log_psi
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy, quadratic_energy
from naqs_tpu_torch.sampler import SampleBatch, sample, sample_density
from naqs_tpu_torch.sr import sr_update
from naqs_tpu_torch.utils.bits import SENTINEL, np_unpack_bits
from naqs_tpu_torch.utils.checkpoint import jax_params, optax_parts, read_flax_msgpack
from naqs_tpu_torch.utils.device import resolve_device
from naqs_tpu_torch.utils.hilbert import Hilbert


CLIP_INIT_MAX = 1e3  # the clip's limit before any norm is kept


class TrailingClip:
    """Clip the global gradient norm to `factor` x the trailing mean of the
    last `memory` clipped norms (`adaptive_trailing_clip` of the JAX
    package). Its state stays on the device: a (memory,) f32 ring of clipped
    norms and an int32 count; with an empty ring the limit is CLIP_INIT_MAX.

    `scale(norm)` gives the factor to multiply the gradients by and the norm
    the ring keeps, as device tensors; `commit(kept)` writes it. The caller
    commits only an applied update, so a withheld one leaves the ring as it
    was (JAX withholds the clip state with the Adam state); `commit(kept,
    ok)` with a device bool writes it only where ok holds, with no readback."""

    def __init__(self, factor: float, memory: int = 50, device=None):
        self.factor, self.memory = float(factor), int(memory)
        self.norms = torch.zeros((self.memory,), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def scale(self, norm: torch.Tensor):
        have = torch.clamp(self.count, max=self.memory)
        mean = torch.where(have > 0, self.norms.sum() / torch.clamp(have, min=1),
                           CLIP_INIT_MAX / self.factor)
        max_norm = self.factor * mean
        scale = torch.where(norm > max_norm, max_norm / (norm + 1e-12), 1.0)
        return scale, torch.minimum(norm, max_norm)

    def commit(self, kept: torch.Tensor, ok: Optional[torch.Tensor] = None):
        slot = torch.remainder(self.count, self.memory).to(torch.int64).reshape(1)
        kept = kept.reshape(1).to(torch.float32)
        if ok is None:
            self.norms.index_copy_(0, slot, kept)
            self.count += 1
            return
        self.norms.index_copy_(0, slot, torch.where(ok, kept,
                                                    torch.index_select(self.norms, 0, slot)))
        self.count += ok.to(torch.int32)

    def state_dict(self) -> dict:
        return {"norms": self.norms.clone(), "count": self.count.clone()}

    def load_state_dict(self, state: dict):
        self.norms.copy_(torch.as_tensor(state["norms"], dtype=torch.float32))
        self.count.copy_(torch.as_tensor(state["count"], dtype=torch.int32))


@dataclass(frozen=True)
class TrainConfig:
    n_train: int = 5000
    lr: float = 1e-3
    lr_final: float = 5e-4          # second-phase LR
    lr_lut: float = 1e-2            # constant LR of the LUT tables
    use_lr_schedule: bool = True
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
    grad_clip_factor: Optional[float] = None
    grad_clip_memory: int = 50
    n_samples: float = 1e6
    n_samples_max: float = 1e12
    n_unq_samples_min: int = 1000
    n_unq_samples_max: int = 4096   # also the device buffer capacity
    reweight_by_psi: bool = False
    sample_beta: float = 1.0        # tempered sampling; pair with reweight_by_psi
    # exact local energies: psi over the whole enumerated sector each step
    # (log_psi_table), every coupled state resolved against it, in place of
    # the truncated psi(s') = 0 of unsampled states
    exact_eloc: bool = False
    eloc_fwd_chunk: int = 65536     # rows per log_psi_table chunk
    use_sr: bool = False            # stochastic-reconfiguration natural gradient
    sr_damping: float = 1e-3
    sr_cg_iters: int = 50
    sr_kl_clip: Optional[float] = None  # trust-region cap on lr^2 x^T S x
    sr_fisher_mix: float = 0.0      # uniform-support mixing in the metric
    use_kfac: bool = False          # Kronecker-factored natural gradient
    kfac_damping: float = 1e-2
    kfac_decay: float = 0.95
    kfac_kl_clip: float = 1e-3
    seed: int = 0

    def lr_at(self, n_updates: int) -> float:
        """LR of the update after `n_updates` applied ones (optax's
        join_schedules of two constants at n_train // 2)."""
        if self.use_lr_schedule and n_updates >= max(self.n_train // 2, 1):
            return self.lr_final
        return self.lr

    def make_optimizer(self, params, lut_params=()):
        """(Adam, LambdaLR): step the scheduler once per APPLIED update.
        The base LR is 1, so the schedule's value is the LR itself. Given
        `lut_params` (the LUT tables), they form a second group held at the
        constant lr_lut while `params` follow the two-phase schedule."""
        groups = [{"params": list(params)}]
        lambdas = [self.lr_at]
        lut_params = list(lut_params)
        if lut_params:
            groups.append({"params": lut_params})
            lambdas.append(lambda n_updates: self.lr_lut)
        opt = torch.optim.Adam(groups, lr=1.0,
                               betas=(self.adam_b1, self.adam_b2),
                               eps=self.adam_eps)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)

    def make_clip(self, device=None) -> Optional[TrailingClip]:
        """The gradient clip in front of Adam, or None without grad_clip_factor."""
        if self.grad_clip_factor is None:
            return None
        return TrailingClip(self.grad_clip_factor, self.grad_clip_memory, device=device)


def _grad_norm(params) -> torch.Tensor:
    sq = [torch.sum(p.grad.to(torch.float32) ** 2) for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def log_psi_table(model: NADE, states: torch.Tensor, chunk: int = 65536):
    """(log_amp, phase) of a large SENTINEL-padded state buffer, chunk rows
    at a time, so that the activations of one chunk are alive at once (the
    whole H2O 6-31G sector is 1,656,369 rows). A buffer longer than `chunk`
    must be a multiple of it (`sector_table` pads it so). Each chunk's
    outputs go into one preallocated pair of tensors; nothing is read back."""
    n = states.shape[0]
    if n <= chunk:
        return log_psi(model, states)
    if n % chunk:
        raise ValueError(f"log_psi_table: {n} rows is not a multiple of the chunk {chunk}")
    la = ph = None
    for i in range(0, n, chunk):
        a, p = log_psi(model, states[i:i + chunk])
        if la is None:
            la, ph = a.new_empty(n), p.new_empty(n)
        la[i:i + chunk], ph[i:i + chunk] = a, p
    return la, ph


def sector_table(basis: np.ndarray, chunk: int, device=None, n_devices: int = 1):
    """The exact-E_loc sector table (t_states, t_n): the sorted basis as int64
    on the device, SENTINEL-padded up to a multiple of `chunk` x n_devices
    when it is longer than one chunk, else of n_devices, so that it splits
    into one slice a rank whose forward runs in whole chunks (the data-parallel
    step's table forward), and its length as a 0-d int64 device tensor."""
    n = len(basis)
    unit = chunk * n_devices if n > chunk else n_devices
    n_pad = -(-n // unit) * unit
    buf = np.full((n_pad,), SENTINEL, dtype=np.int64)
    buf[:n] = basis
    return (torch.as_tensor(buf, device=device),
            torch.full((), n, dtype=torch.int64, device=device))


def vmc_loss(model: NADE, dt: DeviceTerms, batch: SampleBatch,
             reweight_by_psi: bool = False, table=None, fwd_chunk: int = 65536):
    """Surrogate loss of one batch. Returns (loss, e_mean, e_var).

    With `table=(t_states, t_n)` (`sector_table`) the local energies are
    exact: psi over the whole sector (`log_psi_table`, outside autograd), and
    every coupled state resolved against it; without, against the batch
    itself (psi(s') = 0 for unsampled states)."""
    live = torch.arange(batch.states.shape[0], device=batch.states.device) < batch.n_unique
    if table is not None:
        t_states, t_n = table
        t_la, t_ph = log_psi_table(model, t_states, fwd_chunk)
    la, ph = log_psi(model, batch.states)
    la_d, ph_d = la.detach(), ph.detach()
    if reweight_by_psi:
        w = torch.where(live, torch.exp(2.0 * la_d.to(torch.float64)), 0.0)
    else:
        w = torch.where(live, batch.counts, 0.0)
    # an empty batch gives 0-weights (a no-op step), not 0/0
    w = w / torch.clamp(w.sum(), min=1e-300)
    if table is not None:
        e_re, e_im = local_energy(dt, t_states, t_la, t_ph, t_n,
                                  queries=(batch.states, la_d, ph_d))
    else:
        e_re, e_im = local_energy(dt, batch.states, la_d, ph_d, batch.n_unique)
    e_re = torch.where(live, e_re, 0.0)
    e_im = torch.where(live, e_im, 0.0)
    e_mean = torch.sum(w * e_re)
    e_mean_im = torch.sum(w * e_im)
    e_var = torch.sum(w * (e_re - e_mean) ** 2)
    d_re = (e_re - e_mean).to(torch.float32)
    d_im = (e_im - e_mean_im).to(torch.float32)
    loss = 2.0 * torch.sum(w.to(torch.float32) * (la * d_re + ph * d_im))
    return loss, e_mean, e_var


def _gradients(model: NADE, optimizer, dt: DeviceTerms, batch: SampleBatch,
               reweight_by_psi: bool, table, fwd_chunk: int):
    """Backward of the surrogate loss into the parameters' .grad. Returns
    (params, loss, e_mean, e_var, gradient norm, bad): device tensors, bad a
    bool that holds where the update must be withheld (capacity overflow, or
    a non-finite loss, gradient norm or energy)."""
    optimizer.zero_grad(set_to_none=True)
    loss, e_mean, e_var = vmc_loss(model, dt, batch, reweight_by_psi, table, fwd_chunk)
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    gnorm = _grad_norm(params)
    bad = (batch.overflow | ~torch.isfinite(loss) | ~torch.isfinite(gnorm)
           | ~torch.isfinite(e_mean))
    return params, loss.detach(), e_mean, e_var, gnorm, bad


def vmc_update(model: NADE, optimizer, scheduler, dt: DeviceTerms,
               batch: SampleBatch, reweight_by_psi: bool = False,
               clip: Optional[TrailingClip] = None, table=None,
               fwd_chunk: int = 65536) -> dict:
    """One Adam step on a sampled batch, withheld when the batch overflowed
    or anything went non-finite (one NaN would poison the parameters and
    the Adam moments for good). Does the step's one host readback and
    returns host scalars: e_loc, e_loc_var, loss, grad_norm (before the
    clip), clip_scale (1 without a clip), n_unique, overflow, applied.
    `table=` and `fwd_chunk` as in `vmc_loss` (exact local energies)."""
    params, loss, e_mean, e_var, gnorm, bad = _gradients(
        model, optimizer, dt, batch, reweight_by_psi, table, fwd_chunk)
    scalars = [e_mean, e_var, loss.to(torch.float64), gnorm.to(torch.float64),
               batch.n_unique.to(torch.float64), batch.overflow.to(torch.float64),
               bad.to(torch.float64)]
    if clip is not None:
        scale, kept = clip.scale(gnorm)
        scalars.append(scale.to(torch.float64))
    vals = torch.stack(scalars).cpu().tolist()
    e_loc, e_loc_var, loss_v, gnorm_v, n_unq, ovf, bad = vals[:7]
    if not bad:
        if clip is not None:
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
            clip.commit(kept)
        optimizer.step()
        scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    return {"e_loc": e_loc, "e_loc_var": e_loc_var, "loss": loss_v,
            "grad_norm": gnorm_v, "clip_scale": vals[7] if clip is not None else 1.0,
            "n_unique": int(n_unq), "overflow": bool(ovf), "applied": not bad}


def _set_schedule(optimizer, scheduler, applied: int):
    """Put the LR schedule where `applied` applied updates leave it: the
    scheduler's count and each group's LR (the base LR times its lambda)."""
    scheduler.last_epoch = applied
    for g, base, lr_at in zip(optimizer.param_groups, scheduler.base_lrs,
                              scheduler.lr_lambdas):
        g["lr"] = base * lr_at(applied)
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]


def _to_device(tree, device):
    """A nested dict/list of tensors (K-FAC's state) moved to the device."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree if tree is None else tree.to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A window's one device-to-host copy."""
    return t.cpu().numpy()


class UpdateWindow:
    """Consecutive `vmc_update` steps with no host sync between them.

    Everything the host decides per step in `vmc_update` is decided on the
    card: the withholding (a device bool from the batch's overflow and the
    finiteness of the loss, gradient norm and energy), Adam (the update of
    torch.optim.Adam's formula on the optimizer's own `exp_avg` and
    `exp_avg_sq`, with each parameter's step count on the card; the moments
    and parameters are replaced by where(ok, new, old)), the LR (each
    group's schedule tabulated on the host before the window for every
    count of applied updates it can reach, read by the device count) and
    the clip (`TrailingClip.commit(kept, ok)`). A withheld step changes no
    parameter, moment, step count, LR position or clip ring.

    `step()` runs one update; `close()` does the window's one readback (the
    per-step (e_loc, e_loc_var) rows and whether each step was applied) and
    leaves the optimizer's step counts and the scheduler where the same
    applied updates through `vmc_update` leave them. The optimizer must be
    torch.optim.Adam as `TrainConfig.make_optimizer` makes it (no weight
    decay, amsgrad or maximize) and the scheduler its LambdaLR."""

    def __init__(self, model: NADE, optimizer, scheduler, length: int,
                 clip: Optional[TrailingClip] = None):
        for g in optimizer.param_groups:
            if g["weight_decay"] or g["amsgrad"] or g["maximize"]:
                raise ValueError("UpdateWindow runs plain Adam only")
        dev = next(model.parameters()).device
        self.model, self.optimizer, self.scheduler, self.clip = model, optimizer, scheduler, clip
        self.length, self.i = int(length), 0
        start = scheduler.last_epoch
        self.lr = torch.tensor([[base * lr_at(start + k) for k in range(self.length)]
                                for base, lr_at in zip(scheduler.base_lrs, scheduler.lr_lambdas)],
                               dtype=torch.float64, device=dev)
        self.n_applied = torch.zeros((), dtype=torch.int64, device=dev)
        self.metrics = torch.full((self.length, 2), float("nan"), dtype=torch.float64,
                                  device=dev)
        self.applied = torch.zeros((self.length,), dtype=torch.float64, device=dev)
        # parameter -> its Adam step count on the card (f64); a parameter with
        # no Adam state yet gets it at its first step, as in torch.optim.Adam
        self.steps = {p: torch.full((), float(optimizer.state[p]["step"]),
                                    dtype=torch.float64, device=dev)
                      for g in optimizer.param_groups for p in g["params"]
                      if optimizer.state.get(p)}
        self.created = []   # parameters whose Adam state this window created

    def _adam_state(self, p):
        state = self.optimizer.state[p]
        if not state:   # as torch.optim.Adam makes it on a parameter's first step
            state["step"] = torch.tensor(0.0, dtype=torch.float32)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            self.created.append(p)
            self.steps[p] = torch.zeros((), dtype=torch.float64, device=p.device)
        return state

    def step(self, dt: DeviceTerms, batch: SampleBatch, reweight_by_psi: bool = True):
        params, _, e_mean, e_var, gnorm, bad = _gradients(
            self.model, self.optimizer, dt, batch, reweight_by_psi, None, 0)
        self.apply(params, gnorm, ~bad, e_mean, e_var)

    def apply(self, params, gnorm: torch.Tensor, ok: torch.Tensor, e_mean: torch.Tensor,
              e_var: torch.Tensor):
        """The window's next update from the gradients in the parameters'
        .grad (`params` in the optimizer's order; gnorm their global norm):
        the clip, then Adam where the device bool `ok` holds; (e_mean, e_var)
        are kept as the step's metrics. The data-parallel step
        (`parallel/step.py`) gives it gradients summed over the ranks."""
        if self.i >= self.length:
            raise ValueError(f"the window holds {self.length} steps")
        with torch.no_grad():
            if self.clip is not None:
                scale, kept = self.clip.scale(gnorm)
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
                self.clip.commit(kept, ok)
            lrs = torch.index_select(self.lr, 1, self.n_applied.reshape(1))
            for g_i, group in enumerate(self.optimizer.param_groups):
                lr = lrs[g_i, 0]
                b1, b2 = group["betas"]
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    state = self._adam_state(p)
                    grad, m, v, st = p.grad, state["exp_avg"], state["exp_avg_sq"], self.steps[p]
                    st_new = st + 1
                    m_new = m.lerp(grad, 1 - b1)
                    v_new = v.mul(b2).addcmul_(grad, grad, value=1 - b2)
                    step_size = lr / (1 - torch.pow(b1, st_new))
                    denom = (v_new.sqrt() / torch.sqrt(1 - torch.pow(b2, st_new))).add_(
                        group["eps"])
                    p_new = p.addcdiv(m_new * -step_size, denom)
                    p.copy_(torch.where(ok, p_new, p))
                    m.copy_(torch.where(ok, m_new, m))
                    v.copy_(torch.where(ok, v_new, v))
                    st.copy_(torch.where(ok, st_new, st))
            self.metrics[self.i] = torch.stack([e_mean, e_var])
            self.applied[self.i] = ok.to(torch.float64)
            self.n_applied += ok.to(torch.int64)
        self.optimizer.zero_grad(set_to_none=True)
        self.i += 1

    def close(self):
        """The window's one readback: ((length, 2) f64 e_loc and e_loc_var of
        each step, NaN past the steps run; (length,) bool, applied)."""
        host = _to_host(torch.cat([self.metrics.reshape(-1), self.applied]))
        ms, applied = host[:2 * self.length].reshape(self.length, 2), host[2 * self.length:] > 0
        self.settle(int(applied.sum()))
        return ms, applied

    def settle(self, n: int):
        """With `n`, the count of applied steps as read back, leave the
        optimizer's step counts and the scheduler where n applied updates
        through `vmc_update` leave them (`close` does this after its
        readback)."""
        if n == 0:
            for p in self.created:
                del self.optimizer.state[p]
        else:
            for p in self.steps:
                self.optimizer.state[p]["step"] += n
        _set_schedule(self.optimizer, self.scheduler, self.scheduler.last_epoch + n)


def vmc_update_scan(model: NADE, optimizer, scheduler, dt: DeviceTerms, batch: SampleBatch,
                    n_live: int, reweight_by_psi: bool = True, length: int = 25,
                    clip: Optional[TrailingClip] = None):
    """`length` updates on one fixed batch (exact-sampling training's
    full-basis batch) as one `UpdateWindow`: no host sync between them and
    one readback after them. Steps from `n_live` on are masked: the JAX
    package computes them and keeps nothing (one compiled program serves
    every window); here they are not run. Returns ((length, 2) f64 host
    array of each step's (e_loc, e_loc_var), NaN past n_live; (length,) bool,
    whether each step was applied)."""
    window = UpdateWindow(model, optimizer, scheduler, length, clip)
    for _ in range(min(int(n_live), window.length)):
        window.step(dt, batch, reweight_by_psi)
    return window.close()


def _group_rank(n_devices: int) -> int:
    """This process's rank in the default process group, which must hold
    n_devices ranks (`parallel.initialize_distributed`)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(
            f"n_devices={n_devices} needs an initialized process group of {n_devices} "
            f"ranks (naqs_tpu_torch.parallel.initialize_distributed), found {have}")
    return dist.get_rank()


def _leaves(tree) -> list:
    """The tensors of a nested dict/list (K-FAC's state), in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _adam_step(model: NADE, opt, loss_fn) -> torch.Tensor:
    """One step of a warm start's plain Adam on loss_fn(model); returns the
    loss before the step (a device scalar)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    opt.step()
    return loss.detach()


class VMCTrainer:
    """Host-side training controller: drives sample and update, adapts the
    sample count, logs metrics, records the sampled states, checkpoints."""

    OVF_RETRY_STEPS = 50
    # the counter is fed every RECORD_FREQ-th step (one device->host copy of
    # the fixed-shape batch); the top-k statistic solve_h reads does not
    # need every step
    RECORD_FREQ = 5
    # past this many distinct states the counter keeps its top half
    COUNTER_MAX = 2_000_000
    # counter entries persisted per checkpoint (its top ones)
    COUNTER_SAVE_MAX = 200_000
    # run_exact's full-basis steps per window (one readback each)
    EXACT_FLUSH = 25

    def __init__(
        self,
        model_cfg: NAQSConfig,
        terms: PauliTerms,
        hilbert: Hilbert,
        train_cfg: TrainConfig = TrainConfig(),
        device=None,
        save_loc: Optional[str] = None,
        train_terms: Optional[PauliTerms] = None,
        n_devices: int = 1,
    ):
        self.n_devices = int(n_devices)
        self.rank = 0
        if self.n_devices > 1:
            from naqs_tpu_torch.parallel.multihost import rank_device

            self.rank, device = _group_rank(self.n_devices), rank_device(device)
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.tc = train_cfg
        self.hilbert = hilbert
        self.terms = terms
        # `train_terms` (when given) is the training operator, e.g. H + lam S^2
        # (utils/spin.penalized_termdict); `terms` stays the physical H, which
        # solve_h and the warm starts assemble and exact_energy() reports
        # through dt_h
        self.dt = DeviceTerms.from_terms(terms if train_terms is None else train_terms,
                                         hilbert=hilbert, device=self.device)
        self.dt_h = (self.dt if train_terms is None
                     else DeviceTerms.from_terms(terms, hilbert=hilbert, device=self.device))
        # the exact-E_loc sector table, padded so that each rank's slice runs
        # in whole chunks
        self._table = None
        if train_cfg.exact_eloc:
            # as in the JAX package: its K-FAC update has no table= path, and
            # its sharded SR step none either
            if train_cfg.use_kfac or (train_cfg.use_sr and self.n_devices > 1):
                raise ValueError("exact_eloc is implemented for the Adam update paths "
                                 "and single-chip SR")
            self._table = sector_table(hilbert.basis, int(train_cfg.eloc_fwd_chunk),
                                       self.device, self.n_devices)
        if train_cfg.use_sr and train_cfg.use_kfac:
            raise ValueError("use_sr and use_kfac are mutually exclusive")
        self.kfac_state = None  # K-FAC's running factors, made at its first step
        # the same seed on every rank: the parameters start replicated
        init_gen = torch.Generator().manual_seed(train_cfg.seed)
        self.model = NADE(model_cfg, init_gen).to(self.device)
        if self.n_devices > 1:
            from naqs_tpu_torch.parallel.multihost import rank_generator

            self.gen = rank_generator(train_cfg.seed + 1, self.rank, self.device)
        else:
            self.gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed + 1)
        self._new_optimizer()
        self.n_samples = float(train_cfg.n_samples)
        self.capacity = int(train_cfg.n_unq_samples_max)
        self._sharded = None
        if self.n_devices > 1:
            self._sharded = self._make_sharded_step()
        self.n_steps = 0
        self.run_time = 0.0
        self.save_loc = save_loc
        self.log = {"E": [], "E_LOC": [], "E_LOC_VAR": [], "N_UNIQUE_SAMP": [],
                    "TIME": []}
        # cross-step multiplicity of every recorded sampled state: solve_h's
        # top-k subspace. Keys are the packed states as Python ints
        self.sampled_counter: dict[int, float] = {}
        self.d_p = 1e-8  # density-sampling threshold (run_density)
        # (E0, n_states) of the last explicit-subspace solve_h warm start
        self.ws_result: Optional[tuple] = None
        # sample-count-controller hysteresis: the smallest n_samples that
        # recently overflowed, and when; growth past it is re-tried only
        # every OVF_RETRY_STEPS steps
        self._ovf_n = float("inf")
        self._ovf_step = -(10 ** 9)

    def _new_optimizer(self):
        named = list(self.model.named_parameters())
        self.optimizer, self.scheduler = self.tc.make_optimizer(
            [p for k, p in named if not k.startswith("lut")],
            [p for k, p in named if k.startswith("lut")])
        self.clip = self.tc.make_clip(self.device)

    def _note_overflow(self):
        self._ovf_n = min(self._ovf_n, self.n_samples)
        self._ovf_step = self.n_steps

    def _grow_blocked(self) -> bool:
        """True if growing n_samples x10 would hit a recently seen overflow."""
        return (self.n_samples * 10 >= self._ovf_n
                and self.n_steps - self._ovf_step < self.OVF_RETRY_STEPS)

    def _sample(self) -> SampleBatch:
        return sample(self.model, self.gen, self.n_samples, self.capacity,
                      beta=self.tc.sample_beta)

    def _update(self, batch: SampleBatch, reweight_by_psi: bool) -> dict:
        return vmc_update(self.model, self.optimizer, self.scheduler, self.dt, batch,
                          reweight_by_psi, clip=self.clip, table=self._table,
                          fwd_chunk=self.tc.eloc_fwd_chunk)

    def _record_samples(self, batch: SampleBatch, n_unq: int):
        """Every RECORD_FREQ-th step, add the batch's n_unq live states to the
        counter."""
        if self.n_steps % self.RECORD_FREQ:
            return
        # one copy of the fixed-shape buffers (the counts' bits beside the
        # states), sliced on the host
        both = torch.stack([batch.states, batch.counts.view(torch.int64)]).cpu().numpy()
        self._record_arrays(both[0, :n_unq], both[1, :n_unq].view(np.float64))

    def _record_arrays(self, states: np.ndarray, counts: np.ndarray):
        """Add each state's count to the counter, in the batch's order (the
        dict, its order and its float sums are those of a per-state loop);
        past COUNTER_MAX distinct states keep the top half."""
        keys = states.tolist()
        got = map(self.sampled_counter.get, keys, repeat(0.0))
        self.sampled_counter.update(zip(keys, map(add, got, counts.tolist())))
        if len(self.sampled_counter) > self.COUNTER_MAX:
            keys, vals = self._counter_arrays()
            keep = np.argpartition(vals, -self.COUNTER_MAX // 2)[-self.COUNTER_MAX // 2:]
            self.sampled_counter = dict(zip(keys[keep].tolist(), vals[keep].tolist()))

    def _counter_arrays(self):
        """(states int64, counts f64) of the counter, in its order."""
        n = len(self.sampled_counter)
        return (np.fromiter(self.sampled_counter.keys(), dtype=np.int64, count=n),
                np.fromiter(self.sampled_counter.values(), dtype=np.float64, count=n))

    def get_samples(self, max_retries: int = 12) -> SampleBatch:
        """Sample with the adaptive controller until the unique count sits
        inside the window (or a bound on n_samples is reached)."""
        return self._get_samples(max_retries)[0]

    def _get_samples(self, max_retries: int = 12):
        """`get_samples`, with the batch's unique count as read back: (batch,
        n_unique)."""
        last_action = 0
        for _ in range(max_retries):
            batch = self._sample()
            n_unq_d, overflow = torch.stack(
                [batch.n_unique.to(torch.float64),
                 batch.overflow.to(torch.float64)]).cpu().tolist()
            overflow = bool(overflow)
            n_unq = int(n_unq_d) if not overflow else self.capacity + 1
            action = -1 if overflow else 0
            at_min = self.n_samples <= self.tc.n_unq_samples_min
            at_max = self.n_samples >= self.tc.n_samples_max
            if (not at_min and not at_max) or overflow:
                if (n_unq < self.tc.n_unq_samples_min and last_action >= 0
                        and not overflow and not self._grow_blocked()):
                    action = 1
                    self.n_samples = min(self.n_samples * 10, self.tc.n_samples_max)
                elif (n_unq > self.tc.n_unq_samples_max and last_action <= 0) or overflow:
                    action = -1
                    if overflow:
                        self._note_overflow()
                    self.n_samples = max(self.n_samples / 10, self.tc.n_unq_samples_min)
            if action == 0:
                return batch, n_unq
            last_action = action
        raise RuntimeError(
            "sample-count controller did not converge: capacity "
            f"{self.capacity} too small for this wavefunction's support?")

    def _log_step(self, e_loc: float, e_loc_var: float, n_unq: int):
        self.log["E_LOC"].append((self.n_steps, e_loc))
        self.log["E_LOC_VAR"].append((self.n_steps, e_loc_var))
        self.log["N_UNIQUE_SAMP"].append((self.n_steps, n_unq))
        self.log["TIME"].append((self.n_steps, self.run_time))

    def _step_fused(self, max_retries: int = 12) -> dict:
        """Sample and update back to back with ONE host readback. On overflow
        the update was withheld; back off with sample-only probes, then run
        the one update on the batch that fits. Unique-count window changes
        apply to the NEXT step."""
        t0 = time.time()
        batch = self._sample()
        m = self._update(batch, self.tc.reweight_by_psi)
        if m["overflow"]:
            for _ in range(max_retries):
                self._note_overflow()
                self.n_samples = max(self.n_samples / 10, self.tc.n_unq_samples_min)
                batch = self._sample()
                if not bool(batch.overflow):
                    break
            else:
                raise RuntimeError(
                    "sample-count controller did not converge: capacity "
                    f"{self.capacity} too small for this wavefunction's support?")
            m = self._update(batch, self.tc.reweight_by_psi)
            assert not m["overflow"]
        n_unq = m["n_unique"]
        at_max = self.n_samples >= self.tc.n_samples_max
        at_min = self.n_samples <= self.tc.n_unq_samples_min
        if (n_unq < self.tc.n_unq_samples_min and not at_max
                and not self._grow_blocked()):
            self.n_samples = min(self.n_samples * 10, self.tc.n_samples_max)
        elif n_unq > self.tc.n_unq_samples_max and not at_min:
            self.n_samples = max(self.n_samples / 10, self.tc.n_unq_samples_min)
        self._record_samples(batch, n_unq)
        self.n_steps += 1
        dt_step = time.time() - t0
        self.run_time += dt_step
        out = {"e_loc": m["e_loc"], "e_loc_var": m["e_loc_var"],
               "n_unique": n_unq, "n_samples": self.n_samples, "time": dt_step,
               "grad_norm": m["grad_norm"], "clip_scale": m["clip_scale"]}
        self._log_step(out["e_loc"], out["e_loc_var"], n_unq)
        return out

    def _make_sharded_step(self):
        """The data-parallel step of this trainer's optimizer
        (`parallel/step.py`) on this rank's share of the capacity; the
        kernels are built by rank 0 first, while the others wait."""
        import torch.distributed as dist

        from naqs_tpu_torch.parallel import step as pstep

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            if self.rank == 0:
                from naqs_tpu_torch.ops._build import build_all

                build_all()
            dist.barrier()
        tc = self.tc
        cap = max(64, self.capacity // self.n_devices)
        if tc.use_sr:
            return pstep.make_sharded_sr_step(self.model, cap, tc.sr_cg_iters,
                                              tc.reweight_by_psi, tc.sr_kl_clip,
                                              tc.sr_fisher_mix)
        if tc.use_kfac:
            return pstep.make_sharded_kfac_step(self.model, cap)
        return pstep.make_sharded_train_step(self.model, cap, self._table, tc.eloc_fwd_chunk,
                                             tc.reweight_by_psi, tc.sample_beta)

    def _step_sharded(self, max_retries: int = 12) -> dict:
        """One data-parallel step: each rank samples its share, cut to the
        longest live prefix of any rank, and the update runs over every
        rank's rows (`parallel/step.py`); one readback after the sampling
        (overflow, the cut) and one of the update's metrics. Where any rank
        overflowed no update runs: the controller backs n_samples off and
        the step is redone. The merged buffer feeds the sampled-state
        counter every RECORD_FREQ steps."""
        t0 = time.time()
        tc = self.tc
        for _ in range(max_retries):
            window = None
            if tc.use_sr:
                m = self._sharded(self.dt, self.gen, self.n_samples, self._current_lr(),
                                  tc.sr_damping)
            elif tc.use_kfac:
                if self.kfac_state is None:
                    self.kfac_state = kfac_init(self.model)
                self.kfac_state, m = self._sharded(
                    self.kfac_state, self.dt, self.gen, self.n_samples, self._current_lr(),
                    tc.kfac_damping, tc.kfac_decay, tc.kfac_kl_clip)
            else:
                window = UpdateWindow(self.model, self.optimizer, self.scheduler, 1, self.clip)
                m = self._sharded(window, self.dt, self.gen, self.n_samples)
            if m is not None:   # else some rank overflowed, and no update ran
                scalars = {k: v for k, v in m.items() if not k.startswith("rec_")}
                keys = [*scalars, "rec_n_valid"]
                vals = dict(zip(keys, torch.stack(
                    [m[k].to(torch.float64) for k in keys]).cpu().tolist()))
            overflow = m is None or bool(vals["overflow"])
            if window is not None:
                window.settle(0 if overflow else 1)
            if not overflow:
                break
            self._note_overflow()
            self.n_samples = max(self.n_samples / 10, tc.n_unq_samples_min)
        else:
            raise RuntimeError(
                "sharded sample-count controller did not converge: capacity "
                f"{self.capacity} too small for this wavefunction's support?")
        n_unq = int(vals["n_unique"])
        if (n_unq < tc.n_unq_samples_min and self.n_samples < tc.n_samples_max
                and not self._grow_blocked()):
            self.n_samples = min(self.n_samples * 10, tc.n_samples_max)
        elif n_unq > tc.n_unq_samples_max:
            self.n_samples = max(self.n_samples / 10, tc.n_unq_samples_min)
        if self.n_steps % self.RECORD_FREQ == 0:
            nv = int(vals["rec_n_valid"])
            both = torch.stack([m["rec_states"][:nv],
                                m["rec_counts"][:nv].view(torch.int64)]).cpu().numpy()
            self._record_arrays(both[0], both[1].view(np.float64))
        self.n_steps += 1
        dt_step = time.time() - t0
        self.run_time += dt_step
        out = {**{k: vals[k] for k in scalars if k not in ("overflow", "n_unique")},
               "n_unique": n_unq, "n_samples": self.n_samples, "time": dt_step}
        if "cg_iters" in out:
            out["cg_iters"] = int(out["cg_iters"])
        self._log_step(out["e_loc"], out["e_loc_var"], n_unq)
        return out

    def _replicate(self):
        """Make every rank's model, optimizer state and clip ring rank 0's:
        after work that each rank does on its own (warm starts, exact and
        density training), which may round differently on each card, or, for
        a warm start from a sampled subspace, draw another subspace."""
        if self.n_devices == 1:
            return
        import torch.distributed as dist

        tensors = [p.data for p in self.model.parameters()]
        tensors += [v for st in self.optimizer.state.values() for k, v in sorted(st.items())
                    if torch.is_tensor(v) and v.device == self.device]
        if self.clip is not None:
            tensors += [self.clip.norms, self.clip.count]
        if self.kfac_state is not None:
            tensors += _leaves(self.kfac_state)
        for t in tensors:
            dist.broadcast(t, src=0)

    def _current_lr(self) -> float:
        """The natural-gradient updates' LR: the two-phase schedule keyed on
        the steps taken (Adam's counts applied updates)."""
        if not self.tc.use_lr_schedule:
            return self.tc.lr
        return self.tc.lr if self.n_steps < max(self.tc.n_train // 2, 1) else self.tc.lr_final

    def step(self) -> dict:
        if self._sharded is not None:
            return self._step_sharded()
        if not (self.tc.use_sr or self.tc.use_kfac):
            return self._step_fused()
        t0 = time.time()
        batch, n_unq = self._get_samples()
        self._record_samples(batch, n_unq)
        # the rows past n_unique carry zero weight in every sum: the update's
        # model passes run over the live rows only
        n = max(n_unq, 1)
        live = SampleBatch(batch.states[:n], batch.counts[:n], batch.n_unique, batch.overflow)
        tc = self.tc
        if tc.use_sr:
            m = sr_update(self.model, self.dt, live, self._current_lr(), tc.sr_damping,
                          cg_iters=tc.sr_cg_iters, reweight_by_psi=tc.reweight_by_psi,
                          kl_clip=tc.sr_kl_clip, fisher_mix=tc.sr_fisher_mix,
                          table=self._table, fwd_chunk=tc.eloc_fwd_chunk)
        else:
            if self.kfac_state is None:
                self.kfac_state = kfac_init(self.model)
            self.kfac_state, m = kfac_update(self.model, self.kfac_state, self.dt, live,
                                             self._current_lr(), tc.kfac_damping,
                                             tc.kfac_decay, tc.kfac_kl_clip)
        self.n_steps += 1
        # the step's one readback
        vals = torch.stack([v.to(torch.float64) for v in m.values()]).cpu().tolist()
        dt_step = time.time() - t0
        self.run_time += dt_step
        out = {**dict(zip(m, vals)), "n_unique": n_unq, "n_samples": self.n_samples,
               "time": dt_step}
        if "cg_iters" in out:
            out["cg_iters"] = int(out["cg_iters"])
        self._log_step(out["e_loc"], out["e_loc_var"], n_unq)
        return out

    @torch.no_grad()
    def exact_energy(self) -> float:
        """Exact <psi|H|psi>/<psi|psi> over the full restricted basis, of the
        physical H (dt_h) also when training on another operator."""
        basis = torch.as_tensor(self.hilbert.basis, device=self.device)
        la, ph = log_psi(self.model, basis)
        return float(quadratic_energy(self.dt_h, basis, la, ph, basis.shape[0]))

    def run(self, n_epochs: int, output_freq: int = 25,
            log_exact_energy: bool = False, save_freq: Optional[int] = None,
            callback=None):
        for _ in range(n_epochs):
            out = self.step()
            if self.n_steps % output_freq == 0 or self.n_steps == 1:
                if log_exact_energy:
                    out["e_exact"] = self.exact_energy()
                    self.log["E"].append((self.n_steps, out["e_exact"]))
                recent = [v for _, v in self.log["E_LOC"][-output_freq:]]
                e_part = f"E={out['e_exact']:.6f}, " if "e_exact" in out else ""
                if self.rank == 0:   # the ranks' logs are the same
                    print(f"step {self.n_steps}: <E_loc>={np.mean(recent):.6f} "
                          f"+/- {np.std(recent):.6f}, var={out['e_loc_var']:.6f}, "
                          f"unq={out['n_unique']}, n_samp={out['n_samples']:.2e}, "
                          f"{e_part}t={out['time']*1000:.0f}ms", flush=True)
            if save_freq and self.save_loc and self.n_steps % save_freq == 0:
                self.save()
            if callback is not None:
                callback(self, out)
        return self

    # -- density sampling
    def get_density_samples(self, max_retries: int = 12):
        """(batch, n_unique): every state of probability mass >= d_p, with d_p
        scaled x/÷10 (capped at 0.5, floored at 1e-16) until the support
        fits the unique-sample window."""
        for _ in range(max_retries):
            batch = sample_density(self.model, self.d_p, self.capacity)
            n_unq, overflow = torch.stack([batch.n_unique.to(torch.float64),
                                           batch.overflow.to(torch.float64)]).cpu().tolist()
            n_unq = int(n_unq)
            if overflow or n_unq > self.tc.n_unq_samples_max:
                self.d_p = min(self.d_p * 10.0, 0.5)
                continue
            if n_unq < self.tc.n_unq_samples_min and self.d_p > 1e-16:
                self.d_p = self.d_p / 10.0
                continue
            return batch, n_unq
        raise RuntimeError(f"density threshold controller did not converge (d_p={self.d_p})")

    def run_density(self, n_epochs: int, output_freq: int = 25,
                    d_p: Optional[float] = None):
        """Train on the deterministically enumerated high-mass support, with
        |psi|^2 weights over it."""
        if d_p is not None:
            self.d_p = float(d_p)
        for _ in range(n_epochs):
            t0 = time.time()
            batch, n_unq = self.get_density_samples()
            self._record_samples(batch, n_unq)
            m = self._update(batch, True)
            self.n_steps += 1
            self.run_time += time.time() - t0
            self._log_step(m["e_loc"], m["e_loc_var"], n_unq)
            if self.n_steps % output_freq == 0 or self.n_steps == 1:
                print(f"step {self.n_steps}: <E>={m['e_loc']:.6f} "
                      f"var={m['e_loc_var']:.6f} unq={n_unq} d_p={self.d_p:.2e}",
                      flush=True)
        self._replicate()
        return self

    def _basis_batch(self, states: np.ndarray) -> SampleBatch:
        """A batch of the given basis states, sorted, each with count 1."""
        states = np.sort(states)
        n = len(states)
        return SampleBatch(states=torch.as_tensor(states, device=self.device),
                           counts=torch.ones((n,), dtype=torch.float64, device=self.device),
                           n_unique=torch.full((), n, dtype=torch.int64, device=self.device),
                           overflow=torch.zeros((), dtype=torch.bool, device=self.device))

    def _log_exact(self, e: float, v: float, nu: int, output_freq: int):
        self._log_step(e, v, nu)
        if self.n_steps % output_freq == 0 or self.n_steps == 1:
            print(f"step {self.n_steps}: <E>={e:.6f} var={v:.6f}", flush=True)

    def run_exact(self, n_epochs: int, output_freq: int = 25,
                  batch_size: Optional[int] = None, save_freq: Optional[int] = None):
        """Train with exact |psi|^2 weights over the whole restricted basis
        (exact-sampling training). Full-basis mode (no `batch_size`, or one
        not below the basis): the batch is the sorted basis, each state with
        count 1, and the steps run EXACT_FLUSH at a time in `vmc_update_scan`
        windows, one readback each; a checkpoint is written after a window
        that reached a multiple of save_freq. With `batch_size`, each step is
        one `vmc_update` on a minibatch of basis states drawn without
        replacement by np.random.default_rng(seed + 1) (the same draws as the
        JAX package), with exact local energies where the trainer has its
        sector table. The JAX package caps a window at 3e6 state-steps and
        halves it after a run that died inside one (its in-flight sentinel
        file): both work around a fault of a TPU worker, and neither is
        kept here."""
        basis = self.hilbert.basis
        rng = np.random.default_rng(self.tc.seed + 1)
        if not batch_size or batch_size >= len(basis):
            full = self._basis_batch(basis)
            done = 0
            while done < n_epochs:
                k = min(self.EXACT_FLUSH, n_epochs - done)
                t0 = time.time()
                ms, _ = vmc_update_scan(self.model, self.optimizer, self.scheduler, self.dt,
                                        full, k, length=self.EXACT_FLUSH, clip=self.clip)
                wall = (time.time() - t0) / k
                for i in range(k):
                    self.n_steps += 1
                    self.run_time += wall
                    self._log_exact(float(ms[i, 0]), float(ms[i, 1]), len(basis), output_freq)
                done += k
                if save_freq and self.save_loc and (self.n_steps % save_freq) < k:
                    self.save()
            self._replicate()
            return self
        for _ in range(n_epochs):
            t0 = time.time()
            batch = self._basis_batch(basis[rng.choice(len(basis), size=batch_size,
                                                       replace=False)])
            m = self._update(batch, True)
            self.n_steps += 1
            self.run_time += time.time() - t0
            self._log_exact(m["e_loc"], m["e_loc_var"], batch_size, output_freq)
            if save_freq and self.save_loc and self.n_steps % save_freq == 0:
                self.save()
        self._replicate()
        return self

    # -- warm starts (each with its own plain Adam, optax.adam(lr)'s defaults)
    def pre_flatten(self, n_epochs: int, lr: float = 1e-3, batch_size: int = 2**17):
        """MSE of the log-amplitudes to log(1/sqrt(|basis|)) over the basis,
        in batches of the permutations np.random.default_rng(seed) draws."""
        basis = self.hilbert.basis
        target = float(math.log(1.0 / math.sqrt(len(basis))))
        opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        n = len(basis)
        bs = min(batch_size, n)
        n_batches = -(-n // bs)
        pad = n_batches * bs - n
        basis_p = np.concatenate([basis, basis[:pad]]) if pad else basis
        rng = np.random.default_rng(self.tc.seed)
        report = max(1, n_epochs // 10)
        mse = lambda m, s: torch.mean((log_psi(m, s)[0] - target) ** 2)
        for ep in range(n_epochs):
            perm = rng.permutation(len(basis_p))
            for b in range(n_batches):
                sl = torch.as_tensor(basis_p[perm[b * bs:(b + 1) * bs]], device=self.device)
                loss = _adam_step(self.model, opt, lambda m: mse(m, sl))
            if (ep + 1) % report == 0 or ep + 1 == n_epochs:
                print(f"pre_flatten: epoch {ep + 1}/{n_epochs}, loss={float(loss):.6f}",
                      flush=True)
        self._replicate()
        return self

    def pre_train_hf(self, n_epochs: int, lr: float = 5e-3):
        """Binary cross-entropy towards the Hartree-Fock state, in log space:
        la clamped to <= -1e-7 (clamping exp(la) instead would zero the
        gradient of a deep model, whose fresh amplitudes are tiny)."""
        opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        states = torch.tensor([self.hilbert.hf_state()], dtype=torch.int64, device=self.device)
        target = torch.ones((1,), dtype=torch.float32, device=self.device)

        def bce(m):
            la = torch.clamp(log_psi(m, states)[0], max=-1e-7)
            return torch.mean(-(target * la + (1 - target) * torch.log1p(-torch.exp(la))))

        for _ in range(n_epochs):
            _adam_step(self.model, opt, bce)
        self._replicate()
        return self

    def pre_train_targets(self, states: np.ndarray, target_psi: np.ndarray,
                          n_epochs: int, lr: float = 5e-3,
                          mag_floor: float = 1e-8, loss: str = "mse"):
        """Supervised warm start towards given complex amplitudes on given
        states. `loss`: "mse" (log|psi| by MSE up to a common constant, the
        phase by a cosine loss, every state alike), "wmse" (the same weighted
        by |target|^2 mixed with 5% uniform), or "overlap" (the log-infidelity
        log <psi_S|psi_S> - log |<t|psi>|^2 over the fitted set S).
        `mag_floor` (mse) clamps |target|/max|target| from below. Returns the
        last epoch's loss."""
        states = np.asarray(states, dtype=np.int64)
        order = np.argsort(states)
        states = states[order]
        t = np.asarray(target_psi)[order]
        mag = np.abs(t)
        mag = np.maximum(mag / max(mag.max(), 1e-300), mag_floor)
        put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        la_t, ph_t = put(np.log(mag)), put(np.angle(t))
        w_t = np.abs(t) ** 2
        w_t = w_t / max(w_t.sum(), 1e-300)
        w_t = put(0.95 * w_t + 0.05 / len(t))
        s_dev = torch.as_tensor(states, device=self.device)
        opt = torch.optim.Adam(self.model.parameters(), lr=lr)

        def loss_fn(m):
            la, ph = log_psi(m, s_dev)
            if loss == "overlap":
                mx = la.max().detach()
                r = torch.exp(la - mx)
                norm = torch.log(torch.sum(r * r))
                dph = ph - ph_t
                ov_re = torch.sum(torch.exp(la_t) * r * torch.cos(dph))
                ov_im = torch.sum(torch.exp(la_t) * r * torch.sin(dph))
                return norm - torch.log(ov_re ** 2 + ov_im ** 2 + 1e-300)
            if loss == "wmse":
                d = la - la_t
                d = d - torch.sum(w_t * d)
                return torch.sum(w_t * d * d) + torch.sum(w_t * (1.0 - torch.cos(ph - ph_t)))
            d = la - la_t
            return (torch.mean((d - torch.mean(d)) ** 2)
                    + torch.mean(1.0 - torch.cos(ph - ph_t)))

        report = max(1, n_epochs // 15)
        for ep in range(n_epochs):
            loss_v = _adam_step(self.model, opt, loss_fn)
            if (ep + 1) % report == 0 or ep + 1 == n_epochs:
                print(f"pre_train_targets: epoch {ep + 1}/{n_epochs}, "
                      f"loss={float(loss_v):.6f}", flush=True)
        self._replicate()
        return float(loss_v)

    def _subspace(self, states, use_counter: bool, k_max: int, n_samps):
        """The states solve_h diagonalizes over: `states` if given, else the
        counter's top k_max, else the top k_max of one fresh sample."""
        if states is not None:
            return np.sort(np.asarray(states, dtype=np.int64))
        if use_counter and self.sampled_counter:
            keys, vals = self._counter_arrays()
            if len(keys) > k_max:
                keys = keys[np.argpartition(vals, -k_max)[-k_max:]]
            return np.sort(keys)
        batch = sample(self.model, self.gen, n_samps or self.n_samples, self.capacity)
        nu = int(batch.n_unique)
        states = batch.states.cpu().numpy()[:nu]
        counts = batch.counts.cpu().numpy()[:nu]
        if nu > k_max:
            states = np.sort(states[np.argsort(counts)[-k_max:]])
        return states

    def warm_start_from_solve_h(self, n_epochs: int = 500, n_samps: Optional[float] = None,
                                k_max: int = 10000, lr: float = 2e-3,
                                select_min: float = 1e-4,
                                states: Optional[np.ndarray] = None,
                                target_s2: Optional[float] = None,
                                loss: str = "mse"):
        """Re-target the model at the ground state of H restricted to the
        sampled subspace (or to `states`): diagonalize on the host, then
        pre_train_targets towards the eigenvector. With "mse" only entries
        with |v| > select_min * max|v| are fitted; "overlap" and "wmse" see
        every state. An explicit subspace of more than 50,000 states caches
        its eigenpair under data/ws_cache/ (relative to the working
        directory), keyed by a sha1 of the states and every term array.
        Returns (E0, n_states)."""
        explicit_states = states is not None
        states = self._subspace(states, True, k_max, n_samps)
        cache = None
        if explicit_states and len(states) > 50_000:
            h = hashlib.sha1(states.tobytes())
            for arr in (self.terms.coeff, self.terms.xy_unique, self.terms.yz_unique,
                        self.terms.gxy, self.terms.gyz, self.terms.diag_yz,
                        self.terms.diag_coeff):
                h.update(np.ascontiguousarray(arr).tobytes())
            h.update(np.float64(target_s2 if target_s2 is not None else -1))
            cache = os.path.join("data", "ws_cache", h.hexdigest()[:16] + ".npz")
        if cache and os.path.exists(cache):
            with np.load(cache) as z:
                e0, vec = float(z["e0"]), z["vec"]
            print(f"solve_h warm start: loaded cached eigenvector ({len(states)} states, "
                  f"E0={e0:.6f}) from {cache}", flush=True)
        else:
            H = assemble_sparse_hamiltonian_np(self.terms, states)
            e0, vec = self._lowest_state(H, states, target_s2)
            if cache and self.rank == 0:
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                np.savez(cache, e0=e0, vec=vec)
        if loss in ("overlap", "wmse"):
            keep = np.ones(len(vec), bool)
        else:
            keep = np.abs(vec) > select_min * np.abs(vec).max()
            if keep.sum() < 2:  # degenerate fit target: fall back to all
                keep = np.ones(len(vec), bool)
        self.pre_train_targets(states[keep], vec[keep].astype(np.complex128),
                               n_epochs, lr=lr, loss=loss)
        if explicit_states:
            # only an explicit subspace's E0 is reusable as the final
            # "VMC+FCI"; a counter subspace's is tied to its moment
            self.ws_result = (float(e0), len(states))
        return float(e0), len(states)

    def _lowest_state(self, H, states, target_s2):
        """(e0, eigenvector) of sparse H, optionally spin-selected."""
        from scipy.sparse.linalg import eigsh

        if target_s2 is not None and H.shape[0] >= 3:
            from naqs_tpu_torch.utils.spin import lowest_eig_with_spin

            e0, vec, s2_list, idx = lowest_eig_with_spin(
                H, states, self.hilbert.n_qubits, target_s2=target_s2)
            if idx is None:
                print(f"solve_h: no eigenstate with <S^2>~{target_s2} in "
                      f"lowest {len(s2_list)} (s2={np.round(s2_list, 2)}); "
                      "using ground state", flush=True)
            elif idx > 0:
                print(f"solve_h: spin-selected eigenstate #{idx} "
                      f"(s2={np.round(s2_list, 2)})", flush=True)
        elif H.shape[0] < 3:
            w, v = np.linalg.eigh(H.toarray())
            vec, e0 = v[:, 0], w[0]
        else:
            w, v = eigsh(H, k=1, which="SA")
            vec, e0 = v[:, 0], w[0]
        return e0, vec

    def solve_h(self, n_samps: Optional[float] = None, k_max: int = 10000,
                use_counter: bool = True, target_s2: Optional[float] = None,
                states: Optional[np.ndarray] = None):
        """Diagonalize H restricted to the k_max most-sampled states of the
        training history ("VMC+FCI"); one fresh sample without a history;
        `states` overrides both. Returns (energy, n_states)."""
        from scipy.sparse.linalg import eigsh

        states = self._subspace(states, use_counter, k_max, n_samps)
        nu = len(states)
        H = assemble_sparse_hamiltonian_np(self.terms, states)
        if H.shape[0] < 3:
            return float(np.linalg.eigvalsh(H.toarray())[0]), nu
        if target_s2 is not None:
            from naqs_tpu_torch.utils.spin import lowest_eig_with_spin

            e0 = lowest_eig_with_spin(H, states, self.hilbert.n_qubits,
                                      target_s2=target_s2)[0]
            return float(e0), nu
        return float(eigsh(H, k=1, which="SA")[0][0]), nu

    def save_log(self, fname: str = "log") -> str:
        """Write the metrics as <fname>.jsonl (and <fname>.pkl where pandas
        imports; `utils/profiling.save_log`)."""
        from naqs_tpu_torch.utils.profiling import save_log

        assert self.save_loc, "save_loc not set"
        path = os.path.join(self.save_loc, fname)
        if self.rank:   # rank 0 alone writes
            return path + ".jsonl"
        os.makedirs(self.save_loc, exist_ok=True)
        return save_log(self.log, path)

    # -- checkpoints
    def save(self, fname: str = "checkpoint") -> str:
        """Write <fname>.pt (the model, Adam, LR-schedule and clip state, K-FAC's
        running factors and the generator's state, torch.save), then <fname>_counter.npz and
        <fname>_log.npz, then <fname>.json, which commits the checkpoint. In
        a group every rank calls it: the ranks' generator states are gathered
        (each rank draws its own batches, and resumes its own stream), and
        rank 0 writes. The last three have the JAX package's layout, so either package reads
        them."""
        assert self.save_loc, "save_loc not set"
        path = os.path.join(self.save_loc, f"{fname}.pt")
        gens = None
        if self.n_devices > 1:   # every rank's own stream, gathered (a collective)
            from naqs_tpu_torch.parallel.comm import all_gather_rows

            gens = [g.clone() for g in   # each a tensor of its own (set_state needs it)
                    all_gather_rows(self.gen.get_state()[None].to(self.device)).cpu()]
        if self.rank:   # rank 0 alone writes: the ranks' other states are the same
            return path
        os.makedirs(self.save_loc, exist_ok=True)
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": self.scheduler.state_dict(),
                    "clip": None if self.clip is None else self.clip.state_dict(),
                    "kfac": self.kfac_state,
                    "generator": self.gen.get_state(), "generators": gens}, path)
        if self.sampled_counter:
            keys, vals = self._counter_arrays()
            if len(keys) > self.COUNTER_SAVE_MAX:
                top = np.argpartition(vals, -self.COUNTER_SAVE_MAX)[-self.COUNTER_SAVE_MAX:]
                keys, vals = keys[top], vals[top]
            np.savez_compressed(os.path.join(self.save_loc, f"{fname}_counter.npz"),
                                states=keys.astype(np.uint64), counts=vals)
        log_arrays = {}
        for k, v in self.log.items():
            a = np.asarray(v, dtype=np.float64).reshape(-1, 2)
            log_arrays[f"{k}__steps"] = a[:, 0]
            log_arrays[f"{k}__vals"] = a[:, 1]
        np.savez_compressed(os.path.join(self.save_loc, f"{fname}_log.npz"), **log_arrays)
        meta = {"n_steps": self.n_steps, "run_time": self.run_time,
                "n_samples": self.n_samples, "d_p": self.d_p, "ws_result": self.ws_result}
        with open(os.path.join(self.save_loc, f"{fname}.json"), "w") as f:
            json.dump(meta, f)
        return path

    def _load_generator(self, state: torch.Tensor, ranks_states) -> None:
        """This rank's generator from a checkpoint: its own saved stream where
        the checkpoint holds one a rank of a group this size; else, in a
        group, a stream per rank drawn from the saved one (`rank_generator`),
        so that the ranks never draw the same batches."""
        if self.n_devices == 1:
            self.gen.set_state(state)
        elif ranks_states is not None and len(ranks_states) == self.n_devices:
            self.gen.set_state(ranks_states[self.rank])
        else:
            from naqs_tpu_torch.parallel.multihost import rank_generator

            seed = int.from_bytes(hashlib.sha256(state.numpy().tobytes()).digest()[:8], "little")
            self.gen = rank_generator(seed, self.rank, self.device)

    def load(self, fname: str = "checkpoint", params_only: bool = False):
        """Restore a checkpoint: the port's <fname>.pt, or where there is none
        the JAX package's <fname>.msgpack (its parameters, and unless
        params_only its Adam moments and count, LR-schedule count and clip
        ring, and K-FAC's running factors from <fname>_kfac.msgpack where
        that exists). `params_only` restores the model alone and starts fresh
        optimizer state. A JAX checkpoint's PRNG key cannot seed a torch
        generator: after loading one, the generator keeps its own state."""
        pt = os.path.join(self.save_loc, f"{fname}.pt")
        if os.path.exists(pt):
            ckpt = torch.load(pt, map_location="cpu")
            self.model.load_state_dict(ckpt["model"])
            self._new_optimizer()
            if params_only:
                return self
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self.scheduler.load_state_dict(ckpt["scheduler"])
            if (ckpt["clip"] is None) != (self.clip is None):
                raise ValueError("the checkpoint's gradient clip does not match this trainer's")
            if self.clip is not None:
                self.clip.load_state_dict(ckpt["clip"])
            self.kfac_state = _to_device(ckpt.get("kfac"), self.device)
            self._load_generator(ckpt["generator"], ckpt.get("generators"))
        else:
            with open(os.path.join(self.save_loc, f"{fname}.msgpack"), "rb") as f:
                state = read_flax_msgpack(f.read())
            self._load_jax_state(state, params_only)
            if params_only:
                return self
            kfac_path = os.path.join(self.save_loc, f"{fname}_kfac.msgpack")
            if os.path.exists(kfac_path):
                with open(kfac_path, "rb") as f:
                    self.kfac_state = _to_device(
                        kfac_state_from_jax(read_flax_msgpack(f.read())), self.device)
        counter_path = os.path.join(self.save_loc, f"{fname}_counter.npz")
        if os.path.exists(counter_path):
            with np.load(counter_path) as z:
                self.sampled_counter = dict(zip(z["states"].tolist(), z["counts"].tolist()))
        meta_path = os.path.join(self.save_loc, f"{fname}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.n_steps = meta["n_steps"]
            self.run_time = meta["run_time"]
            self.n_samples = meta["n_samples"]
            self.d_p = meta.get("d_p", self.d_p)
            ws = meta.get("ws_result")
            self.ws_result = tuple(ws) if ws else None
            log_path = os.path.join(self.save_loc, f"{fname}_log.npz")
            if os.path.exists(log_path):
                with np.load(log_path) as z:
                    for k in {n.rsplit("__", 1)[0] for n in z.files}:
                        self.log[k] = list(zip(z[f"{k}__steps"].astype(np.int64).tolist(),
                                               z[f"{k}__vals"].tolist()))
        return self

    def _load_jax_state(self, state: dict, params_only: bool):
        """Parameters (and Adam, schedule and clip state) of a JAX package
        checkpoint's state dict."""
        named = dict(self.model.named_parameters())
        self.model.load_state_dict(params_from_jax(jax_params(state["params"])))
        self._new_optimizer()
        if params_only:
            return
        parts = optax_parts(state["opt_state"])
        has_lut = len(self.optimizer.param_groups) > 1
        if ("adam" not in parts or ("clip" in parts) != (self.clip is not None)
                or ("adam_lut" in parts) != has_lut):
            raise ValueError("the checkpoint's optimizer chain does not match this trainer's")
        # optax.multi_transform keeps one Adam a label, "mlp" and "lut"; each
        # holds moments for its own parameters only
        mu, nu, steps = {}, {}, {}
        for adam in [parts["adam"]] + ([parts["adam_lut"]] if has_lut else []):
            got = params_from_jax(jax_params(adam["mu"]))
            mu.update(got)
            nu.update(params_from_jax(jax_params(adam["nu"])))
            steps.update(dict.fromkeys(got, int(adam["count"])))
        for name, p in named.items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(steps[name]), dtype=torch.float32),
                "exp_avg": mu[name].to(p.device), "exp_avg_sq": nu[name].to(p.device)}
        # the schedule counts applied updates, as the scheduler's last_epoch
        _set_schedule(self.optimizer, self.scheduler,
                      int(parts["schedule"]["count"]) if "schedule" in parts
                      else int(parts["adam"]["count"]))
        if self.clip is not None:
            self.clip.load_state_dict(parts["clip"])


@torch.no_grad()
def save_psi(trainer: VMCTrainer, fname: str, normalise: bool = True,
             max_states: int = 1_000_000) -> str:
    """Write the amplitudes and phases over the restricted basis, largest
    amplitude first: <fname>.txt (amp, phase rows), <fname>_basis.txt (the
    occupation bits) and <fname>_basis_idxs.txt (basis indices)."""
    basis = trainer.hilbert.basis
    if len(basis) > max_states:
        raise ValueError(f"basis too large to dump ({len(basis)} > {max_states})")
    if trainer.rank:   # rank 0 alone writes
        return fname
    la, ph = log_psi(trainer.model, torch.as_tensor(basis, device=trainer.device))
    la = la.cpu().numpy().astype(np.float64)
    ph = ph.cpu().numpy().astype(np.float64)
    amps = np.exp(la - la.max())
    if normalise:
        amps = amps / np.sqrt(np.sum(amps**2))
    order = np.argsort(amps)[::-1]
    np.savetxt(f"{fname}.txt", np.stack([amps[order], ph[order]], 1), fmt="%.6e")
    np.savetxt(f"{fname}_basis.txt", np_unpack_bits(basis[order], trainer.cfg.n_qubits),
               fmt="%i")
    np.savetxt(f"{fname}_basis_idxs.txt", order, fmt="%i")
    return fname
