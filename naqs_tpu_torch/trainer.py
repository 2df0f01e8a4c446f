"""VMC training: surrogate loss, Adam, adaptive sample-count controller.

Port of the default sampled step of `naqs_tpu/trainer.py`
(`VMCTrainer.run` -> `_step_fused`):

  * surrogate loss 2 * sum_s w_s [log|psi| * Re(dE) + arg(psi) * Im(dE)]
    with dE = E_loc - <E_loc> held constant, weights in f64 from sample
    counts or from |psi|^2 (reweight_by_psi);
  * torch.optim.Adam (betas 0.9/0.99, eps 1e-15; its update
    m_hat / (sqrt(v_hat) + eps) equals optax.adam's) with a two-phase LR;
  * the update is withheld on capacity overflow or any non-finite loss,
    gradient norm or energy: the decision is read back with the step's one
    host sync, before optimizer.step() mutates parameters or Adam state;
  * the host sample-count controller: x10 when too few unique samples,
    /10 on too many or on overflow, with overflow hysteresis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from naqs_tpu_torch.hamiltonian import PauliTerms
from naqs_tpu_torch.models.nade import NADE, NAQSConfig, log_psi
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy, quadratic_energy
from naqs_tpu_torch.sampler import SampleBatch, sample
from naqs_tpu_torch.utils.device import resolve_device
from naqs_tpu_torch.utils.hilbert import Hilbert


@dataclass(frozen=True)
class TrainConfig:
    n_train: int = 5000
    lr: float = 1e-3
    lr_final: float = 5e-4          # second-phase LR
    use_lr_schedule: bool = True
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
    grad_clip_factor: Optional[float] = None
    n_samples: float = 1e6
    n_samples_max: float = 1e12
    n_unq_samples_min: int = 1000
    n_unq_samples_max: int = 4096   # also the device buffer capacity
    reweight_by_psi: bool = False
    sample_beta: float = 1.0        # tempered sampling; pair with reweight_by_psi
    exact_eloc: bool = False
    use_sr: bool = False
    use_kfac: bool = False
    seed: int = 0

    def __post_init__(self):
        for name in ("grad_clip_factor", "exact_eloc", "use_sr", "use_kfac"):
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(f"TrainConfig.{name} is not ported yet")

    def lr_at(self, n_updates: int) -> float:
        """LR of the update after `n_updates` applied ones (optax's
        join_schedules of two constants at n_train // 2)."""
        if self.use_lr_schedule and n_updates >= max(self.n_train // 2, 1):
            return self.lr_final
        return self.lr

    def make_optimizer(self, params):
        """(Adam, LambdaLR): step the scheduler once per APPLIED update.
        The base LR is 1, so the schedule's value is the LR itself."""
        opt = torch.optim.Adam(params, lr=1.0,
                               betas=(self.adam_b1, self.adam_b2),
                               eps=self.adam_eps)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.lr_at)


def _grad_norm(params) -> torch.Tensor:
    sq = [torch.sum(p.grad.to(torch.float32) ** 2) for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def vmc_loss(model: NADE, dt: DeviceTerms, batch: SampleBatch,
             reweight_by_psi: bool = False):
    """Surrogate loss of one batch. Returns (loss, e_mean, e_var)."""
    live = torch.arange(batch.states.shape[0], device=batch.states.device) < batch.n_unique
    la, ph = log_psi(model, batch.states)
    la_d, ph_d = la.detach(), ph.detach()
    if reweight_by_psi:
        w = torch.where(live, torch.exp(2.0 * la_d.to(torch.float64)), 0.0)
    else:
        w = torch.where(live, batch.counts, 0.0)
    # an empty batch gives 0-weights (a no-op step), not 0/0
    w = w / torch.clamp(w.sum(), min=1e-300)
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


def vmc_update(model: NADE, optimizer, scheduler, dt: DeviceTerms,
               batch: SampleBatch, reweight_by_psi: bool = False) -> dict:
    """One Adam step on a sampled batch, withheld when the batch overflowed
    or anything went non-finite (one NaN would poison the parameters and
    the Adam moments for good). Does the step's one host readback and
    returns host scalars: e_loc, e_loc_var, loss, grad_norm, n_unique,
    overflow, applied."""
    optimizer.zero_grad(set_to_none=True)
    loss, e_mean, e_var = vmc_loss(model, dt, batch, reweight_by_psi)
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    gnorm = _grad_norm(params)
    vals = torch.stack([
        e_mean, e_var, loss.detach().to(torch.float64), gnorm.to(torch.float64),
        batch.n_unique.to(torch.float64), batch.overflow.to(torch.float64),
    ]).cpu().tolist()
    e_loc, e_loc_var, loss_v, gnorm_v, n_unq, ovf = vals
    bad = bool(ovf) or not all(np.isfinite([loss_v, gnorm_v, e_loc]))
    if not bad:
        optimizer.step()
        scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    return {"e_loc": e_loc, "e_loc_var": e_loc_var, "loss": loss_v,
            "grad_norm": gnorm_v, "n_unique": int(n_unq),
            "overflow": bool(ovf), "applied": not bad}


class VMCTrainer:
    """Host-side training controller: drives sample and update, adapts the
    sample count and logs metrics."""

    OVF_RETRY_STEPS = 50

    def __init__(
        self,
        model_cfg: NAQSConfig,
        terms: PauliTerms,
        hilbert: Hilbert,
        train_cfg: TrainConfig = TrainConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.tc = train_cfg
        self.hilbert = hilbert
        self.terms = terms
        self.dt = DeviceTerms.from_terms(terms, hilbert=hilbert, device=self.device)
        init_gen = torch.Generator().manual_seed(train_cfg.seed)
        self.model = NADE(model_cfg, init_gen).to(self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed + 1)
        self.optimizer, self.scheduler = train_cfg.make_optimizer(self.model.parameters())
        self.n_samples = float(train_cfg.n_samples)
        self.capacity = int(train_cfg.n_unq_samples_max)
        self.n_steps = 0
        self.run_time = 0.0
        self.log = {"E": [], "E_LOC": [], "E_LOC_VAR": [], "N_UNIQUE_SAMP": [],
                    "TIME": []}
        # sample-count-controller hysteresis: the smallest n_samples that
        # recently overflowed, and when; growth past it is re-tried only
        # every OVF_RETRY_STEPS steps
        self._ovf_n = float("inf")
        self._ovf_step = -(10 ** 9)

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

    def get_samples(self, max_retries: int = 12) -> SampleBatch:
        """Sample with the adaptive controller until the unique count sits
        inside the window (or a bound on n_samples is reached)."""
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
                return batch
            last_action = action
        raise RuntimeError(
            "sample-count controller did not converge: capacity "
            f"{self.capacity} too small for this wavefunction's support?")

    def _step_fused(self, max_retries: int = 12) -> dict:
        """Sample and update back to back with ONE host readback. On overflow
        the update was withheld; back off with sample-only probes, then run
        the one update on the batch that fits. Unique-count window changes
        apply to the NEXT step."""
        t0 = time.time()
        batch = self._sample()
        m = vmc_update(self.model, self.optimizer, self.scheduler, self.dt,
                       batch, self.tc.reweight_by_psi)
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
            m = vmc_update(self.model, self.optimizer, self.scheduler, self.dt,
                           batch, self.tc.reweight_by_psi)
            assert not m["overflow"]
        n_unq = m["n_unique"]
        at_max = self.n_samples >= self.tc.n_samples_max
        at_min = self.n_samples <= self.tc.n_unq_samples_min
        if (n_unq < self.tc.n_unq_samples_min and not at_max
                and not self._grow_blocked()):
            self.n_samples = min(self.n_samples * 10, self.tc.n_samples_max)
        elif n_unq > self.tc.n_unq_samples_max and not at_min:
            self.n_samples = max(self.n_samples / 10, self.tc.n_unq_samples_min)
        self.n_steps += 1
        dt_step = time.time() - t0
        self.run_time += dt_step
        out = {"e_loc": m["e_loc"], "e_loc_var": m["e_loc_var"],
               "n_unique": n_unq, "n_samples": self.n_samples, "time": dt_step}
        self.log["E_LOC"].append((self.n_steps, out["e_loc"]))
        self.log["E_LOC_VAR"].append((self.n_steps, out["e_loc_var"]))
        self.log["N_UNIQUE_SAMP"].append((self.n_steps, out["n_unique"]))
        self.log["TIME"].append((self.n_steps, self.run_time))
        return out

    def step(self) -> dict:
        return self._step_fused()

    @torch.no_grad()
    def exact_energy(self) -> float:
        """Exact <psi|H|psi>/<psi|psi> over the full restricted basis."""
        basis = torch.as_tensor(self.hilbert.basis, device=self.device)
        la, ph = log_psi(self.model, basis)
        return float(quadratic_energy(self.dt, basis, la, ph, basis.shape[0]))

    def run(self, n_epochs: int, output_freq: int = 25,
            log_exact_energy: bool = False, callback=None):
        for _ in range(n_epochs):
            out = self.step()
            if self.n_steps % output_freq == 0 or self.n_steps == 1:
                if log_exact_energy:
                    out["e_exact"] = self.exact_energy()
                    self.log["E"].append((self.n_steps, out["e_exact"]))
                recent = [v for _, v in self.log["E_LOC"][-output_freq:]]
                e_part = f"E={out['e_exact']:.6f}, " if "e_exact" in out else ""
                print(f"step {self.n_steps}: <E_loc>={np.mean(recent):.6f} "
                      f"+/- {np.std(recent):.6f}, var={out['e_loc_var']:.6f}, "
                      f"unq={out['n_unique']}, n_samp={out['n_samples']:.2e}, "
                      f"{e_part}t={out['time']*1000:.0f}ms", flush=True)
            if callback is not None:
                callback(self, out)
        return self
