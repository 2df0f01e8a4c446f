"""Stochastic reconfiguration (natural-gradient) VMC updates, matrix-free.

Port of `naqs_tpu/sr.py`: precondition the energy gradient with the quantum
Fisher matrix S = Re(<conj(O) O^T> - <conj(O)><O>^T), O_k = d log psi /
d theta_k, over one flat vector of every parameter (the LUT tables too).
S is never formed: S v is one `torch.func.jvp` over the batch, centred by
the weights in float64, then the `vjp_fn` of one `torch.func.vjp` taken
once per update and reused for the gradient and every S v.
(S + damping I) x = grad is solved by conjugate gradients step for step as
`jax.scipy.sparse.linalg.cg(..., x0=grad, tol=1e-10)` does, on the device:
the loop runs `cg_iters` times and an iteration after the stop test holds
leaves x, r, p and gamma as they were (`torch.where`), so nothing is read
back inside an update. Cost per update: cg_iters + 2 jvp/vjp pairs, one
more with `kl_clip`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call, jvp, vjp

from naqs_tpu_torch.models.nade import NADE
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy
from naqs_tpu_torch.sampler import SampleBatch

CG_TOL = 1e-10  # the relative residual norm at which CG stops


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def conjugate_gradient(matvec, b: torch.Tensor, x0: torch.Tensor, maxiter: int,
                       tol: float = CG_TOL):
    """x with (A x = b) by `jax.scipy.sparse.linalg.cg`'s iteration: r0 = b -
    A x0, the stop test gamma <= tol^2 |b|^2 before every iteration (the
    first too), the same alpha and beta. It runs `maxiter` iterations on the
    device with no readback; an iteration after the test stopped it changes
    nothing. Returns (x, the count of iterations that ran, a device int)."""
    atol2 = (tol * tol) * _dot(b, b)
    x = x0
    r = b - matvec(x0)
    p = r
    gamma = _dot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        go = gamma > atol2
        ap = matvec(p)
        alpha = gamma / _dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = _dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        gamma = torch.where(go, gamma_new, gamma)
        k = k + go.to(torch.int64)
    return x, k


def sr_system(model: NADE, dt: DeviceTerms, batch: SampleBatch, damping,
              reweight_by_psi: bool = False, fisher_mix: float = 0.0, table=None,
              fwd_chunk: int = 65536, psum=lambda t: t, centred=None):
    """The pieces of one SR update: (flat0, the parameters in order, grad,
    s_matvec, e_mean, e_var). flat0 is every parameter flattened into one
    vector (`model.named_parameters()` order), grad the energy gradient
    2 Re <conj(O) dE> and s_matvec(v) = (S + damping I) v, both in the
    parameters' dtype. Weights, local energies and the centring are float64.
    `table=(t_states, t_n)` gives exact local energies against the whole
    sector, as in `trainer.vmc_loss`.

    Data parallel (`parallel/step.py`, the JAX package's
    `make_sharded_sr_step`): `psum` sums a tensor over the ranks (the
    identity on one device) in the gradient, in both centring sums and in S v
    itself, and in fisher_mix's count of live rows; `centred=(w, d_re, d_im,
    e_mean, e_var)` gives the weights, normalized over every rank, and the
    local energies centred on the global mean (dt, reweight_by_psi and table
    then go unused)."""
    names, params = zip(*model.named_parameters())
    shapes = [p.shape for p in params]
    flat0 = torch.cat([p.detach().reshape(-1) for p in params])
    sizes = [p.numel() for p in params]
    states = batch.states
    live = torch.arange(states.shape[0], device=states.device) < batch.n_unique

    def f(flat):
        pieces = {n: t.view(s) for n, t, s in zip(names, torch.split(flat, sizes), shapes)}
        la, ph = functional_call(model, pieces, (states,))
        return la.to(torch.float64), ph.to(torch.float64)

    (la, ph), vjp_fn = vjp(f, flat0)
    if centred is None:
        centred = _centred(model, dt, batch, live, la.detach(), ph.detach(), reweight_by_psi,
                           table, fwd_chunk)
    w, d_re, d_im, e_mean, e_var = centred
    grad = psum((2.0 * vjp_fn((w * d_re, w * d_im))[0]).to(flat0.dtype))
    if fisher_mix > 0.0:
        n_live = torch.clamp(psum(torch.sum(live.to(torch.float64))), min=1.0)
        w_f = (1.0 - fisher_mix) * w + fisher_mix * live.to(torch.float64) / n_live
    else:
        w_f = w

    def s_matvec(v):
        # centring the jvp's output also removes the <O> outer product: the
        # weighted cotangents then sum to zero
        u_la, u_ph = jvp(f, (flat0,), (v,))[1]
        mean = psum(torch.stack([torch.sum(w_f * u_la), torch.sum(w_f * u_ph)]))
        u_la, u_ph = u_la - mean[0], u_ph - mean[1]
        return psum(vjp_fn((w_f * u_la, w_f * u_ph))[0].to(flat0.dtype)) + damping * v

    return flat0, params, grad, s_matvec, e_mean, e_var


def _centred(model, dt, batch, live, la, ph, reweight_by_psi, table, fwd_chunk):
    """One device's (w, d_re, d_im, e_mean, e_var) from the batch's float64
    (log_amp, phase): the normalized weights and the local energies centred
    on their weighted mean."""
    states = batch.states
    if reweight_by_psi:
        w = torch.where(live, torch.exp(2.0 * la), 0.0)
    else:
        w = torch.where(live, batch.counts, 0.0)
    w = w / torch.sum(w)
    if table is not None:
        from naqs_tpu_torch.trainer import log_psi_table

        t_states, t_n = table
        t_la, t_ph = log_psi_table(model, t_states, fwd_chunk)
        e_re, e_im = local_energy(dt, t_states, t_la, t_ph, t_n,
                                  queries=(states, la.to(torch.float32),
                                           ph.to(torch.float32)))
    else:
        e_re, e_im = local_energy(dt, states, la.to(torch.float32), ph.to(torch.float32),
                                  batch.n_unique)
    e_re = torch.where(live, e_re, 0.0)
    e_im = torch.where(live, e_im, 0.0)
    e_mean = torch.sum(w * e_re)
    e_var = torch.sum(w * (e_re - e_mean) ** 2)
    return w, e_re - e_mean, e_im - torch.sum(w * e_im), e_mean, e_var


def sr_step(flat0, params, grad, s_matvec, e_mean, lr: float, cg_iters: int,
            kl_clip: Optional[float], overflow: torch.Tensor):
    """The rest of an SR update after `sr_system`: solve (S + damping I) x =
    grad by CG from x0 = grad, cap the step by the KL clip, and write flat0 -
    lr x into the parameters, unless the batch overflowed (it is truncated,
    so biased) or the energy or the new parameters are not finite (one NaN
    would poison them for good); both decided on the device. Returns (x, the
    CG iterations that ran)."""
    x, n_iter = conjugate_gradient(s_matvec, grad, grad, cg_iters)
    lr_t = torch.full((), lr, dtype=flat0.dtype, device=flat0.device)
    if kl_clip is not None:
        # the step lr x moves the distribution ~ 0.5 lr^2 x^T S x nats
        q = torch.clamp(_dot(x, s_matvec(x)), min=1e-300)
        lr_t = lr_t * torch.clamp(torch.sqrt(kl_clip / (lr_t * lr_t * q)), max=1.0)
    new_flat = flat0 - lr_t * x
    bad = overflow | ~torch.isfinite(e_mean) | ~torch.isfinite(torch.sum(new_flat))
    new_flat = torch.where(bad, flat0, new_flat)
    with torch.no_grad():
        for p, piece in zip(params, torch.split(new_flat, [p.numel() for p in params])):
            p.copy_(piece.view_as(p))
    return x, n_iter


def sr_update(model: NADE, dt: DeviceTerms, batch: SampleBatch, lr: float, damping: float,
              cg_iters: int = 50, reweight_by_psi: bool = False,
              kl_clip: Optional[float] = None, fisher_mix: float = 0.0, table=None,
              fwd_chunk: int = 65536) -> dict:
    """One SR step on the model's parameters, in place; nothing is read back.
    Returns device scalars: e_loc, e_loc_var, sr_dx_norm (|x|), grad_norm,
    cg_iters (the CG iterations that ran).

    reweight_by_psi: weight the live rows by |psi|^2 instead of counts.
    kl_clip: cap the step's quadratic length lr^2 x^T S x at kl_clip nats
    (one more S v). fisher_mix: mix this share of a uniform distribution over
    the live rows into the Fisher weights only. The update is withheld on
    the batch's overflow, a non-finite energy or a non-finite new parameter
    vector."""
    flat0, params, grad, s_matvec, e_mean, e_var = sr_system(
        model, dt, batch, damping, reweight_by_psi, fisher_mix, table, fwd_chunk)
    x, n_iter = sr_step(flat0, params, grad, s_matvec, e_mean, lr, cg_iters, kl_clip,
                        batch.overflow)
    return {"e_loc": e_mean, "e_loc_var": e_var, "sr_dx_norm": torch.linalg.norm(x),
            "grad_norm": torch.linalg.norm(grad), "cg_iters": n_iter}
