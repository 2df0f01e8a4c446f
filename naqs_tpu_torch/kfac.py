"""K-FAC natural-gradient VMC updates (Kronecker-factored Fisher).

Port of `naqs_tpu/kfac.py`: per dense layer the Fisher block is taken as
A (x) G, A = E[a a^T] the second moment of the layer's input and G =
E[g g^T] that of its pre-activation gradient, both bias-corrected
exponential running averages; the update is (A + dI)^-1 grad_W (G + dI)^-1
with the pi-corrected Tikhonov split of the damping, scaled by the KL clip
nu = min(1, sqrt(kl_clip / sum <grad, lr^2 precond>)). The per-example
pre-activation gradients are the gradients w.r.t. zero perturbations added
to every pre-activation (`models/nade.log_psi_taps`, `make_zero_eps`); the
LUT tables take plain SGD at the clipped scale. The weighted Grams are
batched products (cuBLAS) and the solves `torch.linalg.solve_ex` with
check_errors=False, batched over each stack: nothing is read back inside an
update.
"""

from __future__ import annotations

import torch

from naqs_tpu_torch.models.nade import NADE, log_psi, log_psi_taps, make_zero_eps
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy
from naqs_tpu_torch.sampler import SampleBatch

_STACKS = ("amp", "phase")


def _layers(model: NADE):
    """(stack name, its MLPStack) of every dense stack the model has."""
    return [(name, getattr(model, name)) for name in _STACKS if hasattr(model, name)]


def kfac_init(model: NADE) -> dict:
    """Zero running factors for every dense layer: {"step": 0-d int32,
    name: [{"A": (n_stack, d_in, d_in), "G": (n_stack, d_out, d_out)}, ...]},
    float32 on the model's device."""
    dev = next(model.parameters()).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    for name, stack in _layers(model):
        state[name] = [
            {"A": torch.zeros((w.shape[0], w.shape[1], w.shape[1]), dtype=torch.float32,
                              device=dev),
             "G": torch.zeros((w.shape[0], w.shape[2], w.shape[2]), dtype=torch.float32,
                              device=dev)}
            for w in stack.w]
    return state


def _factor_stats(a: torch.Tensor, g: torch.Tensor, w: torch.Tensor):
    """Weighted second moments over the batch: a (B, S, i) or (B, i) layer
    inputs, g the matching pre-activation gradients of the weighted loss, w
    (B,) the weights. Returns A (S, i, i) = sum_b w_b a a^T and G (S, o, o)
    = sum_b g g^T / w_b (g carries w_b once; dividing it out makes G an
    expectation like A), S = 1 for an unstacked layer."""
    if a.dim() == 2:
        a, g = a[:, None, :], g[:, None, :]
    w32 = w.to(torch.float32)
    a = a.to(torch.float32).transpose(0, 1)   # (S, B, i)
    g = g.to(torch.float32).transpose(0, 1)
    A = torch.bmm((a * w32[None, :, None]).transpose(1, 2), a)
    inv_w = torch.where(w32 > 0, 1.0 / torch.clamp(w32, min=1e-30), 0.0)
    G = torch.bmm((g * inv_w[None, :, None]).transpose(1, 2), g)
    return A, G


def _precondition(fac: dict, gw: torch.Tensor, gb: torch.Tensor, damping: torch.Tensor):
    """(A + dI)^-1 gw (G + dI)^-1 and (G + dI)^-1 gb, batched over the stack,
    the damping split between the factors by pi = sqrt((tr A / i) / (tr G /
    o))."""
    d_in, d_out = fac["A"].shape[-1], fac["G"].shape[-1]
    eye_i = torch.eye(d_in, dtype=torch.float32, device=gw.device)
    eye_o = torch.eye(d_out, dtype=torch.float32, device=gw.device)
    tr_a = torch.diagonal(fac["A"], dim1=-2, dim2=-1).sum(-1) / d_in
    tr_g = torch.diagonal(fac["G"], dim1=-2, dim2=-1).sum(-1) / d_out
    pi = torch.sqrt(torch.clamp(tr_a, min=1e-12) / torch.clamp(tr_g, min=1e-12))
    lam = torch.sqrt(damping)
    a_d = fac["A"] + (lam * pi)[:, None, None] * eye_i
    g_d = fac["G"] + (lam / pi)[:, None, None] * eye_o
    tmp = torch.linalg.solve_ex(a_d, gw.to(torch.float32), check_errors=False)[0]
    vw = torch.linalg.solve_ex(g_d, tmp.transpose(-1, -2),
                               check_errors=False)[0].transpose(-1, -2)
    vb = torch.linalg.solve_ex(g_d, gb.to(torch.float32)[..., None], check_errors=False)[0]
    return vw, vb[..., 0]


def kfac_apply(model: NADE, kstate: dict, states: torch.Tensor, w: torch.Tensor,
               d_re: torch.Tensor, d_im: torch.Tensor, lr: float, damping: float,
               decay: float, kl_clip: float):
    """The K-FAC step given the normalized weights w and the centred local
    energies (d_re, d_im): the model's parameters are updated in place.
    Returns (new kstate, {"loss", "nu"} as device scalars)."""
    dev = states.device
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    lr, damping, decay, kl_clip = f32(lr), f32(damping), f32(decay), f32(kl_clip)
    eps = make_zero_eps(model, states.shape[0])
    for layers in eps.values():
        for e in layers:
            e.requires_grad_(True)
    d_re = d_re.detach().to(torch.float32)
    d_im = d_im.detach().to(torch.float32)
    wf = w.to(torch.float32)
    (la, ph), taps = log_psi_taps(model, states, eps)
    loss = 2.0 * torch.sum(wf * (la * d_re + ph * d_im))
    names, params = zip(*model.named_parameters())
    eps_leaves = [e for name in eps for e in eps[name]]
    grads = torch.autograd.grad(loss, [*params, *eps_leaves])
    g_params = dict(zip(names, grads[:len(params)]))
    g_eps = iter(grads[len(params):])
    with torch.no_grad():
        step = kstate["step"] + 1
        # bias-corrected EMA: an average over min(step, 1 / (1 - decay)) steps
        corr = 1.0 - torch.pow(decay, step.to(torch.float32))
        new_state = {"step": step}
        vg_sum = torch.zeros((), dtype=torch.float32, device=dev)
        updates = []
        for name, stack in _layers(model):
            facs = []
            for li in range(len(stack.w)):
                A, G = _factor_stats(taps[name][li], next(g_eps), w)
                fac = kstate[name][li]
                A_ema = decay * fac["A"] + (1.0 - decay) * A
                G_ema = decay * fac["G"] + (1.0 - decay) * G
                facs.append({"A": A_ema, "G": G_ema})
                gw, gb = g_params[f"{name}.w.{li}"], g_params[f"{name}.b.{li}"]
                vw, vb = _precondition({"A": A_ema / corr, "G": G_ema / corr}, gw, gb, damping)
                vg_sum = vg_sum + (lr * lr) * (torch.sum(vw * gw.to(torch.float32))
                                               + torch.sum(vb * gb.to(torch.float32)))
                updates += [(stack.w[li], vw), (stack.b[li], vb)]
            new_state[name] = facs
        nu = torch.clamp(torch.sqrt(kl_clip / torch.clamp(vg_sum, min=1e-12)), max=1.0)
        scale = lr * nu
        # the LUT tables (every parameter outside the dense stacks): plain SGD
        # at the same clipped scale
        updates += [(p, g_params[n]) for n, p in zip(names, params)
                    if n.split(".")[0] not in _STACKS]
        for p, u in updates:
            p.copy_(p - scale * u)
    return new_state, {"loss": loss.detach(), "nu": nu}


def kfac_update(model: NADE, kstate: dict, dt: DeviceTerms, batch: SampleBatch, lr: float,
                damping: float = 1e-2, decay: float = 0.95, kl_clip: float = 1e-3):
    """One K-FAC VMC step on the model's parameters, in place, with nothing
    read back. As in the JAX package it weights the live rows by their
    counts and withholds nothing. Returns (new kstate, device scalars e_loc,
    e_loc_var, loss, nu)."""
    states = batch.states
    live = torch.arange(states.shape[0], device=states.device) < batch.n_unique
    with torch.no_grad():
        la, ph = log_psi(model, states)
    w = torch.where(live, batch.counts, 0.0)
    w = w / torch.sum(w)
    e_re, e_im = local_energy(dt, states, la, ph, batch.n_unique)
    e_re = torch.where(live, e_re, 0.0)
    e_im = torch.where(live, e_im, 0.0)
    e_mean = torch.sum(w * e_re)
    e_var = torch.sum(w * (e_re - e_mean) ** 2)
    new_state, m = kfac_apply(model, kstate, states, w, e_re - e_mean,
                              e_im - torch.sum(w * e_im), lr, damping, decay, kl_clip)
    return new_state, {"e_loc": e_mean, "e_loc_var": e_var, **m}
