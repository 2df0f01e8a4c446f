"""The port's natural-gradient updates against naqs_tpu on the CPU: the
model's K-FAC taps (`log_psi_taps`, `make_zero_eps`), K-FAC's factor
statistics, preconditioning and three successive `kfac_update`s, SR's S v
against an explicit Fisher matrix, `sr_update` with every option on the grid
and the rank engine (the exact-E_loc `table=` path too), its withheld
updates, and the H2 training gates of both.

Tolerances (stated per test below):
- outputs and taps of the forward rtol 1e-6 / atol 1e-6 (float32, another
  summation order), eps-gradients rtol 1e-5 / atol 1e-7, bias and weight
  gradients (sums over the batch) rtol 1e-5 / atol 1e-6;
- the factor Grams rtol 1e-5 / atol 1e-7 (float32 sums of a few hundred
  rows in another order), the preconditioned gradients and the K-FAC updates
  rtol 1e-4 / atol 1e-6 (float32 LU solves of damped factors);
- S v against the explicit matrix 1e-10 relative (float64);
- SR updates: float64 parameters 5e-8 relative to the update's norm (JAX's
  E_loc and the port's agree to ~1e-6 Ha, the rest is float64); float32
  parameters at cg_iters 3 and damping 1e-2, 2e-3 relative (float32 CG
  amplifies the last bits of the gradient: at cg_iters 10 and damping 1e-3
  the two packages' updates drift apart by up to ~1.5e-2 relative, with the
  same gradient to 1e-7); energies 5e-6 Ha, the gradient norm 1e-5 relative.

Torch runs on one thread here (`_one_torch_thread`), as in the other parity
tests, so that float32 sums do not depend on the thread count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu import kfac as kfac_j
from naqs_tpu import sr as sr_j
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu.sampler import SampleBatch as SampleBatchJ
from naqs_tpu_torch import kfac as kfac_t
from naqs_tpu_torch import sr as sr_t
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.models.convert import kfac_state_from_jax, params_from_jax
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.sampler import SampleBatch
from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer, sector_table
from test_torch_support import case, near_hf_states, padded_batch, to_u64

MEAN_TOL = 5e-6
CHEM_ACC = 1.6e-3

VARIANTS = {
    "default": {},
    "lut": dict(num_lut=2),
    "aggregate_phase": dict(aggregate_phase=True),
    "combined": dict(combined_amp_phase=True),
    "float64": dict(param_dtype="float64"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(c, seed=0, hidden=(16,), **kw):
    """(JAX config, JAX params, the port's model with the same weights)."""
    kw = dict(dict(amp_hidden=hidden, phase_hidden=hidden), **kw)
    cfg_j = nade_j.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, **kw)
    params = nade_j.init_params(jax.random.key(seed), cfg_j)
    model = nade_t.NADE(nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, **kw))
    model.load_state_dict(_tree(params))
    return cfg_j, params, model


def _tree(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _batches(c, m, cap, seed, overflow=False):
    """The same SENTINEL-padded sampled-style batch for both packages."""
    rng = np.random.default_rng(seed)
    s, _, _, counts = padded_batch(near_hf_states(c, m, rng), cap, rng)
    bj = SampleBatchJ(states=jnp.asarray(to_u64(s)), counts=jnp.asarray(counts),
                      n_unique=jnp.int32(m), overflow=jnp.array(overflow))
    bt = SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                     n_unique=torch.tensor(m), overflow=torch.tensor(overflow))
    return bj, bt


def _terms(c, engine):
    """(port DeviceTerms, JAX DeviceTerms) on the grid engine (the default
    dispatch of an STO-3G molecule) or the rank engine (dense=None)."""
    dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    if engine == "rank":
        dt_t, dt_j = dataclasses.replace(dt_t, dense=None), dataclasses.replace(dt_j, dense=None)
    else:
        assert type(dt_t.dense).__name__ == type(dt_j.dense).__name__ == "DenseTerms"
    return dt_t, dt_j


def _update_error(model, new_j, old_j):
    """|port's new parameters - JAX's| / |JAX's update| over every parameter."""
    want, old = _tree(new_j), _tree(old_j)
    num = den = 0.0
    for k, p in model.named_parameters():
        num += float(((p.detach().double() - want[k].double()) ** 2).sum())
        den += float(((want[k].double() - old[k].double()) ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


# -------------------------------------------------------------- the taps

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_log_psi_taps_matches_jax(variant):
    """log_psi_taps against naqs_tpu's on LiH (two hidden layers): outputs
    (equal to log_psi's), every tap, make_zero_eps's shapes, the
    eps-gradients of a loss against JAX's g_eps, and each layer's bias
    gradient equal to its eps-gradient summed over the batch (the eps are the
    pre-activations' perturbations)."""
    c = case("LiH")
    cfg_j, params, model = _model(c, seed=1, hidden=(12, 12), **VARIANTS[variant])
    states = c.h_t.basis[:64]
    s_j = jnp.asarray(states.astype(np.uint64))
    s_t = torch.as_tensor(states)
    eps_j = nade_j.make_zero_eps(cfg_j, params, 64)
    eps_t = nade_t.make_zero_eps(model, 64)
    assert eps_t.keys() == eps_j.keys()
    for name in eps_j:
        assert [tuple(e.shape) for e in eps_t[name]] == [e.shape for e in eps_j[name]]
        assert all(not e.any() for e in eps_t[name])
    (la_j, ph_j), taps_j = nade_j.log_psi_taps(cfg_j, params, s_j, eps_j)
    for layers in eps_t.values():
        for e in layers:
            e.requires_grad_(True)
    (la, ph), taps = nade_t.log_psi_taps(model, s_t, eps_t)
    la_p, ph_p = nade_t.log_psi(model, s_t)
    assert torch.equal(la.detach(), la_p.detach()) and torch.equal(ph.detach(), ph_p.detach())
    np.testing.assert_allclose(la.detach().numpy(), np.asarray(la_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(ph_j), rtol=1e-6, atol=1e-6)
    assert taps.keys() == taps_j.keys()
    for name in taps_j:
        assert len(taps[name]) == len(taps_j[name])
        for a, a_j in zip(taps[name], taps_j[name]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_j), rtol=1e-6,
                                       atol=1e-6, err_msg=name)

    def loss_j(p, eps):
        (la, ph), _ = nade_j.log_psi_taps(cfg_j, p, s_j, eps)
        return jnp.sum(la ** 2 + 0.3 * ph)

    g_p, g_e = jax.grad(loss_j, argnums=(0, 1))(params, eps_j)
    names, ps = zip(*model.named_parameters())
    leaves = [e for name in eps_t for e in eps_t[name]]
    grads = torch.autograd.grad(torch.sum(la ** 2 + 0.3 * ph), [*ps, *leaves])
    g_t = dict(zip(names, grads[:len(ps)]))
    g_eps = iter(grads[len(ps):])
    for name in eps_t:
        for li in range(len(eps_t[name])):
            ge = next(g_eps)
            np.testing.assert_allclose(ge.numpy(), np.asarray(g_e[name][li]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {li}")
            gb = g_t[f"{name}.b.{li}"]
            np.testing.assert_allclose(ge.sum(0).reshape(gb.shape).numpy(), gb.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {li}")
    np.testing.assert_allclose(g_t["amp.w.0"].numpy(), np.asarray(g_p["amp"][0]["w"]),
                               rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- K-FAC

@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_factor_stats_and_precondition_match_jax(stacked):
    """_factor_stats (with zero-weight rows: the padding) and _precondition
    against naqs_tpu's on the same arrays, a stacked layer (B, S, i) and the
    global phase net's (B, i)."""
    rng = np.random.default_rng(0)
    b, s, i, o = 300, (5 if stacked else 1), 12, 7
    shape_a, shape_g = ((b, s, i), (b, s, o)) if stacked else ((b, i), (b, o))
    a = rng.normal(size=shape_a).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=b)
    w[-40:] = 0.0
    w /= w.sum()
    g = (rng.normal(size=shape_g) * w.reshape((-1,) + (1,) * (len(shape_g) - 1))).astype(
        np.float32)
    A_j, G_j = kfac_j._factor_stats(jnp.asarray(a), jnp.asarray(g), jnp.asarray(w))
    A, G = kfac_t._factor_stats(torch.as_tensor(a), torch.as_tensor(g), torch.as_tensor(w))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_j), rtol=1e-5, atol=1e-7)
    gw = rng.normal(size=(s, i, o)).astype(np.float32)
    gb = rng.normal(size=(s, o)).astype(np.float32)
    vw_j, vb_j = kfac_j._precondition({"A": A_j, "G": G_j}, jnp.asarray(gw), jnp.asarray(gb),
                                      jnp.float32(1e-2))
    vw, vb = kfac_t._precondition({"A": A, "G": G}, torch.as_tensor(gw), torch.as_tensor(gb),
                                  torch.tensor(1e-2, dtype=torch.float32))
    np.testing.assert_allclose(vw.numpy(), np.asarray(vw_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(vb.numpy(), np.asarray(vb_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("variant", ["default", "lut"])
def test_kfac_update_matches_jax_over_three_steps(variant):
    """Three successive kfac_update calls from the same parameters and a
    fresh state, each on its own sampled-style batch of H2O STO-3G (120 of
    128 rows live): the state (step, every A and G), the parameters, loss and
    nu after each, against naqs_tpu's. With LUT shells the tables take plain
    SGD at the clipped scale."""
    c = case("H2O")
    dt_t, dt_j = _terms(c, "grid")
    cfg_j, params, model = _model(c, seed=3, **VARIANTS[variant])
    ks_j = kfac_j.kfac_init(params)
    ks_t = kfac_t.kfac_init(model)
    for step in range(3):
        bj, bt = _batches(c, 120, 128, seed=10 + step)
        old = params
        params, ks_j, m_j = kfac_j.kfac_update(cfg_j, params, ks_j, dt_j, bj, jnp.float32(5e-2),
                                               jnp.float32(1e-2), jnp.float32(0.95),
                                               jnp.float32(1e-3))
        ks_t, m_t = kfac_t.kfac_update(model, ks_t, dt_t, bt, 5e-2, 1e-2, 0.95, 1e-3)
        assert int(ks_t["step"]) == int(ks_j["step"]) == step + 1
        want = kfac_state_from_jax(jax.tree_util.tree_map(np.asarray, ks_j))
        for name in ("amp", "phase"):
            for fac, fac_j in zip(ks_t[name], want[name]):
                for k in ("A", "G"):
                    np.testing.assert_allclose(fac[k].numpy(), fac_j[k].numpy(), rtol=1e-5,
                                               atol=1e-7, err_msg=f"{name} {k} step {step}")
        assert abs(float(m_t["e_loc"]) - float(m_j["e_loc"])) < MEAN_TOL
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(m_t["nu"]), float(m_j["nu"]), rtol=1e-4)
        assert _update_error(model, params, old) < 1e-4
        want_p = _tree(params)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


# -------------------------------------------------------------- SR

def test_s_matvec_matches_an_explicit_fisher_matrix():
    """On LiH with a tiny float64 model: S v against (S + d I) v with S built
    from the Jacobian (torch.func.jacrev) of (log|psi|, arg psi), S =
    sum_b w_b (O_b - <O>)^T (O_b - <O>) over both parts; the gradient
    against 2 sum_b w_b (dRe_b O^la_b + dIm_b O^ph_b); fisher_mix on the
    metric only; and the CG solve against numpy's (1e-6 relative) within the
    parameter count of iterations."""
    c = case("LiH")
    _, _, model = _model(c, seed=2, hidden=(4,), param_dtype="float64")
    dt, _ = _terms(c, "grid")
    _, bt = _batches(c, 40, 48, seed=1)
    damping = 1e-1
    flat0, params, grad, s_matvec, e_mean, _ = sr_t.sr_system(model, dt, bt, damping)
    n = flat0.numel()
    names = [k for k, _ in model.named_parameters()]
    shapes = [p.shape for p in params]

    def f(flat):
        pieces = dict(zip(names, (t.view(s) for t, s in
                                  zip(torch.split(flat, [p.numel() for p in params]), shapes))))
        return torch.func.functional_call(model, pieces, (bt.states,))

    j_la, j_ph = torch.func.jacrev(f)(flat0)
    live = torch.arange(bt.states.shape[0]) < bt.n_unique
    w = torch.where(live, bt.counts, 0.0)
    w = w / w.sum()
    la, ph = (x.detach() for x in f(flat0))
    e_re, e_im = le_t.local_energy(dt, bt.states, la.float(), ph.float(), bt.n_unique)
    e_re, e_im = torch.where(live, e_re, 0.0), torch.where(live, e_im, 0.0)
    d_re, d_im = e_re - torch.sum(w * e_re), e_im - torch.sum(w * e_im)
    g_want = 2.0 * (torch.sum((w * d_re)[:, None] * j_la, 0)
                    + torch.sum((w * d_im)[:, None] * j_ph, 0))
    torch.testing.assert_close(grad, g_want, rtol=1e-10, atol=1e-12)

    def fisher(wf):
        o_la = j_la - torch.sum(wf[:, None] * j_la, 0)
        o_ph = j_ph - torch.sum(wf[:, None] * j_ph, 0)
        return (o_la.T * wf) @ o_la + (o_ph.T * wf) @ o_ph + damping * torch.eye(n,
                                                                                 dtype=w.dtype)

    S = fisher(w)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=n))
    torch.testing.assert_close(s_matvec(v), S @ v, rtol=1e-10, atol=1e-12)
    x, k = sr_t.conjugate_gradient(s_matvec, grad, grad, n)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(S.numpy(), grad.numpy()),
                               rtol=1e-6, atol=1e-9)
    assert 0 < int(k) <= n
    mix = 0.3
    s_mix = sr_t.sr_system(model, dt, bt, damping, fisher_mix=mix)[3]
    w_mix = (1 - mix) * w + mix * live.double() / live.sum()
    torch.testing.assert_close(s_mix(v), fisher(w_mix) @ v, rtol=1e-10, atol=1e-12)


SR_OPTIONS = {
    "default": {},
    "reweight_by_psi": dict(reweight_by_psi=True),
    "kl_clip": dict(kl_clip=1e-4),
    "fisher_mix": dict(fisher_mix=0.2),
    "table": {},
}


@pytest.mark.parametrize("engine", ["grid", "rank"])
@pytest.mark.parametrize("option", list(SR_OPTIONS))
def test_sr_update_matches_jax(option, engine):
    """sr_update on float32 parameters at cg_iters 3, damping 1e-2, on a
    sampled-style batch of H2O STO-3G (120 of 128 rows live), with each
    option, against naqs_tpu's: the new parameters within 2e-3 of the
    update's norm, the energy, variance and gradient norm; `table` resolves
    the coupled states against the whole sector (a chunk of 100: the table
    padded to 500 rows) on both sides."""
    c = case("H2O")
    dt_t, dt_j = _terms(c, engine)
    cfg_j, params, model = _model(c, seed=4)
    bj, bt = _batches(c, 120, 128, seed=5)
    kw = SR_OPTIONS[option]
    table_t = table_j = None
    chunk = 100
    if option == "table":
        table_t = sector_table(c.h_t.basis, chunk, "cpu")
        buf = np.full(table_t[0].shape[0], np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        buf[:len(c.h_j.basis)] = c.h_j.basis
        table_j = (jnp.asarray(buf), jnp.int32(len(c.h_j.basis)))
    kl = kw.get("kl_clip")
    new_j, m_j = sr_j.sr_update(cfg_j, params, dt_j, bj, jnp.float64(5e-2), jnp.float64(1e-2),
                                cg_iters=3, reweight_by_psi=kw.get("reweight_by_psi", False),
                                kl_clip=None if kl is None else jnp.float64(kl),
                                fisher_mix=kw.get("fisher_mix", 0.0), table=table_j,
                                fwd_chunk=chunk)
    m_t = sr_t.sr_update(model, dt_t, bt, 5e-2, 1e-2, cg_iters=3, table=table_t,
                         fwd_chunk=chunk, **kw)
    assert int(m_t["cg_iters"]) == 3
    assert abs(float(m_t["e_loc"]) - float(m_j["e_loc"])) < MEAN_TOL
    np.testing.assert_allclose(float(m_t["e_loc_var"]), float(m_j["e_loc_var"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]), float(m_j["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["sr_dx_norm"]), float(m_j["sr_dx_norm"]), rtol=2e-3)
    assert _update_error(model, new_j, params) < 2e-3


@pytest.mark.parametrize("damping,cg_iters,stops", [(1e-3, 10, False), (3.0, 40, True)],
                         ids=["10_iterations", "stops_early"])
def test_sr_update_float64_matches_jax(damping, cg_iters, stops):
    """Float64 parameters: the new parameters within 5e-8 of the update's
    norm of naqs_tpu's (the local energies are float32 sums in both
    packages, in another order: ~1e-6 Ha apart). With damping 3 the system
    is so well conditioned that CG meets its stop test (gamma <= 1e-20
    |b|^2) before the 40th iteration: the port counts fewer iterations and
    its x still agrees with JAX's, which stopped at the same test. (At
    damping 1e-3 CG is chaotic past ~15 iterations on this model: a 1e-15
    relative change of the gradient moves x by 1.5e-6 after 20 iterations
    and 2.5e-5 after 40, so no two summation orders agree closely there.)"""
    c = case("H2O")
    dt_t, dt_j = _terms(c, "grid")
    cfg_j, params, model = _model(c, seed=6, param_dtype="float64")
    bj, bt = _batches(c, 120, 128, seed=7)
    new_j, m_j = sr_j.sr_update(cfg_j, params, dt_j, bj, jnp.float64(5e-2),
                                jnp.float64(damping), cg_iters=cg_iters)
    m_t = sr_t.sr_update(model, dt_t, bt, 5e-2, damping, cg_iters=cg_iters)
    assert (int(m_t["cg_iters"]) < cg_iters) == stops
    assert abs(float(m_t["e_loc"]) - float(m_j["e_loc"])) < MEAN_TOL
    assert _update_error(model, new_j, params) < 5e-8


@pytest.mark.parametrize("fault", ["overflow", "non_finite"])
def test_sr_update_is_withheld(fault):
    """An overflowed batch, or a NaN count (a non-finite energy), leaves
    every parameter bitwise as it was, in both packages."""
    c = case("H2O")
    dt_t, dt_j = _terms(c, "grid")
    cfg_j, params, model = _model(c, seed=8)
    bj, bt = _batches(c, 120, 128, seed=9, overflow=fault == "overflow")
    if fault == "non_finite":
        counts = bt.counts.clone()
        counts[3] = float("nan")
        bt = dataclasses.replace(bt, counts=counts)
        bj = dataclasses.replace(bj, counts=jnp.asarray(counts.numpy()))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    new_j, m_j = sr_j.sr_update(cfg_j, params, dt_j, bj, jnp.float64(5e-2), jnp.float64(1e-2),
                                cg_iters=3)
    m_t = sr_t.sr_update(model, dt_t, bt, 5e-2, 1e-2, cg_iters=3)
    want = _tree(new_j)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
        assert torch.equal(want[k], before[k]), k
    assert np.isfinite(float(m_t["e_loc"])) == (fault == "overflow")
    assert np.isfinite(float(m_j["e_loc"])) == (fault == "overflow")


# -------------------------------------------------------------- training gates

def _h2_trainer(hidden, masking, **tc):
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=4, sectors=c.h_t.sectors, amp_hidden=hidden,
                        phase_hidden=hidden, masking=masking)
    return c, VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(**tc), device="cpu")


def test_sr_trains_h2_to_chemical_accuracy():
    """tests/test_sr.py's settings: 200 SR steps (cg_iters 30, damping 1e-2,
    lr 0.1) after 30 pre_flatten epochs reach 1.6 mHa of FCI."""
    c, tr = _h2_trainer((16,), "full", n_train=200, n_samples=1e5, n_unq_samples_min=4,
                        n_unq_samples_max=16, use_sr=True, sr_damping=1e-2, sr_cg_iters=30,
                        lr=1e-1, use_lr_schedule=False, seed=4)
    tr.pre_flatten(30)
    tr.run(200, output_freq=1000)
    e = tr.exact_energy()
    assert e - c.mol_t.fci_energy < CHEM_ACC, (e, c.mol_t.fci_energy)


def test_kfac_trains_h2_to_chemical_accuracy():
    """tests/test_kfac.py's settings: 400 K-FAC steps (lr 5e-2 then 2e-3)
    reach 1.6 mHa of FCI, and not below it."""
    c, tr = _h2_trainer((32,), "partial", use_kfac=True, n_train=400, lr=5e-2, lr_final=2e-3,
                        n_samples=1e5, n_unq_samples_min=1, n_unq_samples_max=8)
    for _ in range(400):
        tr.step()
    e = tr.exact_energy()
    assert abs(e - c.mol_t.fci_energy) < CHEM_ACC, (e, c.mol_t.fci_energy)
    assert e >= c.mol_t.fci_energy - 1e-6
    assert int(tr.kfac_state["step"]) == 400
