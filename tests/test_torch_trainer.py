"""Port trainer against naqs_tpu's _vmc_update_impl and optax.adam.

Tolerances: loss and E_loc 5e-6 Ha (fp32 off-diagonal order); gradients
rtol 1e-4 / atol 1e-6; Adam parameters rtol 1e-5 / atol 1e-7 when both are
fed the same gradients (end-to-end parameters are not compared: with eps =
1e-15 the first Adam step is ~lr * sign(g), so a near-zero gradient that
rounds differently flips sign).

The file runs torch on one thread (`_one_torch_thread`): torch's CPU
reductions and matmuls split their work by the thread count, so their fp32
summation order, and with it the last digits of the gradients held to rtol
1e-4 here, would otherwise depend on how many threads the process gets.

Tests that mean the rank engine take `_rank_terms` (the default dispatch's
DeviceTerms with `dense=None`, as for JAX); the grid engine, which the
default dispatch picks for these single-sector molecules, has tests of its
own below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu import trainer as trainer_j
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops.local_energy import DeviceTerms as DeviceTermsJ
from naqs_tpu.sampler import SampleBatch as SampleBatchJ
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.ops.local_energy import DeviceTerms
from naqs_tpu_torch.sampler import SampleBatch, sample
from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer, vmc_update
from test_torch_support import case, near_hf_states, padded_batch, to_u64

CHEM_ACC = 1.6e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rank_terms(c):
    """The port's rank-engine DeviceTerms of a case."""
    return dataclasses.replace(
        DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu"), dense=None)


def _grab_grads():
    """An optax transform that applies nothing and keeps the gradients as
    its state, so _vmc_update_impl hands back the JAX gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def _setup(seed=0, **kw):
    c = case("H2O")
    kw = dict(dict(amp_hidden=(16,), phase_hidden=(16,)), **kw)
    cfg_j = nade_j.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, **kw)
    params = nade_j.init_params(jax.random.key(seed), cfg_j)
    model = nade_t.NADE(nt.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, **kw))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return c, cfg_j, params, model


def _batches(c, m=120, cap=128, seed=0, overflow=False):
    rng = np.random.default_rng(seed)
    s, _, _, counts = padded_batch(near_hf_states(c, m, rng), cap, rng)
    bj = SampleBatchJ(states=jnp.asarray(to_u64(s)), counts=jnp.asarray(counts),
                      n_unique=jnp.int32(m), overflow=jnp.array(overflow))
    bt = SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                     n_unique=torch.tensor(m), overflow=torch.tensor(overflow))
    return bj, bt


def _snapshot(model, opt):
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
             for i, s in enumerate(opt.state.values())}
    return params, state


def _same(a, b):
    (pa, sa), (pb, sb) = a, b
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))


@pytest.mark.parametrize("reweight,clip", [(False, None), (True, None), (False, 0.5)],
                         ids=["False", "True", "clip"])
def test_vmc_update_matches_jax(reweight, clip):
    """With `clip`, also the clipped gradients and the clip's ring after the
    update, against optax.chain(adaptive_trailing_clip, ...) from the same
    ring (5 norms of 0.3x this batch's gradient norm: the clip bites)."""
    c, cfg_j, params, model = _setup()
    bj, bt = _batches(c)
    dt_j = dataclasses.replace(DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j), dense=None)
    dt_t = _rank_terms(c)
    _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, reweight, clip)


def test_vmc_update_through_the_grid_engine_matches_jax():
    """The default dispatch on both sides: DenseTerms for H2O STO-3G."""
    c, cfg_j, params, model = _setup()
    bj, bt = _batches(c)
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j)
    dt_t = DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    assert type(dt_j.dense).__name__ == type(dt_t.dense).__name__ == "DenseTerms"
    _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, False)


def _cisd(c):
    """(port, JAX) Hilbert spaces of a case restricted to at most 2 excitations."""
    import naqs_tpu as nq

    return (nt.Hilbert(n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors, n_exc_max=2),
            nq.Hilbert(n_qubits=c.h_j.n_qubits, sectors=c.h_j.sectors, n_exc_max=2))


@pytest.fixture
def force_xl(monkeypatch):
    """Both packages past their DenseTerms and FactorTerms caps: a filtered
    single-sector space gets the staircase program FactorTermsXL."""
    from naqs_tpu.ops import dense_engine as de_j
    from naqs_tpu_torch.ops import dense_engine as de_t

    for mod in (de_j, de_t):
        monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
        monkeypatch.setattr(mod, "FACT_SIZE_MAX", 1)


def test_vmc_update_through_the_staircase_engine_matches_jax(force_xl):
    """FactorTermsXL on both sides (H2O STO-3G, at most 2 excitations). The
    batch holds states outside the staircase, as the sampler's per-spin
    masking emits them: they get their diagonal as E_loc on both sides."""
    c, cfg_j, params, model = _setup()
    h_t, h_j = _cisd(c)
    bj, bt = _batches(c)
    assert not h_t.contains(bt.states[:120].numpy()).all()
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=h_j)
    dt_t = DeviceTerms.from_terms(c.terms_t, hilbert=h_t, device="cpu")
    assert type(dt_j.dense).__name__ == type(dt_t.dense).__name__ == "FactorTermsXL"
    _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, False)


def test_exact_energy_over_the_filtered_basis_matches_jax():
    c, cfg_j, params, model = _setup(seed=2)
    h_t, h_j = _cisd(c)
    tr = VMCTrainer(nt.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, amp_hidden=(16,),
                                  phase_hidden=(16,)), c.terms_t, h_t, device="cpu")
    tr.model = model
    want = trainer_j.exact_energy(cfg_j, params, DeviceTermsJ.from_terms(c.terms_j, hilbert=h_j),
                                  jnp.asarray(h_j.basis))
    assert abs(tr.exact_energy() - float(want)) < 5e-6


def test_sampled_steps_run_on_a_filtered_space(force_xl):
    """The trainer unchanged on a filtered Hilbert space: the default
    dispatch carries FactorTermsXL and the sampled steps give finite
    energies."""
    c = case("H2O")
    h_t, _ = _cisd(c)
    cfg = nt.NAQSConfig(n_qubits=14, sectors=h_t.sectors, amp_hidden=(16,), phase_hidden=(16,))
    tc = TrainConfig(n_samples=1e4, n_unq_samples_min=8, n_unq_samples_max=256, seed=4)
    tr = VMCTrainer(cfg, c.terms_t, h_t, tc, device="cpu")
    assert type(tr.dt.dense).__name__ == "FactorTermsXL"
    for _ in range(3):
        out = tr.step()
        assert np.isfinite(out["e_loc"]) and np.isfinite(out["e_loc_var"])


class _GrabOptimizer(torch.optim.Optimizer):
    """An optimizer whose step keeps the gradients it is given and applies
    nothing."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g["params"]]


def _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, reweight,
                              clip=None):
    grab = _grab_grads()
    _, g_j, m_j = trainer_j._vmc_update_impl(cfg_j, grab, params, grab.init(params),
                                             dt_j, bj, reweight)

    opt, sched = TrainConfig(lr=0.0, lr_final=0.0).make_optimizer(model.parameters())
    model.zero_grad()
    from naqs_tpu_torch.trainer import vmc_loss

    loss, e_mean, e_var = vmc_loss(model, dt_t, bt, reweight)
    loss.backward()
    assert abs(loss.item() - float(m_j["loss"])) < 5e-6
    assert abs(e_mean.item() - float(m_j["e_loc"])) < 5e-6
    assert abs(e_var.item() - float(m_j["e_loc_var"])) < 1e-4 * max(1.0, float(m_j["e_loc_var"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # and through vmc_update's own readback
    m_t = vmc_update(model, opt, sched, dt_t, bt, reweight)
    assert m_t["applied"] and not m_t["overflow"] and m_t["n_unique"] == 120
    assert abs(m_t["e_loc"] - float(m_j["e_loc"])) < 5e-6
    np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)
    if clip is None:
        return
    ring = np.zeros(50, np.float32)
    ring[:5] = 0.3 * float(m_j["grad_norm"])
    chain = optax.chain(trainer_j.adaptive_trailing_clip(clip, 50), grab)
    state = (dict(norms=jnp.asarray(ring), count=jnp.int32(5)), grab.init(params))
    _, (ring_j, g_j), m_j = trainer_j._vmc_update_impl(cfg_j, chain, params, state, dt_j, bj,
                                                       reweight)
    clip_t = TrainConfig(grad_clip_factor=clip).make_clip()
    clip_t.load_state_dict({"norms": ring, "count": 5})
    opt_g = _GrabOptimizer(model.parameters())
    m_t = vmc_update(model, opt_g, type("NoSchedule", (), {"step": lambda self: None})(),
                     dt_t, bt, reweight, clip=clip_t)
    assert m_t["applied"] and m_t["clip_scale"] < 0.2
    np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    for (k, _), g in zip(model.named_parameters(), opt_g.grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(clip_t.norms.numpy(), np.asarray(ring_j["norms"]), rtol=1e-4)
    assert int(clip_t.count) == int(ring_j["count"]) == 6


def test_adam_matches_optax_on_the_same_gradients():
    """3 updates across the LR phase switch (n_train=4: lr for updates 0-1,
    lr_final from update 2)."""
    _, _, params, model = _setup(seed=3)
    tc = TrainConfig(n_train=4, lr=1e-2, lr_final=3e-3)
    opt_t, sched = tc.make_optimizer(model.parameters())
    sched_j = optax.join_schedules(
        [optax.constant_schedule(tc.lr), optax.constant_schedule(tc.lr_final)], [2])
    opt_j = optax.adam(sched_j, b1=0.9, b2=0.99, eps=1e-15)
    state_j = opt_j.init(params)
    p_j = params
    rng = np.random.default_rng(0)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(scale=10.0 ** -step, size=x.shape)
                                  .astype(np.float32)), params)
        upd, state_j = opt_j.update(g, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_t = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
        for k, p in model.named_parameters():
            p.grad = g_t[k].clone()
        opt_t.step()
        sched.step()
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {step}")
    assert opt_t.param_groups[0]["lr"] == tc.lr_final


@pytest.mark.parametrize("fault", ["overflow", "nan"])
def test_update_is_withheld(fault):
    c, _, _, model = _setup()
    _check_update_is_withheld(c, model, _rank_terms(c), fault)


@pytest.mark.parametrize("fault", ["overflow", "nan"])
def test_update_is_withheld_through_the_grid_engine(fault):
    c, _, _, model = _setup()
    dt_t = DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    assert dt_t.dense is not None
    _check_update_is_withheld(c, model, dt_t, fault)


def _check_update_is_withheld(c, model, dt_t, fault):
    opt, sched = TrainConfig().make_optimizer(model.parameters())
    _, good = _batches(c, seed=1)
    vmc_update(model, opt, sched, dt_t, good)  # Adam state now non-empty
    _, bad = _batches(c, seed=2, overflow=fault == "overflow")
    if fault == "nan":
        bad.counts[0] = float("nan")
    before = _snapshot(model, opt)
    lr_before = opt.param_groups[0]["lr"], sched.last_epoch
    m = vmc_update(model, opt, sched, dt_t, bad)
    assert not m["applied"]
    _same(before, _snapshot(model, opt))
    assert (opt.param_groups[0]["lr"], sched.last_epoch) == lr_before
    m = vmc_update(model, opt, sched, dt_t, good)
    assert m["applied"]
    assert next(iter(opt.state.values()))["step"].item() == 2


def test_tempered_energy_matches_full_support():
    """Full support + reweight_by_psi: the sampled E equals the full-basis
    one whatever the sampling distribution."""
    c, _, _, model = _setup()
    dt_t = _rank_terms(c)
    from naqs_tpu_torch.trainer import vmc_loss

    batch = sample(model, torch.Generator().manual_seed(3), 1e8, 512, beta=0.3)
    assert int(batch.n_unique) == c.h_t.size
    basis = torch.as_tensor(c.h_t.basis)
    full = SampleBatch(states=basis, counts=torch.ones(len(basis), dtype=torch.float64),
                       n_unique=torch.tensor(len(basis)), overflow=torch.tensor(False))
    with torch.no_grad():
        e_s = vmc_loss(model, dt_t, batch, True)[1].item()
        e_f = vmc_loss(model, dt_t, full, True)[1].item()
    assert abs(e_s - e_f) < 1e-9


def test_controller_backs_off_on_overflow():
    c = case("H2O")
    cfg = nt.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, amp_hidden=(8,),
                        phase_hidden=(8,), masking="full")
    tc = TrainConfig(n_samples=1e6, n_unq_samples_min=4, n_unq_samples_max=32, seed=2)
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu")
    assert type(tr.dt.dense).__name__ == "DenseTerms"   # single sector: a grid program
    out = tr.step()
    assert out["n_unique"] <= 32 and out["n_samples"] < 1e6
    assert tr._ovf_n <= 1e6  # the overflow was noted for the hysteresis
    batch = tr.get_samples()
    assert not bool(batch.overflow) and int(batch.n_unique) <= 32


def test_h2_trains_to_chemical_accuracy():
    _check_h2_trains(rank_engine=True)


def test_h2_trains_through_the_grid_engine():
    _check_h2_trains(rank_engine=False)


def _check_h2_trains(rank_engine):
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors,
                        amp_hidden=(16,), phase_hidden=(16,))
    tc = TrainConfig(n_train=300, lr=1e-2, lr_final=5e-3, n_samples=1e5,
                     n_samples_max=1e7, n_unq_samples_min=2, n_unq_samples_max=16,
                     seed=1)
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu")
    assert type(tr.dt.dense).__name__ == "DenseTerms"
    if rank_engine:
        tr.dt = dataclasses.replace(tr.dt, dense=None)
    tr.run(300, output_freq=1000)
    e = tr.exact_energy()
    assert e - c.mol_t.fci_energy < CHEM_ACC, (e, c.mol_t.fci_energy)
    assert e > c.mol_t.fci_energy - 1e-6  # variational bound
    assert np.isfinite(tr.log["E_LOC"][-1][1])


def test_unported_train_options_raise():
    """The natural-gradient options are ported: each constructs alone, and a
    trainer refuses both at once, as the JAX package's does."""
    for kw in (dict(use_sr=True), dict(use_kfac=True)):
        TrainConfig(**kw)
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=4, sectors=c.h_t.sectors, amp_hidden=(8,), phase_hidden=(8,))
    with pytest.raises(ValueError, match="mutually exclusive"):
        VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(use_sr=True, use_kfac=True), device="cpu")
    assert TrainConfig(grad_clip_factor=2.0).make_clip() is not None  # ported


def test_sample_controller_overflow_hysteresis():
    """A recently overflowed n_samples level is not re-tried every step; it
    is re-probed after OVF_RETRY_STEPS steps (mirrors tests/test_extras.py)."""
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=4, sectors=c.h_t.sectors, amp_hidden=(8,),
                        phase_hidden=(8,), masking="full")
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(seed=0, n_samples=1e7),
                    device="cpu")
    assert not tr._grow_blocked()
    tr.n_samples = 1e8
    tr._note_overflow()
    tr.n_samples = 1e7
    assert tr._grow_blocked()
    tr.n_samples = 1e6
    assert not tr._grow_blocked()
    tr.n_samples = 1e7
    tr.n_steps += tr.OVF_RETRY_STEPS
    assert not tr._grow_blocked()


def test_lut_groups_step_matches_jax_multi_transform():
    """num_lut=2: the port's two Adam groups against naqs_tpu's
    optax.multi_transform chain (the MLP group on the two-phase schedule, the
    LUT tables at the constant lr_lut), 3 updates across the LR switch
    (n_train=4: lr for updates 0-1, lr_final from update 2). Each update's
    gradients are the JAX ones on the same batch at JAX's parameters, fed to
    both optimizers (the port's own gradients are held to them first); a
    withheld update moves neither group."""
    kw = dict(num_lut=2, aggregate_phase=True)
    c, cfg_j, params, model = _setup(seed=6, **kw)
    bj, bt = _batches(c)
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j)
    dt_t = DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, False)

    tc_j = trainer_j.TrainConfig(n_train=4, lr=1e-2, lr_final=3e-3, lr_lut=2e-2)
    tc = TrainConfig(n_train=4, lr=1e-2, lr_final=3e-3, lr_lut=2e-2)
    opt_j = tc_j.make_optimizer(has_lut=True)
    state_j = opt_j.init(params)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    named = dict(model.named_parameters())
    lut = [k for k in named if k.startswith("lut")]
    assert sorted(lut) == ["lut.0", "lut.1", "lut_phase.0", "lut_phase.1"]
    opt_t, sched = tc.make_optimizer([p for k, p in named.items() if k not in lut],
                                     [named[k] for k in lut])
    grab = _grab_grads()
    p_j = params
    for step in range(3):
        _, g_j, _ = trainer_j._vmc_update_impl(cfg_j, grab, p_j, grab.init(p_j), dt_j, bj,
                                               False)
        upd, state_j = opt_j.update(g_j, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_t = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
        for k, p in named.items():
            p.grad = g_t[k].clone()
        opt_t.step()
        sched.step()
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")
        lrs = [g["lr"] for g in opt_t.param_groups]
        assert lrs == [tc.lr if step < 1 else tc.lr_final, tc.lr_lut], (step, lrs)
    # a withheld update (overflow) leaves both groups and their Adam state
    _, bt_ovf = _batches(c, overflow=True)
    before = _snapshot(model, opt_t)
    m = vmc_update(model, opt_t, sched, dt_t, bt_ovf)
    assert not m["applied"]
    _same(before, _snapshot(model, opt_t))


def test_vmc_update_with_float64_params_matches_jax():
    """param_dtype float64: log_psi in float64, E_loc from its float32 cast,
    the loss and gradients in float64."""
    c, cfg_j, params, model = _setup(seed=8, param_dtype="float64", num_lut=2)
    assert {p.dtype for p in model.parameters()} == {torch.float64}
    bj, bt = _batches(c)
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j)
    dt_t = DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    _check_update_matches_jax(c, cfg_j, params, model, bj, bt, dt_j, dt_t, False)
