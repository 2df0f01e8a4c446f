"""The trainer's single-device extras against naqs_tpu's VMCTrainer: the
gradient clip, the warm starts, solve_h, the sampled-state counter, density
training, train_terms, save_psi and the LiH gate.

Both trainers start from the same parameters (the JAX trainer's, carried
across by params_from_jax) and see the same numpy inputs. Tolerances:
  * clip + Adam on the same gradients: parameters rtol 1e-5 / atol 1e-7 (as
    tests/test_torch_trainer.py holds Adam), the clip's ring rtol 1e-6;
  * warm starts (plain Adam, eps 1e-8, a few epochs): parameters atol 2e-5
    and the last loss rtol 1e-4: gradients agree to ~1e-6 relative (fp32
    sums in another order), Adam's steps are ~lr each;
  * solve_h: 1e-10 Ha (the same sparse H, each Lanczos to machine precision);
  * run_density: the d_p trajectory and unique counts equal, energies within
    5e-6 Ha (tests/test_torch_trainer.py's E_loc bar), lr 1e-4 so that a
    near-zero gradient rounding to the other sign moves little;
  * exact energies 5e-6 Ha (tests/test_torch_local_energy.py's mean bar);
  * save_psi: amplitudes rtol 1e-5 (f32 log-amplitudes, 7 printed digits),
    phases atol 1e-5;
  * the LiH gate: within 1.6 mHa of FCI, and within 1e-5 Ha of the JAX
    package run through the same protocol.

Torch runs on one thread here, as in tests/test_torch_trainer.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu import trainer as trainer_j
from naqs_tpu_torch import trainer as trainer_t
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.sampler import SampleBatch
from naqs_tpu_torch.trainer import TrainConfig, TrailingClip, VMCTrainer, save_psi, vmc_update
from naqs_tpu_torch.utils import spin as spin_t
from test_torch_support import case, near_hf_states, padded_batch, to_u64

CHEM_ACC = 1.6e-3
E_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(name="LiH", width=16, train_terms=None, **tc):
    """(case, JAX trainer, port trainer) with the port's model holding the
    JAX trainer's initial parameters."""
    c = case(name)
    kw = dict(amp_hidden=(width,), phase_hidden=(width,))
    n = c.mol_t.n_qubits
    tr_j = trainer_j.VMCTrainer(
        nq.NAQSConfig(n_qubits=n, sectors=c.h_j.sectors, **kw), c.terms_j, c.h_j,
        trainer_j.TrainConfig(**tc),
        train_terms=None if train_terms is None else nq.compile_pauli_terms(train_terms, n))
    tr_t = VMCTrainer(nt.NAQSConfig(n_qubits=n, sectors=c.h_t.sectors, **kw), c.terms_t,
                      c.h_t, TrainConfig(**tc), device="cpu",
                      train_terms=None if train_terms is None
                      else nt.compile_pauli_terms(train_terms, n))
    _copy_params(tr_j, tr_t)
    return c, tr_j, tr_t


def _copy_params(tr_j, tr_t):
    tr_t.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tr_j.params)))


def _assert_params_close(tr_j, tr_t, atol, rtol=0.0):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tr_j.params))
    for k, p in tr_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


# ------------------------------------------------------------ gradient clip

def test_clip_and_adam_match_optax_over_a_wrapping_ring():
    """60 updates through a ring of 50: optax.chain(adaptive_trailing_clip,
    adam) against TrailingClip in front of torch's Adam, on the same
    gradients; their scale varies so that the clip bites on some steps."""
    c, tr_j, tr_t = _pair("H2", 8)
    tc = TrainConfig(n_train=80, lr=1e-2, lr_final=3e-3, grad_clip_factor=1.5)
    opt_t, sched = tc.make_optimizer(tr_t.model.parameters())
    clip = tc.make_clip()
    params_t = list(tr_t.model.parameters())
    sched_j = optax.join_schedules(
        [optax.constant_schedule(tc.lr), optax.constant_schedule(tc.lr_final)], [40])
    opt_j = optax.chain(trainer_j.adaptive_trailing_clip(1.5, 50),
                        optax.adam(sched_j, b1=0.9, b2=0.99, eps=1e-15))
    p_j = tr_j.params
    state_j = opt_j.init(p_j)
    rng = np.random.default_rng(0)
    clipped = 0
    for step in range(60):
        size = 10.0 ** rng.uniform(-1, 1) * (20.0 if step % 7 == 3 else 1.0)
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(scale=size, size=x.shape).astype(np.float32)), p_j)
        upd, state_j = opt_j.update(g, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_t = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
        for k, p in tr_t.model.named_parameters():
            p.grad = g_t[k].clone()
        scale, kept = clip.scale(trainer_t._grad_norm(params_t))
        clipped += float(scale) < 1.0
        for p in params_t:
            p.grad.mul_(scale)
        clip.commit(kept)
        opt_t.step()
        sched.step()
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
        for k, p in tr_t.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")
        np.testing.assert_allclose(clip.norms.numpy(), np.asarray(state_j[0]["norms"]),
                                   rtol=1e-6)
        assert int(clip.count) == int(state_j[0]["count"])
    assert 5 <= clipped < 60


def test_empty_ring_limits_the_norm_to_init_max():
    clip = TrailingClip(3.0)
    scale, kept = clip.scale(torch.tensor(4000.0))
    assert float(kept) == pytest.approx(1e3, rel=1e-6)
    assert float(scale) == pytest.approx(1e3 / 4000.0, rel=1e-6)
    assert float(clip.scale(torch.tensor(5.0))[0]) == 1.0


@pytest.mark.parametrize("fault", ["overflow", "nan"])
def test_withheld_update_leaves_the_ring_untouched(fault):
    c, _, tr_t = _pair("H2O", 16, grad_clip_factor=2.0)
    rng = np.random.default_rng(1)
    s, _, _, counts = padded_batch(near_hf_states(c, 60, rng), 64, rng)

    def batch(overflow=False, nan=False):
        cnt = counts.copy()
        if nan:
            cnt[0] = np.nan
        return SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(cnt),
                           n_unique=torch.tensor(60), overflow=torch.tensor(overflow))

    dt = tr_t.dt
    for _ in range(3):
        assert vmc_update(tr_t.model, tr_t.optimizer, tr_t.scheduler, dt, batch(),
                          clip=tr_t.clip)["applied"]
    ring = tr_t.clip.state_dict()
    params = {k: v.clone() for k, v in tr_t.model.state_dict().items()}
    m = vmc_update(tr_t.model, tr_t.optimizer, tr_t.scheduler, dt,
                   batch(overflow=fault == "overflow", nan=fault == "nan"), clip=tr_t.clip)
    assert not m["applied"]
    assert torch.equal(tr_t.clip.norms, ring["norms"]) and int(tr_t.clip.count) == 3
    assert all(torch.equal(params[k], v) for k, v in tr_t.model.state_dict().items())
    assert vmc_update(tr_t.model, tr_t.optimizer, tr_t.scheduler, dt, batch(),
                      clip=tr_t.clip)["applied"]
    assert int(tr_t.clip.count) == 4


# ------------------------------------------------------------ warm starts

def test_pre_flatten_matches_jax():
    c, tr_j, tr_t = _pair("LiH", 16, seed=3)
    tr_j.pre_flatten(3, lr=1e-3, batch_size=64)
    tr_t.pre_flatten(3, lr=1e-3, batch_size=64)
    _assert_params_close(tr_j, tr_t, atol=2e-5)


def test_pre_train_hf_matches_jax():
    from naqs_tpu_torch.models.nade import log_psi

    c, tr_j, tr_t = _pair("LiH", 16, seed=4)
    hf = torch.tensor([c.h_t.hf_state()])
    with torch.no_grad():
        la_before = float(log_psi(tr_t.model, hf)[0])
    tr_j.pre_train_hf(20, lr=5e-3)
    tr_t.pre_train_hf(20, lr=5e-3)
    _assert_params_close(tr_j, tr_t, atol=2e-5)
    # the HF amplitude grew: the log-space BCE has a gradient from the start
    with torch.no_grad():
        assert float(log_psi(tr_t.model, hf)[0]) > la_before + 0.1


@pytest.mark.parametrize("loss", ["mse", "wmse", "overlap"])
def test_pre_train_targets_matches_jax(loss):
    c, tr_j, tr_t = _pair("LiH", 16, seed=5)
    rng = np.random.default_rng(2)
    states = rng.choice(c.h_t.basis, size=80, replace=False)
    target = rng.normal(size=80) * np.exp(-rng.uniform(0, 6, size=80))
    l_j = tr_j.pre_train_targets(to_u64(states), target.astype(np.complex128), 8, loss=loss)
    l_t = tr_t.pre_train_targets(states, target.astype(np.complex128), 8, loss=loss)
    assert l_t == pytest.approx(l_j, rel=1e-4)
    _assert_params_close(tr_j, tr_t, atol=2e-5)


# ------------------------------------------------------------ counter, solve_h

def _counter_inputs(c, n, seed):
    rng = np.random.default_rng(seed)
    states = np.sort(rng.choice(c.h_t.basis, size=n, replace=False))
    counts = rng.permutation(np.arange(1, n + 1)).astype(np.float64) * 3.0  # distinct
    return states, counts


def test_record_arrays_matches_jax_with_and_without_pruning():
    c, tr_j, tr_t = _pair("LiH", 8)
    for cap in (None, 7):
        if cap:
            tr_j.COUNTER_MAX = tr_t.COUNTER_MAX = cap
        tr_j.sampled_counter, tr_t.sampled_counter = {}, {}
        for seed in range(3):
            states, counts = _counter_inputs(c, 40, seed)
            counts = counts + 0.25 * seed
            tr_j._record_arrays(to_u64(states), counts)
            tr_t._record_arrays(states, counts)
            assert tr_t.sampled_counter == tr_j.sampled_counter
            assert list(tr_t.sampled_counter) == list(tr_j.sampled_counter)
        assert len(tr_t.sampled_counter) <= (cap or 120)


def test_record_samples_reads_the_batch_every_fifth_step():
    c, _, tr_t = _pair("LiH", 8)
    rng = np.random.default_rng(0)
    s, _, _, counts = padded_batch(near_hf_states(c, 30, rng), 40, rng)
    batch = SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                        n_unique=torch.tensor(30), overflow=torch.tensor(False))
    tr_t.n_steps = 3
    tr_t._record_samples(batch, 30)
    assert tr_t.sampled_counter == {}
    tr_t.n_steps = 5
    tr_t._record_samples(batch, 30)
    assert tr_t.sampled_counter == dict(zip(s[:30].tolist(), counts[:30].tolist()))


def test_solve_h_matches_jax_on_the_counter_states_and_spin():
    c, tr_j, tr_t = _pair("LiH", 8)
    states, counts = _counter_inputs(c, 150, 0)
    tr_j._record_arrays(to_u64(states), counts)
    tr_t._record_arrays(states, counts)
    e_j, n_j = tr_j.solve_h(k_max=100)
    e_t, n_t = tr_t.solve_h(k_max=100)
    assert n_t == n_j == 100 and abs(e_t - e_j) <= 1e-10
    sub = np.sort(states[np.argsort(counts)[-100:]])
    assert abs(tr_t.solve_h(states=sub)[0] - e_t) <= 1e-10
    basis = c.h_t.basis
    e_full_t = tr_t.solve_h(states=basis)[0]
    assert abs(e_full_t - tr_j.solve_h(states=to_u64(basis))[0]) <= 1e-10
    assert abs(e_full_t - c.mol_t.fci_energy) < 1e-6
    e_s2_t = tr_t.solve_h(states=basis, target_s2=2.0)[0]
    e_s2_j = tr_j.solve_h(states=to_u64(basis), target_s2=2.0)[0]
    assert abs(e_s2_t - e_s2_j) <= 1e-10 and e_s2_t > e_full_t + 1e-3


def test_solve_h_falls_back_to_one_fresh_sample():
    c, _, tr_t = _pair("LiH", 8, n_unq_samples_max=256)
    e, n = tr_t.solve_h(n_samps=1e5, k_max=20)
    assert n == 20 and np.isfinite(e) and e >= c.mol_t.fci_energy - 1e-9
    assert tr_t.sampled_counter == {}


def test_warm_start_writes_its_cache_in_the_working_directory(tmp_path, monkeypatch):
    """An explicit subspace over 50,000 states is cached under data/ws_cache/
    of the working directory (here tmp_path), keyed by the states and terms;
    the second call reads the eigenpair back instead of solving again."""
    monkeypatch.chdir(tmp_path)
    c, _, tr_t = _pair("LiH", 8)
    # the basis, repeated with a high unused bit set: 51,750 states
    big = np.concatenate([c.h_t.basis | (np.int64(k) << 40) for k in range(230)])
    solves = []

    def lowest(h, states, target_s2):
        solves.append(len(states))
        return -1.5, np.full(len(states), len(states) ** -0.5)

    monkeypatch.setattr(trainer_t, "assemble_sparse_hamiltonian_np", lambda terms, st: None)
    monkeypatch.setattr(tr_t, "_lowest_state", lowest)
    assert tr_t.warm_start_from_solve_h(1, states=big, loss="overlap") == (-1.5, len(big))
    assert tr_t.warm_start_from_solve_h(1, states=big[::-1], loss="overlap") == (-1.5, len(big))
    assert solves == [len(big)]
    assert len(list((tmp_path / "data" / "ws_cache").glob("*.npz"))) == 1
    assert tr_t.ws_result == (-1.5, len(big))


# ------------------------------------------------------------ density, train_terms

def test_run_density_matches_jax():
    kw = dict(lr=1e-4, n_unq_samples_min=20, n_unq_samples_max=256, seed=2)
    c, tr_j, tr_t = _pair("LiH", 16, **kw)
    tr_j.run_density(2, output_freq=100)
    tr_t.run_density(2, output_freq=100)
    assert tr_t.d_p == tr_j.d_p
    assert [v for _, v in tr_t.log["N_UNIQUE_SAMP"]] == [v for _, v in tr_j.log["N_UNIQUE_SAMP"]]
    np.testing.assert_allclose([v for _, v in tr_t.log["E_LOC"]],
                               [v for _, v in tr_j.log["E_LOC"]], rtol=0, atol=E_TOL)
    assert tr_t.n_steps == 2 and set(tr_t.sampled_counter) == set(tr_j.sampled_counter)
    for k, v in tr_j.sampled_counter.items():
        assert tr_t.sampled_counter[k] == pytest.approx(v, rel=1e-5)


def test_run_density_enumerates_what_jax_enumerates():
    """sample_density draws nothing at random: from the same parameters the
    two packages give the same states, and masses within f32 rounding."""
    from naqs_tpu.sampler import sample_density as density_j
    from naqs_tpu_torch.sampler import sample_density as density_t

    c, tr_j, tr_t = _pair("LiH", 16)
    b_j = density_j(tr_j.cfg, tr_j.params, jnp.float64(1e-6), 256)
    b_t = density_t(tr_t.model, 1e-6, 256)
    n = int(b_j.n_unique)
    assert int(b_t.n_unique) == n > 20
    np.testing.assert_array_equal(b_t.states.numpy()[:n], np.asarray(b_j.states)[:n].astype(np.int64))
    np.testing.assert_allclose(b_t.counts.numpy()[:n], np.asarray(b_j.counts)[:n], rtol=1e-5)


def test_train_terms_exact_energy_reports_pure_h():
    c = case("LiH")
    pen = spin_t.penalized_termdict(c.mol_t.qubit_hamiltonian, c.mol_t.n_qubits, 0.5)
    _, tr_j, tr_t = _pair("LiH", 16, train_terms=pen, seed=6)
    _, _, plain_t = _pair("LiH", 16, seed=6)
    e_t = tr_t.exact_energy()
    assert e_t == plain_t.exact_energy()
    assert abs(e_t - tr_j.exact_energy()) < E_TOL
    assert abs(e_t - float(trainer_j.exact_energy(tr_j.cfg, tr_j.params, tr_j.dt_h,
                                                   jnp.asarray(c.h_j.basis)))) < E_TOL
    # dt is the training operator: <H + 0.5 S^2> >= <H>, with equality only
    # for a pure singlet
    from naqs_tpu_torch.models.nade import log_psi
    from naqs_tpu_torch.ops.local_energy import quadratic_energy

    basis = torch.as_tensor(c.h_t.basis)
    with torch.no_grad():
        la, ph = log_psi(tr_t.model, basis)
        e_pen = float(quadratic_energy(tr_t.dt, basis, la, ph, len(basis)))
    assert e_pen > e_t + 1e-6


# ------------------------------------------------------------ save_psi, the gate

def test_save_psi_matches_jax(tmp_path):
    c, tr_j, tr_t = _pair("LiH", 16, seed=7)
    trainer_j.save_psi(tr_j, str(tmp_path / "j"))
    save_psi(tr_t, str(tmp_path / "t"))

    def by_index(prefix):
        rows = np.loadtxt(f"{prefix}.txt")
        idx = np.loadtxt(f"{prefix}_basis_idxs.txt", dtype=np.int64)
        bits = np.loadtxt(f"{prefix}_basis.txt", dtype=np.int64)
        out = np.zeros_like(rows)
        out[idx] = rows
        return out, idx, bits

    (v_t, idx_t, bits_t), (v_j, _, _) = by_index(tmp_path / "t"), by_index(tmp_path / "j")
    np.testing.assert_allclose(v_t[:, 0], v_j[:, 0], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(v_t[:, 1], v_j[:, 1], rtol=0, atol=1e-5)
    assert abs(np.sum(v_t[:, 0] ** 2) - 1.0) < 1e-4
    assert np.all(np.diff(np.loadtxt(tmp_path / "t.txt")[:, 0]) <= 0)
    packed = np.sum(bits_t * (np.int64(1) << np.arange(12)), axis=1)
    np.testing.assert_array_equal(packed, c.h_t.basis[idx_t])
    with pytest.raises(ValueError):
        save_psi(tr_t, str(tmp_path / "x"), max_states=100)


def test_lih_gate_reaches_chemical_accuracy_and_agrees_with_jax():
    """ROADMAP's LiH gate: a fit of the model to the full-basis ground state
    (warm_start_from_solve_h over the whole basis, overlap loss, width 32,
    600 epochs at lr 5e-3) puts exact_energy() within 1.6 mHa of FCI; the
    JAX package through the same protocol from the same parameters lands
    within 1e-5 Ha of the port."""
    c, tr_j, tr_t = _pair("LiH", 32)
    e0_t, n_t = tr_t.warm_start_from_solve_h(600, lr=5e-3, states=c.h_t.basis, loss="overlap")
    e0_j, _ = tr_j.warm_start_from_solve_h(600, lr=5e-3, states=to_u64(c.h_t.basis),
                                           loss="overlap")
    assert n_t == c.h_t.size and abs(e0_t - e0_j) <= 1e-10
    e_t, e_j = tr_t.exact_energy(), tr_j.exact_energy()
    fci = c.mol_t.fci_energy
    assert fci - 1e-9 <= e_t < fci + CHEM_ACC, (e_t, fci)
    assert abs(e_t - e_j) < 1e-5, (e_t, e_j)
    assert tr_t.ws_result == (e0_t, c.h_t.size)
    json.dumps(tr_t.ws_result)  # persisted in the checkpoint's json
