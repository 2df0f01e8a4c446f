"""Exact mode of the port against naqs_tpu: the sector table and
`log_psi_table`, exact local energies (`queries=` against the whole
SENTINEL-padded sector) on every engine, the update with `table=`,
`vmc_update_scan` (the device window) and `run_exact` in both modes, and
the CLI's `-exact_eloc` and `-exact_sampling`.

Tolerances, as in test_torch_trainer.py and test_torch_local_energy.py:
log-amplitudes and phases rtol 1e-6 / atol 1e-6 (float32 forward, another
summation order); E_loc per row 2e-5 Ha + 1e-5 * sum_s' |H_ss'| |psi(s') /
psi(s)| (fp32 sums in another order than JAX's P @ A, or than the float64
oracle H @ psi / psi; the second term bounds them where the amplitude
ratios are large), the weighted mean 5e-6 Ha; gradients rtol 1e-4 / atol
1e-6. The window is held to the port's own sequential `vmc_update` at rtol
1e-6 (on the CPU its Adam is torch.optim.Adam's formula, and the two agree
bit for bit). End-to-end parameters are not compared with JAX: with eps =
1e-15 a near-zero gradient flips sign.

Torch runs on one thread here (`_one_torch_thread`), as in
test_torch_trainer.py, so that the fp32 sums held at rtol 1e-4 do not
depend on the thread count.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu import trainer as trainer_j
from naqs_tpu.hamiltonian import assemble_sparse_hamiltonian_np
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu.sampler import SampleBatch as SampleBatchJ
from naqs_tpu_torch import cli as cli_t
from naqs_tpu_torch import trainer as trainer_t
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.sampler import SampleBatch
from naqs_tpu_torch.trainer import (TrainConfig, UpdateWindow, VMCTrainer, log_psi_table,
                                    sector_table, vmc_update, vmc_update_scan)
from naqs_tpu_torch.utils.bits import SENTINEL
from naqs_tpu_torch.utils.molecule import molecule_from_fields, save_molecule_npz
from test_torch_support import case, fields, near_hf_states, padded_batch, to_u64

ROW_ATOL, ROW_RTOL = 2e-5, 1e-5
MEAN_TOL = 5e-6
CHEM_ACC = 1.6e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(c, seed=0, hilbert=None, **kw):
    """(JAX config, JAX params, the port's model with the same weights)."""
    h = hilbert or c.h_t
    kw = dict(dict(amp_hidden=(16,), phase_hidden=(16,)), **kw)
    cfg_j = nade_j.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=h.sectors, **kw)
    params = nade_j.init_params(jax.random.key(seed), cfg_j)
    model = nade_t.NADE(nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=h.sectors, **kw))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, params, model


def _jax_table(basis, chunk):
    """The JAX package's sector table of `basis` (uint64, all-ones padding)."""
    n = len(basis)
    n_pad = -(-n // chunk) * chunk if n > chunk else n
    buf = np.full((n_pad,), np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    buf[:n] = basis
    return jnp.asarray(buf), jnp.int32(n)


def _cisd(c):
    """(port, JAX) Hilbert spaces of a case restricted to at most 2 excitations."""
    return (nt.Hilbert(n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors, n_exc_max=2),
            nq.Hilbert(n_qubits=c.h_j.n_qubits, sectors=c.h_j.sectors, n_exc_max=2))


def _caps(monkeypatch, dense=None, fact=None):
    """Both packages' grid-program caps set alike (None leaves one as it is)."""
    from naqs_tpu.ops import dense_engine as de_j
    from naqs_tpu_torch.ops import dense_engine as de_t

    for mod in (de_j, de_t):
        if dense is not None:
            monkeypatch.setattr(mod, "DENSE_SIZE_MAX", dense)
        if fact is not None:
            monkeypatch.setattr(mod, "FACT_SIZE_MAX", fact)


# -------------------------------------------------------------- log_psi_table

@pytest.mark.parametrize("name,chunk", [("H2O", 64), ("LiH", 50)])
def test_log_psi_table_matches_jax(name, chunk):
    """A chunk smaller than the basis: the SENTINEL padding up to a chunk
    multiple, and every chunk, padding rows included, against JAX's lax.map."""
    c = case(name)
    cfg_j, params, model = _model(c, seed=1)
    basis = c.h_t.basis
    t_states, t_n = sector_table(basis, chunk, "cpu")
    n = len(basis)
    assert t_states.shape[0] == -(-n // chunk) * chunk > n and int(t_n) == n
    assert t_n.dtype == torch.int64 and t_n.dim() == 0
    assert torch.equal(t_states[:n], torch.as_tensor(basis))
    assert bool((t_states[n:] == SENTINEL).all())
    la, ph = log_psi_table(model, t_states, chunk)
    la_j, ph_j = trainer_j.log_psi_table(cfg_j, params, _jax_table(c.h_j.basis, chunk)[0],
                                         chunk)
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), rtol=1e-6, atol=1e-6)
    # one chunk's rows are those of one direct call
    la_d, ph_d = nade_t.log_psi(model, t_states[:chunk])
    assert torch.equal(la[:chunk], la_d.detach()) and torch.equal(ph[:chunk], ph_d.detach())
    # a basis that fits one chunk is left unpadded
    assert sector_table(basis, n, "cpu")[0].shape[0] == n
    with pytest.raises(ValueError):
        log_psi_table(model, t_states[:chunk + 1], chunk)


# -------------------------------------------------------------- exact E_loc

ENGINES = ["grid", "factored", "rank", "sort", "xl"]


def _engine_terms(c, engine, monkeypatch):
    """(port DeviceTerms, JAX DeviceTerms, port Hilbert, JAX Hilbert) with
    both packages' dispatch forced alike."""
    h_t, h_j = c.h_t, c.h_j
    if engine == "factored":
        _caps(monkeypatch, dense=1)
    elif engine == "xl":
        _caps(monkeypatch, dense=1, fact=1)
        h_t, h_j = _cisd(c)
    dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=h_j)
    want = {"grid": "DenseTerms", "factored": "FactorTerms", "xl": "FactorTermsXL"}
    if engine in want:
        assert type(dt_t.dense).__name__ == type(dt_j.dense).__name__ == want[engine]
    else:
        off = dict(dense=None) if engine == "rank" else dict(rank_spec=None, dense=None)
        dt_t, dt_j = dataclasses.replace(dt_t, **off), dataclasses.replace(dt_j, **off)
    return dt_t, dt_j, h_t, h_j


def _oracle(terms_j, basis, la, ph):
    """float64 (H @ psi) / psi over the basis, and sum_s' |H_ss'| |psi(s') /
    psi(s)|, the scale of each row's fp32 sum."""
    H = assemble_sparse_hamiltonian_np(terms_j, basis)
    la, ph = la.astype(np.float64), ph.astype(np.float64)
    psi = np.exp(la - la.max() + 1j * ph)
    return (H @ psi) / psi, (abs(H) @ np.abs(psi)) / np.abs(psi)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["LiH", "H2O"])
def test_exact_local_energy_matches_jax_and_the_oracle(name, engine, monkeypatch):
    """local_energy(queries=) against the whole padded sector table, on each
    engine, against JAX's on the same table and against H @ psi / psi; the
    SENTINEL query rows past the live ones read no numerator (e_im exactly 0)
    and no padding row of the table puts a NaN anywhere."""
    c = case(name)
    dt_t, dt_j, h_t, h_j = _engine_terms(c, engine, monkeypatch)
    cfg_j, params, model = _model(c, seed=2, hilbert=h_t)
    basis = h_t.basis
    chunk = 64
    t_states, t_n = sector_table(basis, chunk, "cpu")
    t_la, t_ph = log_psi_table(model, t_states, chunk)
    buf_j, n_j = _jax_table(h_j.basis, chunk)
    tla_j, tph_j = trainer_j.log_psi_table(cfg_j, params, buf_j, chunk)
    rng = np.random.default_rng(3)
    m = min(96, len(basis))
    sub = np.sort(rng.choice(len(basis), size=m, replace=False))
    cap = m + 9
    q = np.full(cap, SENTINEL, dtype=np.int64)
    q[:m] = basis[sub]
    q_la, q_ph = (x.detach() for x in nade_t.log_psi(model, torch.as_tensor(q)))
    e_re, e_im = le_t.local_energy(dt_t, t_states, t_la, t_ph, t_n,
                                   queries=(torch.as_tensor(q), q_la, q_ph))
    e_re, e_im = e_re.numpy(), e_im.numpy()
    qj_la, qj_ph = nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(q)))
    ej_re, ej_im = le_j.local_energy(dt_j, buf_j, tla_j, tph_j, n_j,
                                     queries=(jnp.asarray(to_u64(q)), qj_la, qj_ph))
    e_ora, mag = _oracle(c.terms_j, h_j.basis, t_la[:len(basis)].numpy(),
                         t_ph[:len(basis)].numpy())
    tol = ROW_ATOL + ROW_RTOL * mag[sub]
    assert np.isfinite(e_re).all() and np.isfinite(e_im).all()
    assert (np.abs(e_re[:m] - np.asarray(ej_re)[:m]) <= tol).all()
    assert (np.abs(e_im[:m] - np.asarray(ej_im)[:m]) <= tol).all()
    assert (np.abs(e_re[:m] - e_ora[sub].real) <= tol).all()
    assert (np.abs(e_im[:m] - e_ora[sub].imag) <= tol).all()
    assert (e_im[m:] == 0).all()
    w = rng.uniform(0.5, 1.5, size=m)
    w /= w.sum()
    assert abs(np.sum(w * e_re[:m]) - np.sum(w * e_ora[sub].real)) < MEAN_TOL


# -------------------------------------------------------------- the update

def _grab_grads():
    """An optax transform that applies nothing and keeps the gradients as its
    state, so _vmc_update_impl hands back the JAX gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


@pytest.mark.parametrize("engine", ["grid", "rank"])
def test_vmc_update_with_a_table_matches_jax(engine, monkeypatch):
    """One update with table= on a sampled-style batch (120 of 128 rows
    live, SENTINEL padding) against JAX's _vmc_update_impl(table=): loss,
    energy, variance and every gradient; then through vmc_update's readback."""
    c = case("H2O")
    dt_t, dt_j, _, _ = _engine_terms(c, engine, monkeypatch)
    cfg_j, params, model = _model(c, seed=4)
    rng = np.random.default_rng(5)
    s, _, _, counts = padded_batch(near_hf_states(c, 120, rng), 128, rng)
    bj = SampleBatchJ(states=jnp.asarray(to_u64(s)), counts=jnp.asarray(counts),
                      n_unique=jnp.int32(120), overflow=jnp.array(False))
    bt = SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                     n_unique=torch.tensor(120), overflow=torch.tensor(False))
    chunk = 64
    table = sector_table(c.h_t.basis, chunk, "cpu")
    grab = _grab_grads()
    _, g_j, m_j = trainer_j._vmc_update_impl(cfg_j, grab, params, grab.init(params), dt_j, bj,
                                             False, table=_jax_table(c.h_j.basis, chunk),
                                             fwd_chunk=chunk)
    model.zero_grad()
    loss, e_mean, e_var = trainer_t.vmc_loss(model, dt_t, bt, False, table, chunk)
    loss.backward()
    assert abs(loss.item() - float(m_j["loss"])) < MEAN_TOL
    assert abs(e_mean.item() - float(m_j["e_loc"])) < MEAN_TOL
    assert abs(e_var.item() - float(m_j["e_loc_var"])) < 1e-4 * max(1.0, float(m_j["e_loc_var"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the truncated estimator differs on this batch: the table is read
    e_trunc = trainer_t.vmc_loss(model, dt_t, bt, False)[1].item()
    assert abs(e_trunc - e_mean.item()) > 1e-3
    opt, sched = TrainConfig(lr=0.0, lr_final=0.0).make_optimizer(model.parameters())
    m_t = vmc_update(model, opt, sched, dt_t, bt, False, table=table, fwd_chunk=chunk)
    assert m_t["applied"] and abs(m_t["e_loc"] - float(m_j["e_loc"])) < MEAN_TOL
    np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)


# -------------------------------------------------------------- the window

def _trainer(c=None, n_train=4, clip=2.0, **kw):
    """A CPU trainer on H2O STO-3G (two from the same seed are alike)."""
    c = c or case("H2O")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                        phase_hidden=(16,))
    tc = TrainConfig(**dict(dict(n_train=n_train, lr=1e-2, lr_final=3e-3,
                                 grad_clip_factor=clip, seed=3), **kw))
    return VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu")


def _state(tr):
    """Everything an update may change: parameters, Adam's moments and step
    counts, the LR position and each group's LR, the clip ring."""
    return ({k: p.detach().clone() for k, p in tr.model.named_parameters()},
            [{k: v.clone() for k, v in s.items()} for s in tr.optimizer.state.values()],
            (tr.scheduler.last_epoch, [g["lr"] for g in tr.optimizer.param_groups]),
            None if tr.clip is None else (tr.clip.norms.clone(), int(tr.clip.count)))


def _assert_close(a, b, rtol=1e-6):
    (pa, sa, la, ca), (pb, sb, lb, cb) = a, b
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), rtol=rtol, atol=0, err_msg=k)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x.keys() == y.keys() and torch.equal(x["step"], y["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), rtol=rtol, atol=0)
    assert la == lb
    if ca is None:
        assert cb is None
    else:
        np.testing.assert_allclose(ca[0].numpy(), cb[0].numpy(), rtol=rtol)
        assert ca[1] == cb[1]


@pytest.mark.parametrize("n_live,length", [(5, 5), (3, 8)], ids=["5_of_5", "3_of_8"])
def test_window_equals_sequential_updates(n_live, length):
    """vmc_update_scan over the full basis against n_live vmc_update calls
    from the same state: parameters, both moments, the step count, the LR
    position (n_train=4 switches the LR after 2 applied updates, inside the
    window) and the clip ring; each row of the metrics; the rows past
    n_live are not computed."""
    a, b = _trainer(), _trainer()
    batch = a._basis_batch(a.hilbert.basis)
    ms, applied = vmc_update_scan(a.model, a.optimizer, a.scheduler, a.dt, batch, n_live,
                                  length=length, clip=a.clip)
    rows = [vmc_update(b.model, b.optimizer, b.scheduler, b.dt, batch, True, clip=b.clip)
            for _ in range(n_live)]
    assert ms.shape == (length, 2) and ms.dtype == np.float64
    assert applied.tolist() == [True] * n_live + [False] * (length - n_live)
    np.testing.assert_allclose(ms[:n_live], [[m["e_loc"], m["e_loc_var"]] for m in rows],
                               rtol=1e-6)
    assert np.isnan(ms[n_live:]).all()
    _assert_close(_state(a), _state(b))
    assert a.scheduler.last_epoch == n_live and int(a.clip.count) == n_live
    assert a.optimizer.param_groups[0]["lr"] == a.tc.lr_at(n_live)
    # a later sequential step goes on from where the window left
    m_a = vmc_update(a.model, a.optimizer, a.scheduler, a.dt, batch, True, clip=a.clip)
    m_b = vmc_update(b.model, b.optimizer, b.scheduler, b.dt, batch, True, clip=b.clip)
    assert m_a["e_loc"] == pytest.approx(m_b["e_loc"], rel=1e-9)
    _assert_close(_state(a), _state(b))


def test_window_withholds_a_non_finite_step(monkeypatch):
    """The window's second step made non-finite (its loss times NaN, as a
    NaN count poisons test_update_is_withheld's): only that step is
    withheld, and the window ends as steps 1, 3 and 4 through vmc_update
    do; a fresh optimizer whose only window is withheld keeps no Adam state."""
    a, b = _trainer(), _trainer()
    batch = a._basis_batch(a.hilbert.basis)
    loss_fn, calls = trainer_t.vmc_loss, [0]

    def faulty(*args, **kw):
        calls[0] += 1
        loss, e_mean, e_var = loss_fn(*args, **kw)
        return (loss * float("nan"), e_mean, e_var) if calls[0] == 2 else (loss, e_mean, e_var)

    monkeypatch.setattr(trainer_t, "vmc_loss", faulty)
    ms, applied = vmc_update_scan(a.model, a.optimizer, a.scheduler, a.dt, batch, 4, length=4,
                                  clip=a.clip)
    monkeypatch.setattr(trainer_t, "vmc_loss", loss_fn)
    assert applied.tolist() == [True, False, True, True]
    for _ in range(3):
        assert vmc_update(b.model, b.optimizer, b.scheduler, b.dt, batch, True,
                          clip=b.clip)["applied"]
    _assert_close(_state(a), _state(b))
    assert a.scheduler.last_epoch == 3 and int(a.clip.count) == 3
    assert next(iter(a.optimizer.state.values()))["step"].item() == 3
    # every step withheld: nothing moves, and a fresh optimizer stays empty
    c = _trainer()
    before = _state(c)
    ovf = dataclasses.replace(batch, overflow=torch.tensor(True))
    _, applied = vmc_update_scan(c.model, c.optimizer, c.scheduler, c.dt, ovf, 2, length=2,
                                 clip=c.clip)
    assert not applied.any() and not c.optimizer.state
    _assert_close(before, _state(c), rtol=0)


def test_window_step_reads_nothing_back(monkeypatch):
    """No host readback inside the window: every Tensor method that would
    copy a value to the host (on the card, a sync) raises during its
    steps; the one readback is close()'s."""
    tr = _trainer()
    batch = tr._basis_batch(tr.hilbert.basis)
    window = UpdateWindow(tr.model, tr.optimizer, tr.scheduler, 3, tr.clip)

    def refuse(self, *args, **kw):
        raise AssertionError("a host readback inside the window")

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
            mp.setattr(torch.Tensor, name, refuse)
        for _ in range(3):
            window.step(tr.dt, batch)
    ms, applied = window.close()
    assert applied.all() and np.isfinite(ms).all()


def test_window_first_row_matches_jax_scan():
    """The first (e_loc, e_loc_var) row of a window over the full basis
    against JAX's vmc_update_scan on the same parameters and a fresh Adam
    state (later rows follow parameters that are not compared: see the
    module docstring)."""
    c = case("H2O")
    cfg_j, params, model = _model(c, seed=6)
    tr = _trainer(clip=None)
    tr.model.load_state_dict(model.state_dict())
    batch = tr._basis_batch(c.h_t.basis)
    ms, _ = vmc_update_scan(tr.model, tr.optimizer, tr.scheduler, tr.dt, batch, 2, length=3)
    tc_j = trainer_j.TrainConfig(n_train=4, lr=1e-2, lr_final=3e-3)
    opt_j = tc_j.make_optimizer()
    basis = jnp.asarray(c.h_j.basis)
    bj = SampleBatchJ(states=basis, counts=jnp.ones((len(c.h_j.basis),), jnp.float64),
                      n_unique=jnp.int32(len(c.h_j.basis)), overflow=jnp.array(False))
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    _, _, ms_j = trainer_j.vmc_update_scan(cfg_j, opt_j, params, opt_j.init(params), dt_j, bj,
                                           jnp.int32(2), length=3)
    ms_j = np.asarray(ms_j)
    assert abs(ms[0, 0] - ms_j[0, 0]) < MEAN_TOL
    assert abs(ms[0, 1] - ms_j[0, 1]) < 1e-4 * max(1.0, ms_j[0, 1])


# -------------------------------------------------------------- run_exact

def test_run_exact_full_basis_windows_and_resume(monkeypatch, tmp_path):
    """run_exact over the full basis in windows of EXACT_FLUSH steps: the
    log's lengths, one readback a window, the save_freq rule of the JAX
    package ((n_steps % save_freq) < k after a window of k), and
    run_exact(3) then run_exact(4) ending where run_exact(7) ends."""
    monkeypatch.setattr(VMCTrainer, "EXACT_FLUSH", 2)
    reads, saved = [], []
    to_host = trainer_t._to_host
    monkeypatch.setattr(trainer_t, "_to_host", lambda t: reads.append(1) or to_host(t))
    a, b = _trainer(n_train=8), _trainer(n_train=8)
    a.save_loc = str(tmp_path)
    monkeypatch.setattr(a, "save", lambda: saved.append(a.n_steps))
    a.run_exact(7, output_freq=1, save_freq=3)
    assert len(reads) == 4 and saved == [4, 6]
    assert a.n_steps == 7 and a.run_time > 0
    for key in ("E_LOC", "E_LOC_VAR", "N_UNIQUE_SAMP", "TIME"):
        assert [s for s, _ in a.log[key]] == list(range(1, 8)), key
    assert all(v == len(a.hilbert.basis) for _, v in a.log["N_UNIQUE_SAMP"])
    assert np.isfinite([v for _, v in a.log["E_LOC"]]).all()
    reads.clear()
    b.run_exact(3, output_freq=100)
    b.run_exact(4, output_freq=100)
    assert len(reads) == 4 and b.n_steps == 7
    _assert_close(_state(a), _state(b), rtol=0)
    assert [v for _, v in a.log["E_LOC"]] == [v for _, v in b.log["E_LOC"]]


def test_run_exact_minibatches_are_jax_draws(monkeypatch):
    """Minibatch mode with exact local energies: the states of each step's
    batch are those JAX's run_exact draws for the same seed (its
    vmc_update spied on, nothing applied), and the port's steps read the
    sector table."""
    c = case("H2O")
    tc_kw = dict(n_train=4, exact_eloc=True, eloc_fwd_chunk=128, seed=7)
    cfg_j = nade_j.NAQSConfig(n_qubits=14, sectors=c.h_j.sectors, amp_hidden=(8,),
                              phase_hidden=(8,))
    tr_j = trainer_j.VMCTrainer(cfg_j, c.terms_j, c.h_j, trainer_j.TrainConfig(**tc_kw))
    drawn_j = []

    def spy_j(cfg, optimizer, params, opt_state, dt, batch, reweight_by_psi=False, table=None,
              fwd_chunk=65536):
        assert reweight_by_psi and table is not None
        drawn_j.append(np.asarray(batch.states).astype(np.int64))
        return params, opt_state, {"e_loc": jnp.float64(0.0), "e_loc_var": jnp.float64(0.0)}

    monkeypatch.setattr(trainer_j, "vmc_update", spy_j)
    tr_j.run_exact(3, batch_size=50, output_freq=100)
    tr = _trainer(clip=None, **{k: v for k, v in tc_kw.items() if k != "n_train"})
    assert tr._table[0].shape[0] == 512 and int(tr._table[1]) == 441
    drawn, update = [], trainer_t.vmc_update

    def spy(*args, **kw):
        drawn.append(args[4].states.numpy().copy())
        assert kw["table"] is tr._table and kw["fwd_chunk"] == 128
        return update(*args, **kw)

    monkeypatch.setattr(trainer_t, "vmc_update", spy)
    tr.run_exact(3, batch_size=50, output_freq=100)
    assert len(drawn) == len(drawn_j) == 3
    for got, want in zip(drawn, drawn_j):
        assert np.array_equal(got, want) and len(got) == 50
    assert [s for s, _ in tr.log["N_UNIQUE_SAMP"]] == [1, 2, 3]
    assert all(v == 50 for _, v in tr.log["N_UNIQUE_SAMP"])
    assert np.isfinite([v for _, v in tr.log["E_LOC"]]).all()


def test_h2_trains_to_chemical_accuracy_by_run_exact():
    """The counterpart of the JAX package's test_exact_sampling_training:
    300 full-basis steps of H2 at a constant LR of 5e-3."""
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                        phase_hidden=(16,), masking="full")
    tc = TrainConfig(n_train=300, use_lr_schedule=False, lr=5e-3, seed=3)
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu")
    tr.run_exact(300, output_freq=1000)
    e = tr.exact_energy()
    assert e - c.mol_t.fci_energy < CHEM_ACC, (e, c.mol_t.fci_energy)
    assert e > c.mol_t.fci_energy - 1e-6
    assert len(tr.log["E_LOC"]) == 300


def test_exact_eloc_trainer_steps(monkeypatch):
    """The sampled step with exact_eloc (step(), hence _update) and
    run_density both pass the sector table to every update; a sampled step's
    energy is finite."""
    tr = _trainer(clip=None, exact_eloc=True, eloc_fwd_chunk=64, n_samples=1e4,
                  n_unq_samples_min=8, n_unq_samples_max=256)
    seen, update = [], trainer_t.vmc_update

    def spy(*args, **kw):
        seen.append(kw["table"])
        return update(*args, **kw)

    monkeypatch.setattr(trainer_t, "vmc_update", spy)
    out = tr.step()
    tr.run_density(1, d_p=1e-3)
    # the step's update (and its retry after an overflow), run_density's
    assert len(seen) >= 2 and all(t is tr._table for t in seen)
    assert np.isfinite(out["e_loc"]) and np.isfinite(tr.log["E_LOC"][-1][1])


# -------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def h2_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("mol") / "H2.npz"
    save_molecule_npz(molecule_from_fields(fields("H2"), load_hamiltonian=False), str(path))
    return str(path)


def _log(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_cli_exact_sampling_and_resume(h2_npz, tmp_path, monkeypatch):
    """-exact_sampling with -ws_solve_h on H2 at -platform cpu: run_exact to
    the warm start, the warm start over the basis, run_exact for the rest;
    the summary's subspace energy is the warm start's (the basis ground
    state), its exact <psi|H|psi> at or above it; then -c resumes for the
    steps left."""
    monkeypatch.chdir(tmp_path)
    argv = ["-platform", "cpu", "-m", h2_npz, "-exact_sampling", "-n_hid", "8",
            "-ws_solve_h", "3", "-ws_epochs", "5", "-output_freq", "2", "-s", "4", "-o", "out"]
    res = cli_t.run(argv + ["-n_train", "5"])["run_0"]
    e0 = float(np.linalg.eigvalsh(nt.hamiltonian.assemble_sparse_hamiltonian_np(
        case("H2").terms_t, case("H2").h_t.basis).toarray())[0])
    assert res["e_vmc_fci_subspace"] == pytest.approx(e0, abs=1e-9)
    assert res["n_unique_final"] == 4 and res["vmc_estimator"] == "exact_psi_H_psi"
    assert res["e_exact_final"] > e0 - 1e-6
    lines = _log("out/log.jsonl")
    assert [x["step"] for x in lines if x["key"] == "E_LOC"] == [1, 2, 3, 4, 5]
    assert all(x["value"] == 4 for x in lines if x["key"] == "N_UNIQUE_SAMP")
    with open("out/summary.json") as f:
        assert json.load(f)["e_vmc_fci_subspace"] == res["e_vmc_fci_subspace"]
    res = cli_t.run(argv + ["-n_train", "7", "-c"])["run_0"]
    assert [x["step"] for x in _log("out/log.jsonl") if x["key"] == "E_LOC"] == \
        list(range(1, 8))
    assert res["e_vmc_fci_subspace"] == pytest.approx(e0, abs=1e-9)


def test_cli_exact_eloc(h2_npz, tmp_path, monkeypatch):
    """-exact_eloc on H2 at -platform cpu: the trainer carries the sector
    table, every step's energy is finite and the run writes its files."""
    monkeypatch.chdir(tmp_path)
    made = []
    init = VMCTrainer.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    monkeypatch.setattr(VMCTrainer, "__init__", spy)
    res = cli_t.run(["-platform", "cpu", "-m", h2_npz, "-exact_eloc", "-n_hid", "8",
                     "-n_train", "4", "-n_samps", "1e4", "-n_unq_samps_min", "2",
                     "-n_unq_samps_max", "16", "-s", "2", "-o", "out"])["run_0"]
    tr, = made
    assert tr.tc.exact_eloc and int(tr._table[1]) == 4
    assert np.isfinite(res["e_exact_final"]) and res["vmc_estimator"] == "exact_psi_H_psi"
    e_loc = [x["value"] for x in _log("out/log.jsonl") if x["key"] == "E_LOC"]
    assert len(e_loc) == 4 and np.isfinite(e_loc).all()
    for name in ("summary.json", "args.json", "checkpoint.pt"):
        assert os.path.exists(os.path.join("out", name)), name
