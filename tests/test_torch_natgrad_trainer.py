"""The natural-gradient paths of the port's trainer, checkpoints and CLI
against naqs_tpu on the CPU: `_current_lr`, the options' refusals, a
`step()` of SR (also with exact local energies) and of K-FAC against the JAX
package's update on the full-capacity batch (the port's model passes run
over the live rows only), a K-FAC run saved and resumed against one run
straight through, a JAX checkpoint with its `_kfac.msgpack`, and
`python -m naqs_tpu_torch.cli -sr` / `-kfac` on H2.

Tolerances as in test_torch_natgrad.py: SR updates on float32 parameters at
cg_iters 3, damping 1e-2 within 2e-3 of the update's norm, K-FAC's
parameters rtol 1e-4 / atol 1e-6 and its factors rtol 1e-5 / atol 1e-7,
energies 5e-6 Ha. A resumed run equals the uninterrupted one bit for bit
(same process, same generator states).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu import kfac as kfac_j
from naqs_tpu import sr as sr_j
from naqs_tpu import trainer as trainer_j
from naqs_tpu_torch import cli as cli_t
from naqs_tpu_torch import kfac as kfac_t
from naqs_tpu_torch import trainer as trainer_t
from naqs_tpu_torch.models.convert import kfac_state_from_jax
from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer, sector_table
from naqs_tpu_torch.utils.molecule import molecule_from_fields, save_molecule_npz
from test_torch_natgrad import MEAN_TOL, _batches, _model, _terms, _tree, _update_error
from test_torch_support import case, fields


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("schedule,n_train", [(True, 10), (True, 1), (False, 10)])
def test_current_lr_matches_jax(schedule, n_train):
    """The natural-gradient LR keyed on the steps taken, against the JAX
    trainer's _current_lr at every step across the switch."""
    kw = dict(n_train=n_train, lr=1e-2, lr_final=3e-3, use_lr_schedule=schedule)
    tc_t, tc_j = TrainConfig(**kw), trainer_j.TrainConfig(**kw)
    for n in range(12):
        assert (VMCTrainer._current_lr(SimpleNamespace(tc=tc_t, n_steps=n))
                == trainer_j.VMCTrainer._current_lr(SimpleNamespace(tc=tc_j, n_steps=n)))


def test_kfac_with_exact_eloc_raises():
    """exact_eloc runs with Adam and with SR; K-FAC has no table= path, as in
    the JAX package."""
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=4, sectors=c.h_t.sectors, amp_hidden=(8,), phase_hidden=(8,))
    with pytest.raises(ValueError, match="exact_eloc"):
        VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(use_kfac=True, exact_eloc=True),
                   device="cpu")
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(use_sr=True, exact_eloc=True),
                    device="cpu")
    assert tr._table is not None


def _trainer_with(c, model, **tc):
    """A CPU trainer on case c whose model holds `model`'s weights."""
    tr = VMCTrainer(model.cfg, c.terms_t, c.h_t, TrainConfig(**tc), device="cpu")
    tr.model.load_state_dict(model.state_dict())
    return tr


@pytest.mark.parametrize("path", ["sr", "sr_exact_eloc", "kfac"])
def test_step_matches_the_jax_update_on_the_full_batch(path, monkeypatch):
    """One trainer step on a fixed sampled-style batch of H2O STO-3G (120 of
    128 rows live): the port's update sees the first 120 rows only, JAX's the
    whole capacity; the parameters, energy and the step's outputs agree.
    sr_exact_eloc reads the trainer's sector table (eloc_fwd_chunk 100) on
    both sides."""
    c = case("H2O")
    dt_t, dt_j = _terms(c, "grid")
    cfg_j, params, model = _model(c, seed=11)
    bj, bt = _batches(c, 120, 128, seed=12)
    kw = dict(use_kfac=True) if path == "kfac" else dict(
        use_sr=True, sr_cg_iters=3, sr_damping=1e-2, exact_eloc=path == "sr_exact_eloc",
        eloc_fwd_chunk=100)
    tr = _trainer_with(c, model, lr=5e-2, **kw)
    monkeypatch.setattr(tr, "_get_samples", lambda: (bt, 120))
    seen = []
    update = trainer_t.kfac_update if path == "kfac" else trainer_t.sr_update

    def spy(*args, **kwargs):
        seen.append(args[3 if path == "kfac" else 2].states.shape[0])
        return update(*args, **kwargs)

    monkeypatch.setattr(trainer_t, "kfac_update" if path == "kfac" else "sr_update", spy)
    out = tr.step()
    assert seen == [120] and out["n_unique"] == 120 and tr.n_steps == 1
    if path == "kfac":
        new_j, ks_j, m_j = kfac_j.kfac_update(cfg_j, params, kfac_j.kfac_init(params), dt_j, bj,
                                              jnp.float32(5e-2), jnp.float32(1e-2),
                                              jnp.float32(0.95), jnp.float32(1e-3))
        want = _tree(new_j)
        for k, p in tr.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out["nu"], float(m_j["nu"]), rtol=1e-4)
        assert int(tr.kfac_state["step"]) == 1
    else:
        table = None
        if path == "sr_exact_eloc":
            buf = np.full(tr._table[0].shape[0], np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
            buf[:len(c.h_j.basis)] = c.h_j.basis
            table = (jnp.asarray(buf), jnp.int32(len(c.h_j.basis)))
        new_j, m_j = sr_j.sr_update(cfg_j, params, dt_j, bj, jnp.float64(5e-2),
                                    jnp.float64(1e-2), cg_iters=3, table=table, fwd_chunk=100)
        assert _update_error(tr.model, new_j, params) < 2e-3
        np.testing.assert_allclose(out["grad_norm"], float(m_j["grad_norm"]), rtol=1e-5)
        assert out["cg_iters"] == 3
    assert abs(out["e_loc"] - float(m_j["e_loc"])) < MEAN_TOL
    assert tr.log["E_LOC"] == [(1, out["e_loc"])]


def _h2o_kfac_trainer(save_loc=None):
    c = case("H2O")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                        phase_hidden=(16,))
    tc = TrainConfig(use_kfac=True, n_train=6, lr=5e-2, lr_final=1e-2, n_samples=1e4,
                     n_unq_samples_min=8, n_unq_samples_max=256, seed=5)
    return VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu", save_loc=save_loc)


def test_kfac_run_saved_and_resumed_equals_one_run(tmp_path):
    """4 K-FAC steps straight through against 2 steps, save, a fresh trainer's
    load and 2 more (the LR switches at step 3): parameters, the running
    factors and their step, the logged energies, all bitwise."""
    a = _h2o_kfac_trainer()
    a.run(4, output_freq=100)
    b = _h2o_kfac_trainer(str(tmp_path))
    b.run(2, output_freq=100)
    b.save()
    c = _h2o_kfac_trainer(str(tmp_path)).load()
    assert int(c.kfac_state["step"]) == 2 and c.n_steps == 2
    c.run(2, output_freq=100)
    for (k, p), (_, q) in zip(a.model.named_parameters(), c.model.named_parameters()):
        assert torch.equal(p, q), k
    assert int(a.kfac_state["step"]) == int(c.kfac_state["step"]) == 4
    for name in ("amp", "phase"):
        for fa, fc in zip(a.kfac_state[name], c.kfac_state[name]):
            assert torch.equal(fa["A"], fc["A"]) and torch.equal(fa["G"], fc["G"])
    assert a.log["E_LOC"] == c.log["E_LOC"]


def test_jax_checkpoint_with_kfac_state_loads(tmp_path):
    """A JAX K-FAC trainer's checkpoint after 2 steps (checkpoint.msgpack and
    checkpoint_kfac.msgpack): the port's load restores the parameters and
    every running factor exactly, and the next kfac_update on one batch
    matches JAX's from its own state."""
    c = case("H2O")
    kw = dict(amp_hidden=(16,), phase_hidden=(16,))
    cfg_j = trainer_j.NAQSConfig(n_qubits=c.mol_j.n_qubits, sectors=c.h_j.sectors, **kw)
    tc = dict(use_kfac=True, n_train=6, lr=5e-2, n_samples=1e4, n_unq_samples_min=8,
              n_unq_samples_max=256, seed=5)
    tr_j = trainer_j.VMCTrainer(cfg_j, c.terms_j, c.h_j, trainer_j.TrainConfig(**tc),
                                save_loc=str(tmp_path))
    tr_j.step()
    tr_j.step()
    tr_j.save()
    assert os.path.exists(tmp_path / "checkpoint_kfac.msgpack")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, **kw)
    tr = VMCTrainer(cfg, c.terms_t, c.h_t, TrainConfig(**tc), device="cpu",
                    save_loc=str(tmp_path)).load()
    want = _tree(tr_j.params)
    for k, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    ks = kfac_state_from_jax(jax.tree_util.tree_map(np.asarray, tr_j.kfac_state))
    assert int(tr.kfac_state["step"]) == 2 and tr.kfac_state["step"].dtype == torch.int32
    for name in ("amp", "phase"):
        for got, exp in zip(tr.kfac_state[name], ks[name]):
            assert torch.equal(got["A"], exp["A"]) and torch.equal(got["G"], exp["G"])
    assert tr.n_steps == 2
    bj, bt = _batches(c, 120, 128, seed=13)
    dt_t, dt_j = _terms(c, "grid")
    new_j, ks_j, _ = kfac_j.kfac_update(cfg_j, tr_j.params, tr_j.kfac_state, dt_j, bj,
                                        jnp.float32(5e-2), jnp.float32(1e-2),
                                        jnp.float32(0.95), jnp.float32(1e-3))
    ks_t, _ = kfac_t.kfac_update(tr.model, tr.kfac_state, dt_t, bt, 5e-2)
    want = _tree(new_j)
    for k, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert int(ks_t["step"]) == int(ks_j["step"]) == 3


@pytest.fixture(scope="module")
def h2_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("mol") / "H2.npz"
    save_molecule_npz(molecule_from_fields(fields("H2"), load_hamiltonian=False), str(path))
    return str(path)


@pytest.mark.parametrize("flag", ["-sr", "-kfac"])
def test_cli_trains_h2_with_a_natural_gradient(flag, h2_npz, tmp_path, monkeypatch):
    """`python -m naqs_tpu_torch.cli -sr` (with -sr_kl_clip) and `-kfac` on H2
    at -platform cpu: 5 steps with finite energies in log.jsonl, then -c
    resumes from checkpoint.pt for 2 more; the K-FAC run's running factors
    come back with it (their step counts all 7 updates)."""
    monkeypatch.chdir(tmp_path)
    argv = ["-platform", "cpu", "-m", h2_npz, flag, "-n_hid", "8", "-n_samps", "1e4",
            "-n_unq_samps_min", "2", "-n_unq_samps_max", "16", "-output_freq", "5", "-s", "3",
            "-o", "out", "-lr", "5e-2"]
    if flag == "-sr":
        argv += ["-sr_kl_clip", "1e-2", "-sr_cg_iters", "10", "-sr_damping", "1e-2"]
    res = cli_t.run(argv + ["-n_train", "5"])
    assert np.isfinite(res["run_0"]["e_exact_final"])
    res = cli_t.run(argv + ["-n_train", "7", "-c"])
    lines = [json.loads(x) for x in open("out/log.jsonl")]
    e_loc = [x for x in lines if x["key"] == "E_LOC"]
    assert [x["step"] for x in e_loc] == list(range(1, 8))
    assert np.isfinite([x["value"] for x in e_loc]).all()
    ckpt = torch.load("out/checkpoint.pt", map_location="cpu")
    if flag == "-kfac":
        assert int(ckpt["kfac"]["step"]) == 7
    else:
        assert ckpt["kfac"] is None
