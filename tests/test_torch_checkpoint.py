"""Checkpoints: the port's own round trip, a JAX checkpoint read by the port
(utils/checkpoint.py decodes flax's msgpack with no msgpack package), and
the port's counter, log and json read by the JAX trainer.

Tolerances: a round trip restores every tensor, the counter, the log and
the controller bitwise, and the next step on the CPU is bitwise equal. A JAX
checkpoint's parameters, Adam moments, counts and clip ring arrive bitwise;
the next update on the same batch is held to JAX's next update as
tests/test_torch_trainer.py holds one update: E_loc 5e-6 Ha, the gradient
norm rtol 1e-4, and the parameters after it atol 1e-6 (Adam's step is lr
m_hat / (sqrt(v_hat) + eps) with moments carried over, so gradients that
agree to ~1e-6 give steps that agree to ~lr x 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu import trainer as trainer_j
from naqs_tpu.sampler import SampleBatch as SampleBatchJ
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.sampler import SampleBatch
from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer, vmc_update
from naqs_tpu_torch.utils.checkpoint import jax_params, optax_parts, read_flax_msgpack
from test_torch_support import case, near_hf_states, padded_batch, to_u64

TC = dict(n_train=10, lr=3e-3, lr_final=1e-3, n_samples=1e4, n_unq_samples_min=8,
          n_unq_samples_max=256, grad_clip_factor=2.0, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the model of the LUT cases: tables for the first two shells, with per-shell
# phase nets and so per-shell phase tables too
LUT = dict(num_lut=2, aggregate_phase=True)


def _cfgs(c, model=None):
    kw = dict(amp_hidden=(16,), phase_hidden=(16,), **(model or {}))
    n = c.mol_t.n_qubits
    return (nt.NAQSConfig(n_qubits=n, sectors=c.h_t.sectors, **kw),
            nq.NAQSConfig(n_qubits=n, sectors=c.h_j.sectors, **kw))


def _port(c, save_loc, model=None, **tc):
    return VMCTrainer(_cfgs(c, model)[0], c.terms_t, c.h_t, TrainConfig(**dict(TC, **tc)),
                      device="cpu", save_loc=str(save_loc))


def _jax(c, save_loc, model=None, **tc):
    return trainer_j.VMCTrainer(_cfgs(c, model)[1], c.terms_j, c.h_j,
                                trainer_j.TrainConfig(**dict(TC, **tc)), save_loc=str(save_loc))


def _batches(c, seed):
    rng = np.random.default_rng(seed)
    s, _, _, counts = padded_batch(near_hf_states(c, 100, rng), 128, rng)
    return (SampleBatchJ(states=jnp.asarray(to_u64(s)), counts=jnp.asarray(counts),
                         n_unique=jnp.int32(100), overflow=jnp.array(False)),
            SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                        n_unique=torch.tensor(100), overflow=torch.tensor(False)))


# ------------------------------------------------------------ the msgpack reader

def test_reader_decodes_what_flax_writes(monkeypatch):
    from flax import serialization

    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32, -33,
                     -128, -129, -32768, -40000, -2**40],
            "floats": [0.5, -1e300, 3.25], "flags": [True, False, None],
            "strings": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
            "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "f64": np.array([1.5, -2.0]), "i32": np.array(-7, dtype=np.int32),
                       "u64": np.array([2**63 + 5], dtype=np.uint64),
                       "bool": np.array([True, False]), "empty": np.zeros((0, 3)),
                       "big": np.arange(70000, dtype=np.int64)},
            "scalars": [np.float32(2.5), np.int64(-3)],
            "nested": {"list": [{"x": np.ones(2)}, [1, [2, [3]]]], "n" * 20: {}}}
    # chunk arrays over 64 bytes, as flax does past 2^30
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    got, want = read_flax_msgpack(blob), serialization.msgpack_restore(blob)

    def same(a, b):
        assert type(a) is type(b) or (isinstance(a, np.generic) and isinstance(b, np.generic))
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    same(got, want)
    with pytest.raises(ValueError):
        read_flax_msgpack(blob + b"\x00")


# ------------------------------------------------------------ the port's round trip

def test_round_trip_is_bit_faithful(tmp_path):
    c = case("H2O")
    tr = _port(c, tmp_path)
    for _ in range(6):
        tr.step()
    tr.ws_result = (-75.0, 441)
    assert tr.sampled_counter and int(tr.clip.count) >= 5
    tr.save()
    back = _port(c, tmp_path, seed=11).load()

    for (k, a), (_, b) in zip(tr.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = tr.optimizer.state_dict(), back.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert tr.scheduler.state_dict() == back.scheduler.state_dict()
    assert torch.equal(tr.clip.norms, back.clip.norms) and torch.equal(tr.clip.count,
                                                                       back.clip.count)
    assert torch.equal(tr.gen.get_state(), back.gen.get_state())
    assert back.sampled_counter == tr.sampled_counter
    assert back.log == tr.log
    assert (back.n_steps, back.n_samples, back.run_time, back.d_p, back.ws_result) == \
        (tr.n_steps, tr.n_samples, tr.run_time, tr.d_p, tr.ws_result)
    a, b = tr.step(), back.step()
    assert (a["e_loc"], a["e_loc_var"], a["n_unique"], a["grad_norm"]) == \
        (b["e_loc"], b["e_loc_var"], b["n_unique"], b["grad_norm"])
    for (k, x), (_, y) in zip(tr.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(x, y), k


def test_round_trip_params_only_starts_fresh_optimizer_state(tmp_path):
    c = case("H2O")
    tr = _port(c, tmp_path)
    for _ in range(2):
        tr.step()
    tr.save("ck")
    back = _port(c, tmp_path, seed=11).load("ck", params_only=True)
    for (k, a), (_, b) in zip(tr.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert not back.optimizer.state and int(back.clip.count) == 0
    assert back.n_steps == 0 and back.sampled_counter == {}


def test_run_saves_every_save_freq_steps(tmp_path):
    c = case("H2O")
    tr = _port(c, tmp_path)
    tr.run(4, output_freq=100, save_freq=2)
    back = _port(c, tmp_path).load()
    assert back.n_steps == 4 and len(back.log["E_LOC"]) == 4


# ------------------------------------------------------------ across the packages

def _jax_checkpoint(c, tmp_path, model=None, **tc):
    """A JAX trainer after 3 clipped updates on fixed batches, with a counter,
    saved to tmp_path; returns it."""
    tr_j = _jax(c, tmp_path, model, **tc)
    for seed in range(3):
        bj, _ = _batches(c, seed)
        tr_j.params, tr_j.opt_state, _ = trainer_j.vmc_update(
            tr_j.cfg, tr_j.optimizer, tr_j.params, tr_j.opt_state, tr_j.dt, bj, False)
    states = np.sort(np.random.default_rng(0).choice(c.h_t.basis, 30, replace=False))
    tr_j._record_arrays(to_u64(states), np.arange(30.0) + 0.5)
    tr_j.n_steps, tr_j.n_samples, tr_j.ws_result = 3, 1e5, (-74.9, 30)
    tr_j.log["E_LOC"] = [(1, -74.0), (2, -74.5), (3, -74.7)]
    tr_j.save()
    return tr_j


@pytest.mark.parametrize("schedule", [True, False])
def test_jax_checkpoint_loads_into_the_port(tmp_path, schedule):
    _check_jax_checkpoint_loads(tmp_path, schedule, None)


@pytest.mark.parametrize("schedule", [True, False])
def test_jax_checkpoint_with_lut_groups_loads_into_the_port(tmp_path, schedule):
    """optax.multi_transform's two Adams (the MLP group on the schedule, the
    LUT tables at lr_lut) arrive in the port's two parameter groups."""
    tr_t = _check_jax_checkpoint_loads(tmp_path, schedule, LUT)
    assert len(tr_t.optimizer.param_groups) == 2
    assert [g["lr"] for g in tr_t.optimizer.param_groups][1] == TrainConfig().lr_lut


def _check_jax_checkpoint_loads(tmp_path, schedule, model):
    c = case("H2O")
    tr_j = _jax_checkpoint(c, tmp_path, model, use_lr_schedule=schedule)
    tr_t = _port(c, tmp_path, model, use_lr_schedule=schedule).load()

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tr_j.params))
    named = dict(tr_t.model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        assert torch.equal(p.detach(), want[k]), k
    parts = optax_parts(jax.tree_util.tree_map(np.asarray, _state_dict(tr_j.opt_state)))
    assert ("adam_lut" in parts) == bool(model)
    for adam in [parts[k] for k in ("adam", "adam_lut") if k in parts]:
        mu = params_from_jax(jax_params(adam["mu"]))
        nu = params_from_jax(jax_params(adam["nu"]))
        assert mu and set(mu) == set(nu)
        for k in mu:
            st = tr_t.optimizer.state[named[k]]
            assert torch.equal(st["exp_avg"], mu[k]) and torch.equal(st["exp_avg_sq"], nu[k]), k
            assert float(st["step"]) == int(adam["count"]) == 3
    assert torch.equal(tr_t.clip.norms, torch.as_tensor(np.array(parts["clip"]["norms"])))
    assert int(tr_t.clip.count) == 3 and tr_t.scheduler.last_epoch == 3
    assert tr_t.sampled_counter == tr_j.sampled_counter
    assert (tr_t.n_steps, tr_t.n_samples, tr_t.ws_result) == (3, 1e5, (-74.9, 30))
    assert tr_t.log["E_LOC"] == [(1, -74.0), (2, -74.5), (3, -74.7)]

    # the next update on the same batch
    bj, bt = _batches(c, 7)
    p_j, _, m_j = trainer_j.vmc_update(tr_j.cfg, tr_j.optimizer, tr_j.params, tr_j.opt_state,
                                       tr_j.dt, bj, False)
    m_t = vmc_update(tr_t.model, tr_t.optimizer, tr_t.scheduler, tr_t.dt, bt, clip=tr_t.clip)
    assert m_t["applied"] and abs(m_t["e_loc"] - float(m_j["e_loc"])) < 5e-6
    np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    for k, p in tr_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    return tr_t


def test_round_trip_with_lut_groups(tmp_path):
    """Both parameter groups, their Adam state and LRs, bitwise."""
    c = case("H2O")
    tr = _port(c, tmp_path, LUT, n_train=4)
    for _ in range(3):
        tr.step()
    tr.save()
    back = _port(c, tmp_path, LUT, n_train=4, seed=11).load()
    sa, sb = tr.optimizer.state_dict(), back.optimizer.state_dict()
    assert len(sa["param_groups"]) == 2 and sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    for (k, a), (_, b) in zip(tr.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(a, b), k
    a, b = tr.step(), back.step()
    assert (a["e_loc"], a["grad_norm"]) == (b["e_loc"], b["grad_norm"])


def test_jax_checkpoint_params_only(tmp_path):
    c = case("H2O")
    tr_j = _jax_checkpoint(c, tmp_path)
    # a trainer with another chain (no clip, no schedule) takes the parameters
    tr_t = _port(c, tmp_path, grad_clip_factor=None, use_lr_schedule=False)
    tr_t.load(params_only=True)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tr_j.params))
    for k, p in tr_t.model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    assert not tr_t.optimizer.state and tr_t.n_steps == 0 and tr_t.sampled_counter == {}
    with pytest.raises(ValueError):
        _port(c, tmp_path, grad_clip_factor=None).load()


def test_jax_reads_the_port_counter_log_and_json(tmp_path):
    c = case("H2O")
    _jax_checkpoint(c, tmp_path)  # its .msgpack stays: the port writes .pt
    tr_t = _port(c, tmp_path)
    for _ in range(6):
        tr_t.step()
    tr_t.ws_result, tr_t.d_p = (-75.1, 400), 1e-6
    tr_t.save()
    tr_j = _jax(c, tmp_path).load()
    assert tr_j.sampled_counter == tr_t.sampled_counter
    assert (tr_j.n_steps, tr_j.n_samples, tr_j.run_time, tr_j.d_p, tr_j.ws_result) == \
        (tr_t.n_steps, tr_t.n_samples, tr_t.run_time, tr_t.d_p, tr_t.ws_result)
    assert tr_j.log == tr_t.log


def _state_dict(opt_state):
    from flax import serialization

    return serialization.to_state_dict(opt_state)
