"""The port's data-parallel Adam step against naqs_tpu's
`make_sharded_train_step`, two ranks on the CPU (gloo).

The JAX step runs here on 2 of the 8 virtual CPU devices; its ranks' batches
are what JAX's `sample` makes from `jax.random.split(k, 2)` (the merged record
of the JAX step is checked to be those batches, so the sampler inside
`shard_map` reproduces outside it). The port's two ranks
(`tests/test_torch_parallel_ranks.py`, started by `parallel.launch.spawn` on a
`file://` store under tmp_path, joined with a timeout) get those batches and
the same parameters (`params_from_jax`), and run `step.sharded_adam_update`.
LiH STO-3G (DenseTerms, whose mask loop JAX splits over the mesh and each
port rank runs whole), amp and phase nets of 16, capacity 128 a rank, 500
samples: about 34 unique states a rank (the partially masked frontier
of 1,000 would overflow 128 rows), some of them drawn on both.

Cases: plain Adam; the gradient clip on the summed gradient (the ring
preloaded so that it bites), followed by a step in which one rank's batch
overflowed; |psi|^2 weights divided by the global multiplicity
(reweight_by_psi); exact local energies against the sector table, whose
forward each rank runs over its half in chunks of 64 rows.

Tolerances: e_loc 5e-6 Ha, e_loc_var 1e-4 relative, the summed gradients
rtol 1e-4 / atol 1e-6 (as the single-device tests); n_unique, overflow and
the merged record exactly. Parameters: with eps = 1e-15 a first Adam step is
~lr * sign(g), so where |g| is within the gradients' tolerance of 0 the
packages may step opposite ways; there each update is at most lr, and
elsewhere the parameters agree to rtol 1e-5 / atol 1e-7 (Adam on the same
gradients). The clip ring rtol 1e-4. Both ranks' parameters and Adam state
bitwise equal; after the overflowed step, bitwise what they were before it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from naqs_tpu import trainer as trainer_j
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops.local_energy import DeviceTerms as DeviceTermsJ
from naqs_tpu.parallel import make_mesh, make_sharded_train_step
from naqs_tpu.sampler import sample as sample_j
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.parallel.launch import spawn
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case

import test_torch_parallel_ranks as ranks

D = 2
CAP = 128                 # rows a rank
N_SAMPLES = 500.0
LR = 1e-2
CHUNK = 64                # the exact case's table forward: 4 chunks a rank
MEAN_TOL = 5e-6
TIMEOUT = 180
CASES = ["plain", "clip", "reweight", "exact_eloc"]


def port_batch(b):
    """A JAX SampleBatch as the port's numpy (states, counts, n_unique,
    overflow): uint64 states to int64, all-ones padding to SENTINEL."""
    s = np.asarray(b.states)
    states = s.astype(np.int64)
    states[s == np.uint64(0xFFFFFFFFFFFFFFFF)] = SENTINEL
    return states, np.asarray(b.counts), int(b.n_unique), bool(b.overflow)


def grab():
    """An optax transform that applies nothing and keeps the gradients as its
    state (so the JAX step hands back its summed gradients)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def tree(params) -> dict:
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def setup():
    c = case("LiH")
    cfg_kw = dict(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                  phase_hidden=(16,))
    cfg_j = nade_j.NAQSConfig(**cfg_kw)
    params = nade_j.init_params(jax.random.key(0), cfg_j)
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j)
    assert type(dt_j.dense).__name__ == "DenseTerms"
    return c, cfg_kw, cfg_j, params, dt_j, make_mesh(jax.devices()[:D])


def _jax_table(c):
    """The sector table the JAX trainer builds for 2 devices (chunk x 2 padding)."""
    n = len(c.h_j.basis)
    unit = CHUNK * D
    buf = np.full(-(-n // unit) * unit, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    buf[:n] = c.h_j.basis
    return buf, n


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every case through JAX here and through the port's two ranks."""
    c, cfg_kw, cfg_j, params, dt_j, mesh = setup
    keys = jax.random.split(jax.random.key(5), D)
    batches = [port_batch(sample_j(cfg_j, params, keys[i], jnp.float64(N_SAMPLES) / D, CAP))
               for i in range(D)]
    # the overflow step: rank 0's batch fits, rank 1's (10^6 samples) overflowed
    k2 = jax.random.split(jax.random.key(6), D)
    over = [port_batch(sample_j(cfg_j, params, k2[0], jnp.float64(N_SAMPLES) / D, CAP)),
            port_batch(sample_j(cfg_j, params, k2[1], jnp.float64(1e6), CAP))]
    assert not over[0][3] and over[1][3]
    want, port_cases, summed = {}, [], {}
    for name in CASES:
        kw = dict(reweight_by_psi=name == "reweight")
        if name == "exact_eloc":
            kw.update(table=_jax_table(c), fwd_chunk=CHUNK)
        if name != "clip":   # the clip case's gradients are the plain case's
            g_step = make_sharded_train_step(cfg_j, grab(), mesh, CAP, **kw)
            summed[name] = g_step(params, grab().init(params), dt_j, keys,
                                  jnp.float64(N_SAMPLES))[1]
        grads = summed["plain" if name == "clip" else name]
        tc = dict(lr=LR, use_lr_schedule=False)
        ring = None
        if name == "clip":
            tc["grad_clip_factor"] = 0.5
            ring = np.zeros(50, np.float32)
            ring[:5] = 0.3 * float(optax.global_norm(grads))
        opt = trainer_j.TrainConfig(**tc).make_optimizer()
        state = opt.init(params)
        if ring is not None:
            state = (dict(norms=jnp.asarray(ring), count=jnp.int32(5)), *state[1:])
        step = make_sharded_train_step(cfg_j, opt, mesh, CAP, **kw)
        new, new_state, m = step(params, state, dt_j, keys, jnp.float64(N_SAMPLES))
        want[name] = dict(grads=tree(grads), params=tree(new), metrics=m,
                          ring=new_state[0] if ring is not None else None)
        steps = [batches] + ([over] if name == "clip" else [])
        port_cases.append(dict(tc=tc, ring=None if ring is None else
                               {"norms": ring, "count": 5},
                               reweight=name == "reweight", exact=name == "exact_eloc",
                               chunk=CHUNK, steps=steps))
    got = spawn(ranks.sharded_adam, D, (cfg_kw, tree(params), c.h_t, c.terms_t, port_cases),
                workdir=str(tmp_path_factory.mktemp("adam")), timeout=TIMEOUT)
    return batches, tree(params), want, {name: [got[r][i] for r in range(D)]
                                          for i, name in enumerate(CASES)}


def test_jax_step_samples_what_its_sampler_gives_outside_shard_map(runs):
    batches, _, want, _ = runs
    merged = np.sort(np.concatenate([b[0] for b in batches]), kind="stable")
    rec = np.asarray(want["plain"]["metrics"]["rec_states"]).astype(np.int64)
    rec[rec == -1] = SENTINEL
    np.testing.assert_array_equal(rec, merged)
    shared = len(np.intersect1d(batches[0][0][:batches[0][2]], batches[1][0][:batches[1][2]]))
    assert shared > 5 and not any(b[3] for b in batches)


@pytest.mark.parametrize("name", CASES)
def test_sharded_adam_step_matches_jax(runs, name):
    _, old, want, got = runs
    w = want[name]
    for r in range(D):
        s = got[name][r][0]
        m = s["metrics"]
        assert abs(float(m["e_loc"]) - float(w["metrics"]["e_loc"])) < MEAN_TOL
        np.testing.assert_allclose(float(m["e_loc_var"]), float(w["metrics"]["e_loc_var"]),
                                   rtol=1e-4)
        assert int(m["n_unique"]) == int(w["metrics"]["n_unique"])
        assert bool(m["overflow"]) is bool(w["metrics"]["overflow"]) is False
        rec = np.asarray(w["metrics"]["rec_states"]).astype(np.int64)
        rec[rec == -1] = SENTINEL
        np.testing.assert_array_equal(m["rec_states"], rec)
        np.testing.assert_array_equal(m["rec_counts"], np.asarray(w["metrics"]["rec_counts"]))
        assert int(m["rec_n_valid"]) == int(w["metrics"]["rec_n_valid"])
        for k, g in s["grads"].items():
            np.testing.assert_allclose(g, w["grads"][k], rtol=1e-4, atol=1e-6, err_msg=k)
        for k, p in s["params"].items():
            sure = np.abs(w["grads"][k]) > 1e-5
            np.testing.assert_allclose(p[sure], w["params"][k][sure], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
            assert (np.abs(p - old[k]) <= LR * (1 + 1e-5)).all()
            assert (np.abs(w["params"][k] - old[k]) <= LR * (1 + 1e-5)).all()
        assert s["sched"] == 1
    a, b = got[name][0][0], got[name][1][0]
    for k in a["params"]:
        assert a["params"][k].tobytes() == b["params"][k].tobytes(), k
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a["adam"][k], b["adam"][k]))
    if w["ring"] is not None:
        np.testing.assert_allclose(a["ring"][0], np.asarray(w["ring"]["norms"]), rtol=1e-4)
        assert a["ring"][1] == int(w["ring"]["count"]) == 6
        assert a["ring"][0].tobytes() == b["ring"][0].tobytes()


def test_overflow_on_one_rank_withholds_the_update_on_both(runs):
    """The clip case's second step: rank 1's batch overflowed, so neither
    rank changes its parameters, Adam moments and counts, clip ring or LR
    position (as the JAX step's `_keep_unless(overflow, ...)`)."""
    _, _, _, got = runs
    for r in range(D):
        before, after = got["clip"][r]
        assert bool(after["metrics"]["overflow"])
        for k in before["params"]:
            assert before["params"][k].tobytes() == after["params"][k].tobytes(), k
            assert all(x.tobytes() == y.tobytes()
                       for x, y in zip(before["adam"][k], after["adam"][k])), k
        assert before["ring"][0].tobytes() == after["ring"][0].tobytes()
        assert before["ring"][1] == after["ring"][1]
        assert before["sched"] == after["sched"] == 1
