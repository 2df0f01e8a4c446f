"""The rank engine with a dense A: one launch, held against JAX's chunk loop.

Where the terms carry a dense coupling matrix A (at most 2^26 entries) and
the space has a RankSpec, JAX's rank engine runs chunk by chunk: the H row as
P @ A, then the lookup and the ratio row sum (`_local_energy_chunk`), or the
gather and the symmetric epilogue (`_quadratic_energy_chunk`). The port's
`local_energy` is one `rank_local_energy` launch and its `quadratic_energy`
one `rank_quadratic_energy` launch, with or without A: they sum H term by
term for the found pairs and never read A, and the chunk kernels
`rank_ratio_rowsum` and `rank_gather2` run on no path. On the CPU each
wrapper takes its plain version.

Tolerances, per live row: `rank_local_energy_tolerance`
(`dyn_gather.local_energy_rows_tolerance`: the fp32 row sum's order, the H
entries' order, the f64 diagonal's order); on the quotient of
`quadratic_energy` and `exact_energy()`: (sum_m tol_num_m + |E| sum_m
tol_w_m) / sum_m w_m from `rank_quadratic_energy_tolerance`
(`quadratic_rows_tolerance`). The results with A and with `a_mat=None` are
bitwise equal: the same call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu import trainer as trainer_j
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.models.nade import log_psi
from naqs_tpu_torch.ops import dyn_gather as dg
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops.rank import build_value_table
from naqs_tpu_torch.trainer import VMCTrainer
from test_torch_support import case, near_hf_states, padded_batch, to_u64

CASES = [("H2O", 150, 160), ("LiH", 60, 64), ("H2O_6-31G", 64, 80)]
WRAPPERS = ("rank_local_energy", "rank_quadratic_energy", "sorted_local_energy",
            "sorted_quadratic_energy", "rank_ratio_rowsum", "rank_gather2")


def _terms(c):
    """(JAX, port) rank engines with their dense A and no grid program."""
    dt_j = dataclasses.replace(le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j),
                               dense=None)
    dt_t = dataclasses.replace(le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t,
                                                           device="cpu"), dense=None)
    assert dt_j.a_mat is not None and dt_t.a_mat is not None
    assert dt_j.rank_spec is not None and dt_t.rank_spec is not None
    return dt_j, dt_t


def _batch(c, m, cap, seed):
    rng = np.random.default_rng(seed)
    s, la, ph, counts = padded_batch(near_hf_states(c, m, rng), cap, rng)
    return s, la, ph, counts / counts.sum()


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _spies(monkeypatch):
    """Count every call of the kernel wrappers, both where the engine holds
    them (ops/local_energy.py) and in their own module (ops/dyn_gather.py)."""
    calls = {}
    for mod in (le_t, dg):
        for name in WRAPPERS:
            if not hasattr(mod, name):
                continue
            real = getattr(mod, name)

            def spy(*args, _real=real, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*args, **kw)

            monkeypatch.setattr(mod, name, spy)
    return calls


def _quotient_bound(spec, dt_t, states, la, ph, m):
    """The bound on |quadratic_energy - JAX's| of the header, and the
    quotient of the plain version's rows."""
    live = torch.arange(states.shape[0]) < m
    la_q = torch.where(live, la - la[:m].max(), dg.QUAD_MISS).float()
    ph = ph.float()
    nv = torch.tensor(m)
    table = build_value_table(spec, states, la_q, ph, m, miss_log_amp=dg.QUAD_MISS)
    terms = (dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.yz_unique, dt_t.term_coeff)
    num, w = dg.rank_quadratic_energy_ref(spec, table, nv, states, la_q, ph, *terms,
                                          dt_t.diag_yz, dt_t.diag_coeff)
    tol_num, tol_w = dg.rank_quadratic_energy_tolerance(spec, table, nv, states, la_q,
                                                        *terms, dt_t.diag_coeff)
    q = float(num.sum() / w.sum())
    return float((tol_num.sum() + abs(q) * tol_w.sum()) / w.sum()), q


@pytest.mark.parametrize("name,m,cap", CASES)
def test_dense_a_rank_engine_matches_jax_chunk_engine(name, m, cap, monkeypatch):
    """local_energy and quadratic_energy on the rank engine with its dense A:
    one rank_local_energy and one rank_quadratic_energy call, against JAX's
    dense-A chunk loop within the stated per-row and quotient bounds, and
    bitwise equal to the same calls with a_mat=None."""
    c = case(name)
    dt_j, dt_t = _terms(c)
    s, la, ph, w = _batch(c, m, cap, 0)
    states, la_t, ph_t = _t(s, la, ph)
    calls = _spies(monkeypatch)
    re_t, im_t = le_t.local_energy(dt_t, states, la_t, ph_t, m, chunk_rows=48)
    assert calls == {"rank_local_energy": 1}
    re_j, im_j = (np.asarray(a) for a in le_j.local_energy(
        dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la), jnp.asarray(ph), jnp.int32(m),
        chunk_rows=48))
    spec = dt_t.rank_spec
    table = build_value_table(spec, states, la_t, ph_t, m)
    tol = dg.rank_local_energy_tolerance(
        spec, table, states, la_t.float(), dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz,
        dt_t.yz_unique, dt_t.term_coeff, dt_t.diag_coeff, chunk_rows=48).numpy()[:m]
    assert np.all(np.abs(re_t.numpy()[:m] - re_j[:m]) <= tol)
    assert np.all(np.abs(im_t.numpy()[:m] - im_j[:m]) <= tol)
    diag = le_t.diagonal_energy(dt_t, states).numpy()
    assert np.abs(re_t.numpy()[:m] - diag[:m]).max() > 1e-3   # the lookup found pairs
    no_a = dataclasses.replace(dt_t, a_mat=None)
    again = le_t.local_energy(no_a, states, la_t, ph_t, m, chunk_rows=48)
    assert torch.equal(again[0], re_t) and torch.equal(again[1], im_t)

    calls.clear()
    q_t = float(le_t.quadratic_energy(dt_t, states, la_t, ph_t, m))
    assert calls == {"rank_quadratic_energy": 1}
    q_j = float(le_j.quadratic_energy(dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                      jnp.asarray(ph), jnp.int32(m)))
    bound, q_ref = _quotient_bound(spec, dt_t, states, la_t, ph_t, m)
    assert q_t == q_ref and abs(q_t - q_j) <= bound
    assert q_t == float(le_t.quadratic_energy(no_a, states, la_t, ph_t, m))


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_dense_a_rank_engine_launches_no_chunk_kernel(name, monkeypatch):
    """With a_mat present each call goes through its one-launch wrapper once,
    queries= too, and never through rank_ratio_rowsum or rank_gather2: the
    engine no longer holds them, and no call of theirs is made from their
    module either."""
    c = case(name)
    _, dt_t = _terms(c)
    assert not hasattr(le_t, "rank_ratio_rowsum") and not hasattr(le_t, "rank_gather2")
    s, la, ph, _ = _batch(c, 60, 64, 1)
    calls = _spies(monkeypatch)
    le_t.local_energy(dt_t, *_t(s, la, ph), 60)
    le_t.local_energy(dt_t, *_t(s, la, ph), torch.tensor(60),
                      queries=_t(s[5:20], la[5:20], ph[5:20]))
    le_t.quadratic_energy(dt_t, *_t(s, la, ph), 60)
    le_t.expectation_energy(dt_t, *_t(s, la, ph), torch.full((64,), 1 / 60), 60)
    assert calls == {"rank_local_energy": 3, "rank_quadratic_energy": 1}


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_exact_energy_with_dense_a_matches_jax(name, monkeypatch):
    """VMCTrainer.exact_energy() over the full sector (the default dispatch:
    a grid program and a dense A) is one rank_quadratic_energy call, against
    naqs_tpu's exact_energy on the same parameters within the quotient bound
    and 5e-6 Ha."""
    c = case(name)
    n_q = c.h_t.n_qubits
    kw = dict(amp_hidden=(16,), phase_hidden=(16,))
    cfg_j = nade_j.NAQSConfig(n_qubits=n_q, sectors=c.h_j.sectors, **kw)
    params = nade_j.init_params(jax.random.key(3), cfg_j)
    tr = VMCTrainer(nt.NAQSConfig(n_qubits=n_q, sectors=c.h_t.sectors, **kw), c.terms_t,
                    c.h_t, device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert tr.dt_h.a_mat is not None and tr.dt_h.rank_spec is not None
    calls = _spies(monkeypatch)
    got = tr.exact_energy()
    assert calls == {"rank_quadratic_energy": 1}
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    assert dt_j.a_mat is not None
    want = float(trainer_j.exact_energy(cfg_j, params, dt_j, jnp.asarray(c.h_j.basis)))
    basis = torch.as_tensor(c.h_t.basis)
    with torch.no_grad():
        la, ph = log_psi(tr.model, basis)
    bound, q_ref = _quotient_bound(tr.dt_h.rank_spec, tr.dt_h, basis, la, ph,
                                   basis.shape[0])
    assert got == q_ref
    assert abs(got - want) <= min(bound, 5e-6)
