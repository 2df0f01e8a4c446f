"""The one-launch E_loc and quadratic form where there is no dense A.

Where a dense coupling matrix A would pass 2^26 entries, the port's
`local_energy` on the rank engine is one `rank_local_energy` launch and
`quadratic_energy` one `rank_quadratic_energy` (a RankSpec) or
`sorted_quadratic_energy` (none) launch; on the CPU each takes its plain
version. Held here against the JAX package's chunk loops on the same
numpy-seeded batch (`DeviceTerms.from_terms(..., dense_a=False)`, the grid
program set aside with `dense=None` in both packages), and the plain versions
against the compositions they replace. quadratic_energy with no dense A
against JAX's, through both lookups and with wide-range log-amps:
test_torch_sort_engine.py::test_sort_engine_quadratic_energy_matches_jax.

Tolerances: 2e-5 Ha per live E_loc row and 5e-6 Ha on the weighted mean and
on quadratic_energy (fp32 off-diagonal sums in another order than XLA's), as
in test_torch_local_energy.py; a padding (SENTINEL) row's E_loc is its
diagonal exactly (JAX's rank engine computes such a row from the low bits of
SENTINEL: garbage that every caller masks); the plain versions equal the
compositions they replace bitwise per row (the same torch operations), and
their totals within 1e-12 relative (another order of the f64 sums).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu_torch.ops import dyn_gather as dg
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops import sort_lookup as sl
from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms_ref
from naqs_tpu_torch.ops.rank import build_value_table
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case, near_hf_states, padded_batch, to_u64

ROW_TOL = 2e-5
MEAN_TOL = 5e-6
TOTAL_RTOL = 1e-12

CASES = [("H2O", 150, 160), ("LiH", 60, 64), ("H2O_6-31G", 64, 80)]


def _terms(c):
    """(JAX, port) rank engines with no dense A and no grid program."""
    dt_j = dataclasses.replace(le_j.DeviceTerms.from_terms(c.terms_j, dense_a=False,
                                                           hilbert=c.h_j), dense=None)
    dt_t = dataclasses.replace(le_t.DeviceTerms.from_terms(c.terms_t, dense_a=False,
                                                           hilbert=c.h_t, device="cpu"),
                               dense=None)
    assert dt_j.a_mat is None and dt_t.a_mat is None
    assert dt_j.rank_spec is not None and dt_t.rank_spec is not None
    return dt_j, dt_t


def _batch(c, m, cap, seed, wide=False):
    """A sorted SENTINEL-padded batch of m states near HF; wide: log-amps in
    [-80, 0], as an untrained model gives them."""
    rng = np.random.default_rng(seed)
    s, la, ph, counts = padded_batch(near_hf_states(c, m, rng), cap, rng)
    if wide:
        la[:m] = -rng.uniform(0.0, 80.0, size=m)
    return s, la, ph, counts / counts.sum()


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _port(dt_t, s, la, ph, m, **kw):
    e_re, e_im = le_t.local_energy(dt_t, *_t(s, la, ph), m, **kw)
    return e_re.numpy(), e_im.numpy()


def _jax(dt, s, la, ph, m, **kw):
    e_re, e_im = le_j.local_energy(dt, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                   jnp.asarray(ph), jnp.int32(m), **kw)
    return np.asarray(e_re), np.asarray(e_im)


def _spies(monkeypatch):
    """Count the calls local_energy and quadratic_energy make of each kernel
    wrapper they hold."""
    calls = {}
    for name in ("rank_local_energy", "rank_quadratic_energy", "sorted_local_energy",
                 "sorted_quadratic_energy", "rank_ratio_rowsum", "rank_gather2",
                 "sorted_ratio_rowsum", "sorted_gather2", "offdiag_h_terms"):
        if not hasattr(le_t, name):   # not held by the engine: it cannot call it
            continue
        real = getattr(le_t, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(le_t, name, spy)
    return calls


@pytest.mark.parametrize("name,m,cap", CASES)
def test_rank_local_energy_matches_jax(name, m, cap, monkeypatch):
    """local_energy on the rank engine with no dense A: one rank_local_energy
    call against JAX's chunk loop on the live rows, padding rows their
    diagonal, queries= with SENTINEL rows between live ones."""
    c = case(name)
    dt_j, dt_t = _terms(c)
    s, la, ph, w = _batch(c, m, cap, 0)
    calls = _spies(monkeypatch)
    re_t, im_t = _port(dt_t, s, la, ph, m, chunk_rows=48)
    assert calls == {"rank_local_energy": 1}
    re_j, im_j = _jax(dt_j, s, la, ph, m, chunk_rows=48)
    np.testing.assert_allclose(re_t[:m], re_j[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], im_j[:m], rtol=0, atol=ROW_TOL)
    assert abs(np.sum(w[:m] * re_t[:m]) - np.sum(w[:m] * re_j[:m])) < MEAN_TOL
    diag = le_t.diagonal_energy(dt_t, torch.as_tensor(s)).numpy()
    assert np.abs(re_t[:m] - diag[:m]).max() > 1e-3   # the lookup found coupled states
    assert np.array_equal(re_t[m:], diag[m:]) and np.all(im_t[m:] == 0)
    # queries=: every third live row, two SENTINEL rows after each
    live = np.arange(0, m, 3)
    q = [np.full(3 * len(live), SENTINEL, np.int64), np.zeros(3 * len(live), np.float32),
         np.zeros(3 * len(live), np.float32)]
    for q_a, a in zip(q, (s, la, ph)):
        q_a[::3] = a[live]
    q_re, q_im = _port(dt_t, s, la, ph, torch.tensor(m), queries=_t(*q))
    assert calls == {"rank_local_energy": 2}
    np.testing.assert_array_equal(q_re[::3], re_t[live])
    np.testing.assert_array_equal(q_im[::3], im_t[live])
    pad = q[0] == SENTINEL
    assert np.array_equal(q_re[pad], np.full(pad.sum(), diag[-1])) and np.all(q_im[pad] == 0)
    qj_re, qj_im = _jax(dt_j, s, la, ph, m, queries=tuple(
        jnp.asarray(a[live]) for a in (to_u64(s), la, ph)))
    np.testing.assert_allclose(q_re[::3], qj_re, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(q_im[::3], qj_im, rtol=0, atol=ROW_TOL)


@pytest.mark.parametrize("name,m,cap", CASES[:2])
def test_rank_local_energy_ref_is_the_chunk_composition(name, m, cap):
    """The plain version against what the chunk loop composed, chunk by
    chunk: the diagonal, offdiag_h_terms_ref and rank_ratio_rowsum_ref,
    bitwise on every live row; its tolerance widens with the found pairs."""
    c = case(name)
    _, dt_t = _terms(c)
    s, la, ph, _ = _batch(c, m, cap, 1)
    states, la_t, ph_t = _t(s, la, ph)
    spec = dt_t.rank_spec
    table = build_value_table(spec, states, la_t, ph_t, m)
    terms = (dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.yz_unique, dt_t.term_coeff)
    nv = torch.tensor(m)
    e_re, e_im = dg.rank_local_energy_ref(spec, table, states, nv, states, la_t, ph_t, *terms,
                                          dt_t.diag_yz, dt_t.diag_coeff, chunk_rows=32)
    for i in range(0, m, 32):
        rows = slice(i, min(i + 32, m))
        sc = states[rows]
        h = offdiag_h_terms_ref(sc, dt_t.yz_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.term_coeff)
        r, im = dg.rank_ratio_rowsum_ref(spec, sc, dt_t.xy_unique, table, la_t[rows],
                                         ph_t[rows], h)
        assert torch.equal(e_re[rows], le_t.diagonal_energy(dt_t, sc) + r.double())
        assert torch.equal(e_im[rows], im.double())
    tol = dg.rank_local_energy_tolerance(spec, table, states, la_t, dt_t.xy_unique,
                                         *terms[1:], dt_t.diag_coeff, chunk_rows=32)
    exact = dg.rank_local_energy_tolerance(spec, table, states, la_t, dt_t.xy_unique,
                                           *terms[1:], dt_t.diag_coeff, h_exact=True)
    assert tol.shape == (cap,) and bool((tol >= exact).all()) and bool((tol > exact).any())
    before = dg.rank_local_energy.launches
    got = dg.rank_local_energy(spec, table, states, nv, states, la_t, ph_t, *terms,
                               dt_t.diag_yz, dt_t.diag_coeff, chunk_rows=32)
    assert dg.rank_local_energy.launches == before   # CPU tensors: the plain version
    assert torch.equal(got[0], e_re) and torch.equal(got[1], e_im)


def _quad_composition(dt_t, gather, states, la, ph, m, chunk):
    """JAX's _quadratic_energy_chunk, chunk by chunk, per row: (num, w)."""
    num, wts = [], []
    for i in range(0, states.shape[0], chunk):
        rows = slice(i, i + chunk)
        s, my_la, my_ph = states[rows], la[rows], ph[rows]
        live = torch.arange(i, i + s.shape[0]) < m
        w = torch.where(live, torch.exp(2.0 * my_la.double()), 0.0)
        g_la, g_ph = gather(s, live)
        amp = torch.where(live[:, None], torch.exp(g_la + my_la[:, None]), 0.0)
        r_re = amp * torch.cos(g_ph - my_ph[:, None])
        off = torch.sum(offdiag_h_terms_ref(s, dt_t.yz_unique, dt_t.xy_ptr, dt_t.term_yz,
                                            dt_t.term_coeff) * r_re, dim=-1)
        num.append(torch.where(live, w * le_t.diagonal_energy(dt_t, s) + off.double(), 0.0))
        wts.append(w)
    return torch.cat(num), torch.cat(wts)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("lookup", ["rank", "sort"])
@pytest.mark.parametrize("name,m,cap", CASES[:2])
def test_quadratic_refs_are_the_chunk_composition(name, m, cap, lookup, wide):
    """Each one-launch quadratic form's plain version against the chunk loop
    it replaces (the lookup, offdiag_h_terms_ref and the eager epilogue):
    bitwise per row, the quotient within TOTAL_RTOL of the loop's; the
    wrapper on CPU tensors is the plain version and counts nothing."""
    c = case(name)
    _, dt_t = _terms(c)
    s, la, ph, _ = _batch(c, m, cap, 2, wide=wide)
    states, la_t, ph_t = _t(s, la, ph)
    live = torch.arange(cap) < m
    la_q = torch.where(live, la_t - la_t[:m].max(), dg.QUAD_MISS).float()
    nv = torch.tensor(m)
    terms = (dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.yz_unique, dt_t.term_coeff,
             dt_t.diag_yz, dt_t.diag_coeff)
    if lookup == "rank":
        spec = dt_t.rank_spec
        table = build_value_table(spec, states, la_q, ph_t, m, miss_log_amp=dg.QUAD_MISS)
        args = (spec, table, nv, states, la_q, ph_t, *terms)
        ref, wrapper = dg.rank_quadratic_energy_ref, dg.rank_quadratic_energy
        gather = lambda sc, lv: dg.rank_gather2_ref(spec, sc, dt_t.xy_unique, table)
    else:
        args = (states, la_q, ph_t, nv, *terms)
        ref, wrapper = sl.sorted_quadratic_energy_ref, sl.sorted_quadratic_energy
        gather = lambda sc, lv: sl.sorted_gather2_ref(states, la_q, ph_t, nv, sc,
                                                      dt_t.xy_unique, lv)
    num, w = ref(*args, chunk_rows=32)
    want_num, want_w = _quad_composition(dt_t, gather, states, la_q, ph_t, m, 32)
    assert torch.equal(num, want_num) and torch.equal(w, want_w)
    assert bool((num[m:] == 0).all() and (w[m:] == 0).all())
    got, want = float(num.sum() / w.sum()), float(want_num.sum() / want_w.sum())
    assert abs(got - want) <= TOTAL_RTOL * abs(want)
    off = num[:m] - w[:m] * le_t.diagonal_energy(dt_t, states[:m])
    assert float(off.abs().max()) > 1e-6   # found pairs add to the numerator
    before = wrapper.launches
    again = wrapper(*args, chunk_rows=32)
    assert wrapper.launches == before and torch.equal(again[0], num)
    tol_num, tol_w = (dg.rank_quadratic_energy_tolerance(spec, table, nv, states, la_q,
                                                         *terms[:5], dt_t.diag_coeff)
                      if lookup == "rank" else
                      sl.sorted_quadratic_energy_tolerance(states, la_q, ph_t, nv, *terms[:5],
                                                           dt_t.diag_coeff))
    assert bool((tol_num[:m] > 0).all() and (tol_num[m:] == 0).all())
    assert bool((tol_w[m:] == 0).all() and (tol_w[:m] > 0).all())


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_one_launch_dispatch(name, monkeypatch):
    """Which wrapper each engine calls: with a RankSpec the one-launch rank_*
    kernels, with a dense A too; without one the one-launch sorted_* kernels,
    with a dense A too (no engine holds a chunk kernel to call); none of them
    with a grid program."""
    c = case(name)
    dt = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    assert dt.dense is not None and dt.a_mat is not None
    no_a = dataclasses.replace(dt, a_mat=None)
    engines = {
        "grid": (dt, {}, None),
        "rank": (dataclasses.replace(dt, dense=None), {"rank_local_energy": 1},
                 {"rank_quadratic_energy": 1}),
        "rank, no A": (dataclasses.replace(no_a, dense=None), {"rank_local_energy": 1},
                       {"rank_quadratic_energy": 1}),
        "sort": (dataclasses.replace(dt, dense=None, rank_spec=None),
                 {"sorted_local_energy": 1}, {"sorted_quadratic_energy": 1}),
        "sort, no A": (dataclasses.replace(no_a, dense=None, rank_spec=None),
                       {"sorted_local_energy": 1}, {"sorted_quadratic_energy": 1}),
    }
    s, la, ph, _ = _batch(c, 60, 64, 4)
    calls = _spies(monkeypatch)
    assert not any(hasattr(le_t, k) for k in ("sorted_ratio_rowsum", "sorted_gather2",
                                              "rank_ratio_rowsum", "rank_gather2"))
    for label, (dt_e, want_le, want_q) in engines.items():
        calls.clear()
        _port(dt_e, s, la, ph, 60)
        assert calls == want_le, label
        if want_q is not None:   # quadratic_energy takes no grid program
            calls.clear()
            le_t.quadratic_energy(dt_e, *_t(s, la, ph), 60)
            assert calls == want_q, label


def test_frozen_core_n2_631g_takes_the_rank_engine_with_no_dense_a():
    """N2 6-31G with its 1s core frozen (the package's .npz, freeze_core of 4
    qubits): 32 qubits, sector (5, 5) of 19,079,424 states. It has a RankSpec
    but no grid program (over FACT_SIZE_MAX) and no dense A (Kyz * Kxy over
    2^26): local_energy is one rank_local_energy launch a call."""
    from naqs_tpu_torch.hamiltonian import freeze_core
    from naqs_tpu_torch.ops import dense_engine as de

    mol = nt.load_molecule("N2_6-31G_gen")
    terms = freeze_core(nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits), 4)
    h = nt.Hilbert(n_qubits=mol.n_qubits - 4, sectors=((5, 5),))
    assert h.n_qubits == 32 and h.sector_size == 19_079_424
    assert (len(terms.coeff), len(terms.xy_unique), len(terms.yz_unique)) == (87_628, 17_056,
                                                                              16_815)
    assert h.sector_size > de.FACT_SIZE_MAX
    dt = le_t.DeviceTerms.from_terms(terms, hilbert=h, device="cpu")
    assert dt.rank_spec is not None and dt.rank_spec.size == h.sector_size
    assert dt.dense is None and dt.a_mat is None
    assert dt.xy_unique.shape[0] * dt.yz_unique.shape[0] > le_t._DENSE_A_MAX
