"""The port's sort engine (E_loc with no RankSpec) against naqs_tpu's.

Both packages get the same numpy-seeded sorted, SENTINEL-padded batch and
`DeviceTerms.from_terms(terms)` with no Hilbert space, so neither has a
RankSpec and both take their sort-based lookup, as `tests/test_rank.py` does
for the JAX package. Cases: H2O and LiH STO-3G (generated), and a synthetic
40-qubit term set over random sorted states, a space no rank table covers;
each with a dense A and with the per-term H row (`dense_a=False`). The port
computes both in one launch (`sorted_local_energy`, `sorted_quadratic_energy`:
H summed term by term for the found pairs); JAX with a dense A runs its chunk
loop, whose H row is `P @ A`, the terms of a flip mask summed in another
order.

Tolerances, as in test_torch_local_energy.py: 2e-5 Ha per E_loc row and 5e-6
Ha on the weighted mean and on quadratic_energy (fp32 off-diagonal sums in
another order than XLA's); the lookup itself, integer work, bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops.dyn_gather import rowsum_tolerance
from naqs_tpu_torch.ops.offdiag_h import (OFFDIAG_ATOL, OFFDIAG_RTOL, offdiag_h_terms,
                                          offdiag_h_terms_ref, offdiag_tolerance, term_groups)
from naqs_tpu_torch.ops.sort_lookup import (QUAD_MISS, lookup, pack_table, sorted_gather2,
                                            sorted_gather2_ref, sorted_local_energy,
                                            sorted_local_energy_ref,
                                            sorted_local_energy_tolerance, sorted_log_amps,
                                            sorted_ratio_rowsum, sorted_ratio_rowsum_ref)
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case, h_row, near_hf_states, padded_batch, to_u64

ROW_TOL = 2e-5
MEAN_TOL = 5e-6
SYN_QUBITS = 40


class _Syn:
    """A synthetic 40-qubit Hamiltonian, the same term dict compiled by both
    packages, and 300 random sorted states: a third of the flip masks join
    two of them, so the truncated sums have hits."""
    name = "synthetic"

    def __init__(self):
        rng = np.random.default_rng(11)
        states = np.unique(rng.integers(0, 1 << SYN_QUBITS, size=300, dtype=np.int64))
        flips = [int(states[i] ^ states[j]) for i, j in rng.integers(0, len(states), (60, 2))
                 if i != j]
        flips += [int(x) for x in rng.integers(1, 1 << SYN_QUBITS, size=120, dtype=np.int64)]
        terms = {(): -40.0}
        for _ in range(80):   # diagonal Z strings
            sites = rng.choice(SYN_QUBITS, size=rng.integers(1, 4), replace=False)
            terms[tuple((int(q), "Z") for q in sorted(sites))] = float(rng.normal())
        for xy in flips:      # X/Y strings on the flip's sites, an even number of Y
            sites = [q for q in range(SYN_QUBITS) if xy >> q & 1]
            for _ in range(rng.integers(1, 4)):
                n_y = 2 * int(rng.integers(0, 2)) if len(sites) > 1 else 0
                ys = set(rng.choice(sites, size=n_y, replace=False).tolist())
                zs = rng.choice(SYN_QUBITS, size=2, replace=False)
                ops = {q: ("Y" if q in ys else "X") for q in sites}
                ops.update({int(q): "Z" for q in zs if int(q) not in ops})
                key = tuple(sorted(ops.items()))
                terms[key] = terms.get(key, 0.0) + 0.1 * float(rng.normal())
        self.states = states
        self.terms_j = nq.compile_pauli_terms(terms, SYN_QUBITS)
        self.terms_t = nt.compile_pauli_terms(terms, SYN_QUBITS)


_SYN = {}


def _case(name):
    if name == "synthetic":
        if not _SYN:
            _SYN["c"] = _Syn()
        return _SYN["c"]
    return case(name)


def _batch(c, m, cap, seed):
    rng = np.random.default_rng(seed)
    if c.name == "synthetic":
        states = np.sort(rng.choice(c.states, size=m, replace=False))
    else:
        states = near_hf_states(c, m, rng)
    s, la, ph, counts = padded_batch(states, cap, rng)
    return s, la, ph, counts / counts.sum()


def _terms(c, dense_a):
    """(JAX, port) DeviceTerms with no Hilbert space: the sort engines."""
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, dense_a=dense_a)
    dt_t = le_t.DeviceTerms.from_terms(c.terms_t, dense_a=dense_a, device="cpu")
    assert dt_j.rank_spec is None and dt_t.rank_spec is None and dt_t.dense is None
    assert (dt_t.a_mat is None) == (not dense_a) == (dt_j.a_mat is None)
    return dt_j, dt_t


def _port(dt_t, s, la, ph, m, **kw):
    e_re, e_im = le_t.local_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m, **kw)
    return e_re.numpy(), e_im.numpy()


def _jax(dt, s, la, ph, m, **kw):
    e_re, e_im = le_j.local_energy(dt, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                   jnp.asarray(ph), jnp.int32(m), **kw)
    return np.asarray(e_re), np.asarray(e_im)


CASES = [("H2O", 150, 160), ("LiH", 60, 64), ("synthetic", 200, 224)]


@pytest.mark.parametrize("dense_a", [True, False])
@pytest.mark.parametrize("name,m,cap", CASES)
def test_sort_engine_local_energy_matches_jax(name, m, cap, dense_a):
    c = _case(name)
    dt_j, dt_t = _terms(c, dense_a)
    s, la, ph, w = _batch(c, m, cap, 0)
    re_t, im_t = _port(dt_t, s, la, ph, m, chunk_rows=64)
    re_j, im_j = _jax(dt_j, s, la, ph, m, chunk_rows=64)
    np.testing.assert_allclose(re_t[:m], re_j[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], im_j[:m], rtol=0, atol=ROW_TOL)
    assert abs(np.sum(w[:m] * re_t[:m]) - np.sum(w[:m] * re_j[:m])) < MEAN_TOL
    e_diag = le_t.diagonal_energy(dt_t, torch.as_tensor(s[:m])).numpy()
    assert np.abs(re_t[:m] - e_diag).max() > 1e-3   # the lookup found coupled states
    # queries=: a subset of rows, resolved against the whole buffer
    rows = np.arange(1, m, 5)
    q_re, q_im = _port(dt_t, s, la, ph, m, queries=tuple(torch.as_tensor(a[rows])
                                                         for a in (s, la, ph)))
    qj_re, qj_im = _jax(dt_j, s, la, ph, m, queries=tuple(
        jnp.asarray(a[rows]) for a in (to_u64(s), la, ph)))
    np.testing.assert_allclose(q_re, qj_re, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(q_im, qj_im, rtol=0, atol=ROW_TOL)


def _quad_case(name, m, cap, engine="sort", wide=False):
    tag = "-".join(filter(None, ["rank" if engine == "rank" else "", "wide" if wide else ""]))
    return pytest.param(name, m, cap, engine, wide,
                        id="-".join(filter(None, [tag, name, str(m), str(cap)])))


# the sort engine's cases, then the rank engine's (a RankSpec: the STO-3G
# molecules), and untrained wide-range log-amps (in [-80, 0]) through both
QUAD_CASES = ([_quad_case(*c) for c in CASES]
              + [_quad_case(*c, engine="rank") for c in CASES[:2]]
              + [_quad_case(*c, wide=True) for c in (CASES[0], CASES[2])]
              + [_quad_case(*CASES[0], engine="rank", wide=True)])


@pytest.mark.parametrize("dense_a", [True, False])
@pytest.mark.parametrize("name,m,cap,engine,wide", QUAD_CASES)
def test_sort_engine_quadratic_energy_matches_jax(name, m, cap, engine, wide, dense_a):
    """quadratic_energy against JAX's on the same batch: with a dense A the
    chunk loops, without one the one-launch kernels (sorted_quadratic_energy,
    or rank_quadratic_energy on the rank engine: a Hilbert space, no grid
    program)."""
    c = _case(name)
    if engine == "rank":
        dt_j = dataclasses.replace(le_j.DeviceTerms.from_terms(
            c.terms_j, dense_a=dense_a, hilbert=c.h_j), dense=None)
        dt_t = dataclasses.replace(le_t.DeviceTerms.from_terms(
            c.terms_t, dense_a=dense_a, hilbert=c.h_t, device="cpu"), dense=None)
        assert dt_t.rank_spec is not None and (dt_t.a_mat is None) == (not dense_a)
    else:
        dt_j, dt_t = _terms(c, dense_a)
    s, la, ph, _ = _batch(c, m, cap, 1)
    if wide:
        la[:m] = -np.random.default_rng(12).uniform(0.0, 80.0, size=m)
    q_t = float(le_t.quadratic_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                      torch.as_tensor(ph), m, chunk_rows=64))
    q_j = float(le_j.quadratic_energy(dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                      jnp.asarray(ph), jnp.int32(m), chunk_rows=64))
    assert abs(q_t - q_j) < MEAN_TOL


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_sort_engine_matches_the_rank_engine(name):
    """On a space that has a RankSpec, the sort engine forced by
    replace(dt, rank_spec=None, dense=None) gives the rank engine's E_loc:
    bitwise that of the rank engine's one launch (a_mat=None: the same H row
    term by term, the same fp32 epilogue on the same hits), with the dense A
    or without, and within ROW_TOL of the rank engine's chunk loop, whose H
    row is P @ A."""
    c = case(name)
    dt = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    dt_rank = dataclasses.replace(dt, dense=None)
    dt_sort = dataclasses.replace(dt, rank_spec=None, dense=None)
    s, la, ph, _ = _batch(c, 60, 64, 2)
    one = _port(dataclasses.replace(dt_rank, a_mat=None), s, la, ph, 60)
    for dt_s in (dt_sort, dataclasses.replace(dt_sort, a_mat=None)):
        b = _port(dt_s, s, la, ph, 60)
        np.testing.assert_array_equal(one[0], b[0])
        np.testing.assert_array_equal(one[1], b[1])
    a = _port(dt_rank, s, la, ph, 60)
    np.testing.assert_allclose(a[0][:60], b[0][:60], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(a[1][:60], b[1][:60], rtol=0, atol=ROW_TOL)


@pytest.mark.parametrize("name", ["H2O", "synthetic"])
def test_lookup_matches_jax_lookup(name):
    """The plain lookup against JAX's _lookup on one chunk's coupled states,
    SENTINEL-padded query rows included: found, la and ph bitwise."""
    c = _case(name)
    dt_j, dt_t = _terms(c, True)
    m, cap = 100, 128
    s, la, ph, _ = _batch(c, m, cap, 3)
    rows = np.concatenate([np.arange(0, m, 3), np.arange(m, cap)])   # padding rows too
    coupled = s[rows][:, None] ^ dt_t.xy_unique.numpy()[None, :]
    coupled[rows >= m] = SENTINEL ^ dt_t.xy_unique.numpy()[None, :]
    st = jnp.asarray(to_u64(s))
    rec = le_j.pack_table(st, jnp.asarray(la), jnp.asarray(ph))
    f_j, la_j, ph_j = le_j._lookup(st, rec, jnp.int32(m), jnp.asarray(to_u64(coupled)))
    f_t, la_t, ph_t = lookup(*pack_table(torch.as_tensor(s), torch.as_tensor(la),
                                         torch.as_tensor(ph)), m, torch.as_tensor(coupled))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    f = np.asarray(f_j)
    np.testing.assert_array_equal(la_t.numpy()[f], np.asarray(la_j)[f])
    np.testing.assert_array_equal(ph_t.numpy()[f], np.asarray(ph_j)[f])
    n_real = len(c.terms_t.xy_unique)   # the padded flip masks are 0: a row finds itself
    assert f[:, :n_real].sum() > 0 and not f[rows >= m].any()


@pytest.mark.parametrize("dense_a", [True, False])
@pytest.mark.parametrize("name", ["H2O", "synthetic"])
def test_sorted_ratio_rowsum_ref_matches_jax_chunk(name, dense_a):
    """The fused epilogue's plain version against the off-diagonal part of
    JAX's _local_energy_chunk on its sort branch, on one chunk; the wrapper
    takes the plain version on CPU tensors and counts nothing."""
    c = _case(name)
    dt_j, dt_t = _terms(c, dense_a)
    m, cap = 150 if name == "H2O" else 200, 224
    s, la, ph, _ = _batch(c, m, cap, 4)
    rows = np.sort(np.random.default_rng(5).choice(cap, size=64, replace=False))
    st = jnp.asarray(to_u64(s))
    rec = le_j.pack_table(st, jnp.asarray(la), jnp.asarray(ph))
    s_j = jnp.asarray(to_u64(s[rows]))
    re_j, im_j = le_j._local_energy_chunk(dt_j, s_j, st, rec, jnp.asarray(la[rows]),
                                          jnp.asarray(ph[rows]), jnp.int32(m))
    off_j = np.asarray(re_j) - np.asarray(le_j.diagonal_energy(dt_j, s_j))

    table = pack_table(torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph))
    s_t = torch.as_tensor(s[rows])
    nv = torch.tensor(m)
    h = h_row(dt_t, s_t)
    args = (*table, nv, s_t, dt_t.xy_unique, torch.as_tensor(la[rows]),
            torch.as_tensor(ph[rows]), h)
    e_re, e_im = sorted_ratio_rowsum_ref(*args)
    live = rows < m
    np.testing.assert_allclose(e_re.numpy()[live], off_j[live], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(e_im.numpy()[live], np.asarray(im_j)[live], rtol=0,
                               atol=ROW_TOL)
    assert np.abs(off_j[live]).max() > 1e-3
    tol = rowsum_tolerance(sorted_log_amps(table[0], table[1], nv, s_t, dt_t.xy_unique),
                           torch.as_tensor(la[rows]), h)
    assert tol.shape == (64,) and float(tol.max()) > 2e-5   # found pairs widen it
    before = sorted_ratio_rowsum.launches
    w_re, w_im = sorted_ratio_rowsum(*args)
    assert sorted_ratio_rowsum.launches == before
    assert torch.equal(w_re, e_re) and torch.equal(w_im, e_im)


@pytest.mark.parametrize("name", ["H2O", "synthetic"])
def test_sorted_gather2_ref_matches_jax_lookup(name):
    """quadratic_energy's lookup: la, ph of found pairs of live rows, bitwise
    as JAX's _quadratic_energy_chunk gathers them, and the miss value
    elsewhere; the wrapper on CPU tensors is the plain version."""
    c = _case(name)
    _, dt_t = _terms(c, True)
    m, cap = 100, 128
    s, la, ph, _ = _batch(c, m, cap, 6)
    xy = dt_t.xy_unique
    st = jnp.asarray(to_u64(s))
    rows = np.arange(40, 104)              # live rows, then padding
    coupled = jnp.asarray(to_u64(s[rows]))[:, None] ^ jnp.asarray(to_u64(xy.numpy()))[None, :]
    pos = jnp.minimum(jnp.searchsorted(st, coupled.ravel(), method="sort").reshape(
        coupled.shape), cap - 1)
    live = rows < m
    found = np.asarray((st[pos] == coupled) & (jnp.searchsorted(st, coupled.ravel(),
                       method="sort").reshape(coupled.shape) < m)) & live[:, None]
    want_la = np.where(found, la[np.asarray(pos)], QUAD_MISS)
    want_ph = np.where(found, ph[np.asarray(pos)], 0.0)
    table = pack_table(torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph))
    args = (*table, torch.tensor(m), torch.as_tensor(s[rows]), xy, torch.as_tensor(live))
    g_la, g_ph = sorted_gather2_ref(*args)
    np.testing.assert_array_equal(g_la.numpy(), want_la.astype(np.float32))
    np.testing.assert_array_equal(g_ph.numpy(), want_ph.astype(np.float32))
    assert found[:, :len(c.terms_t.xy_unique)].sum() > 0
    before = sorted_gather2.launches
    w_la, w_ph = sorted_gather2(*args)
    assert sorted_gather2.launches == before
    assert torch.equal(w_la, g_la) and torch.equal(w_ph, g_ph)


@pytest.mark.parametrize("name", ["H2O", "LiH", "synthetic"])
def test_offdiag_h_terms_ref_matches_jax_segment_sum(name):
    """The H row from the terms grouped by flip mask against JAX's
    _offdiag_h segment-sum branch, per entry within the stated tolerance,
    and against the dense-A matmul of both packages."""
    c = _case(name)
    dt_j, dt_t = _terms(c, False)
    dt_jd, dt_td = _terms(c, True)
    s, _, _, _ = _batch(c, 60, 64, 7)
    h_j = np.asarray(le_j._offdiag_h(dt_j, jnp.asarray(to_u64(s))))
    args = (torch.as_tensor(s), dt_t.yz_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.term_coeff)
    h_t = offdiag_h_terms_ref(*args)
    tol = offdiag_tolerance(dt_t.xy_ptr, dt_t.term_coeff).numpy()
    assert h_t.shape == h_j.shape == (64, dt_t.xy_unique.shape[0])
    assert np.all(np.abs(h_t.numpy() - h_j) <= tol[None, :])
    assert np.abs(h_j).max() > 1e-2
    h_dense = h_row(dt_td, torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(h_dense, h_j, rtol=0, atol=1e-5)
    before = offdiag_h_terms.launches
    assert torch.equal(offdiag_h_terms(*args), h_t) and offdiag_h_terms.launches == before


def test_term_groups_are_the_terms_by_flip_mask():
    """xy_ptr, term_yz and term_coeff hold every off-diagonal term once, in
    its flip mask's group, in the compiled order; padding is left out."""
    c = case("H2O")
    t = c.terms_t
    ptr, yz, co = term_groups(t.gxy, len(t.xy_unique) + 3, t.gyz, t.coeff)  # 3 pad groups
    assert ptr[0] == 0 and ptr[-1] == len(t.coeff) and np.all(np.diff(ptr) >= 0)
    g = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    np.testing.assert_array_equal(g, np.sort(t.gxy))
    np.testing.assert_array_equal(t.yz_unique[yz], t.yz[np.argsort(t.gxy, kind="stable")])
    np.testing.assert_array_equal(co, t.coeff[np.argsort(t.gxy, kind="stable")])
    assert OFFDIAG_RTOL * np.abs(co).sum() > OFFDIAG_ATOL


def test_no_rank_table_over_32_qubits_dispatches_to_the_sort_engine():
    """N2 6-31G (36 qubits, sector (7, 7) of 1,012,766,976 states; the
    package's .npz) has no RankSpec: DeviceTerms takes the sort engine, and
    its chunk loop runs 128-row chunks of the padded term counts."""
    from naqs_tpu_torch.ops.rank import RankSpec

    mol = nt.load_molecule("N2_6-31G_gen", load_hamiltonian=False)
    assert (mol.n_qubits, mol.n_electrons, mol.basis) == (36, 14, "6-31g")
    assert abs(mol.hf_energy - -108.867763) < 1e-6
    h = nt.Hilbert.for_molecule(mol)
    assert h.sectors == ((7, 7),) and h.sector_size == 1_012_766_976
    assert RankSpec.for_hilbert(h) is None
    # the padded term counts of its compiled Hamiltonian (K, Kxy, Kyz =
    # 137,872, 27,257, 26,754): a dense A would hold 736,296,960 entries
    kxy, kyz = 27_392, 26_880
    assert kxy * kyz > le_t._DENSE_A_MAX
    assert le_t._chunk_rows(kxy, kyz) == 128


def test_trainer_step_on_the_sort_engine():
    """A VMCTrainer step whose DeviceTerms has no RankSpec (the sort engine,
    with the per-term H row) gives the rank engine's step: the same energy to
    the fp32 order of the H row, the same sample count."""
    c = case("H2O")
    cfg = nt.NAQSConfig(n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors,
                        amp_hidden=(16,), phase_hidden=(16,))
    tc = nt.TrainConfig(n_samples=1e3, n_unq_samples_min=10, n_unq_samples_max=256, seed=3)
    runs = []
    for sort in (False, True):
        tr = nt.VMCTrainer(cfg, c.terms_t, c.h_t, tc, device="cpu")
        tr.dt = dataclasses.replace(tr.dt, dense=None)
        if sort:
            tr.dt = dataclasses.replace(tr.dt, rank_spec=None, a_mat=None)
        runs.append([tr.step() for _ in range(2)])
    for a, b in zip(*runs):
        assert a["n_unique"] == b["n_unique"]
        assert abs(a["e_loc"] - b["e_loc"]) < MEAN_TOL


def _energy_args(dt_t, s, la, ph, m, rows=None):
    """sorted_local_energy's arguments: the whole batch as the table, the
    given rows of it (all if None) as the queries."""
    table = pack_table(torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph))
    q = table if rows is None else tuple(t[rows] for t in table)
    return (*table, torch.tensor(m), *q, dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz,
            dt_t.yz_unique, dt_t.term_coeff, dt_t.diag_yz, dt_t.diag_coeff)


@pytest.mark.parametrize("name,m,cap", CASES)
def test_sorted_local_energy_ref_matches_jax(name, m, cap):
    """The one-launch E_loc's plain version against JAX's local_energy on the
    sort path with no dense A (the per-term H row), per row; the wrapper on
    CPU tensors is the plain version and counts nothing; the tolerance it
    is held to on the card covers found pairs."""
    c = _case(name)
    dt_j, dt_t = _terms(c, False)
    s, la, ph, _ = _batch(c, m, cap, 0)
    args = _energy_args(dt_t, s, la, ph, m)
    e_re, e_im = sorted_local_energy_ref(*args, chunk_rows=64)
    re_j, im_j = _jax(dt_j, s, la, ph, m, chunk_rows=64)
    assert e_re.dtype == e_im.dtype == torch.float64 and e_re.shape == (cap,)
    np.testing.assert_allclose(e_re.numpy()[:m], re_j[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(e_im.numpy()[:m], im_j[:m], rtol=0, atol=ROW_TOL)
    whole = sorted_local_energy_ref(*args)   # one chunk: the same rows
    assert torch.equal(whole[0], e_re) and torch.equal(whole[1], e_im)
    before = sorted_local_energy.launches
    w_re, w_im = sorted_local_energy(*args, chunk_rows=64)
    assert sorted_local_energy.launches == before
    assert torch.equal(w_re, e_re) and torch.equal(w_im, e_im)
    tol = sorted_local_energy_tolerance(args[0], args[1], args[3], args[4], args[5],
                                        *args[7:12], args[13], chunk_rows=64)
    exact = sorted_local_energy_tolerance(args[0], args[1], args[3], args[4], args[5],
                                          *args[7:12], args[13], h_exact=True)
    assert tol.shape == (cap,) and bool((tol >= exact).all()) and bool((tol > exact).any())
    assert float(exact.min()) > 2e-5   # ROWSUM_ATOL and the diagonal's term


@pytest.mark.parametrize("name", ["H2O", "LiH", "synthetic"])
def test_local_energy_dispatches_to_sorted_local_energy(name, monkeypatch):
    """local_energy takes sorted_local_energy exactly where rank_spec and dense
    are None, with a dense A or without: once per call, with queries= too, and
    never with a RankSpec or a grid program."""
    c = _case(name)
    calls = []

    def spy(*args, **kw):
        calls.append(args[4].shape[0])
        return sorted_local_energy(*args, **kw)

    monkeypatch.setattr(le_t, "sorted_local_energy", spy)
    s, la, ph, _ = _batch(c, 60, 64, 2)
    if name == "synthetic":
        engines = {"sort, dense A": _terms(c, True)[1], "sort": _terms(c, False)[1]}
    else:
        dt = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
        assert dt.dense is not None and dt.a_mat is not None
        engines = {"grid": dt, "rank": dataclasses.replace(dt, dense=None),
                   "rank, no A": dataclasses.replace(dt, dense=None, a_mat=None),
                   "sort, dense A": dataclasses.replace(dt, rank_spec=None, dense=None),
                   "sort": dataclasses.replace(dt, rank_spec=None, dense=None, a_mat=None)}
    for label, dt in engines.items():
        calls.clear()
        _port(dt, s, la, ph, 60)
        _port(dt, s, la, ph, 60, queries=tuple(torch.as_tensor(a[5:20]) for a in (s, la, ph)))
        assert calls == ([64, 15] if label.startswith("sort") else []), label


@pytest.mark.parametrize("name,m,cap", [("H2O", 150, 160), ("synthetic", 200, 224)])
def test_dense_a_one_launch_sums_each_group_term_by_term(name, m, cap):
    """With a dense A the port's one launch sums a found flip mask's terms one
    by one, where JAX's chunk loop takes that mask's H entry from P @ A, a sum
    over every sign mask in another order. On rows whose coupled states are
    found through several flip masks of several terms each, the two stay
    within ROW_TOL per row and MEAN_TOL on the weighted mean and on
    quadratic_energy."""
    c = _case(name)
    dt_j, dt_t = _terms(c, True)
    s, la, ph, w = _batch(c, m, cap, 6)
    re_t, im_t = _port(dt_t, s, la, ph, m)
    re_j, im_j = _jax(dt_j, s, la, ph, m, chunk_rows=64)
    np.testing.assert_allclose(re_t[:m], re_j[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], im_j[:m], rtol=0, atol=ROW_TOL)
    assert abs(np.sum(w[:m] * re_t[:m]) - np.sum(w[:m] * re_j[:m])) < MEAN_TOL
    states = torch.as_tensor(s)
    found = sorted_log_amps(states, torch.as_tensor(la), torch.tensor(m), states[:m],
                            dt_t.xy_unique) > -1e29
    sizes = torch.diff(dt_t.xy_ptr.long())
    several = (found & (sizes > 1)[None, :] & (dt_t.xy_unique != 0)[None, :]).sum(-1)
    assert int((several >= 2).sum()) >= 5    # rows where the two orders differ
    q_t = float(le_t.quadratic_energy(dt_t, states, torch.as_tensor(la), torch.as_tensor(ph),
                                      m))
    q_j = float(le_j.quadratic_energy(dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                      jnp.asarray(ph), jnp.int32(m), chunk_rows=64))
    assert abs(q_t - q_j) < MEAN_TOL


@pytest.mark.parametrize("name", ["H2O", "synthetic"])
def test_sorted_local_energy_sentinel_query_rows(name):
    """queries= with SENTINEL rows between live ones: those rows get e_im == 0
    and e_re == their diagonal_energy exactly, and every live row the value it
    gets without the padding."""
    c = _case(name)
    _, dt_t = _terms(c, False)
    m, cap = (150, 160) if name == "H2O" else (200, 224)
    s, la, ph, _ = _batch(c, m, cap, 8)
    live = np.arange(0, m, 3)
    q_s = np.full(3 * len(live), SENTINEL, np.int64)
    q_la, q_ph = np.zeros(len(q_s), np.float32), np.zeros(len(q_s), np.float32)
    q_s[::3], q_la[::3], q_ph[::3] = s[live], la[live], ph[live]   # two padding rows after each
    table = pack_table(torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph))
    rest = (dt_t.xy_unique, dt_t.xy_ptr, dt_t.term_yz, dt_t.yz_unique, dt_t.term_coeff,
            dt_t.diag_yz, dt_t.diag_coeff)
    e_re, e_im = sorted_local_energy(*table, torch.tensor(m), torch.as_tensor(q_s),
                                     torch.as_tensor(q_la), torch.as_tensor(q_ph), *rest,
                                     chunk_rows=64)
    pad = q_s == SENTINEL
    diag = le_t.diagonal_energy(dt_t, torch.as_tensor(q_s[pad])).numpy()
    assert np.all(e_im.numpy()[pad] == 0) and np.array_equal(e_re.numpy()[pad], diag)
    alone = sorted_local_energy(*table, torch.tensor(m), *(t[live] for t in table), *rest,
                                chunk_rows=64)
    assert np.array_equal(e_re.numpy()[~pad], alone[0].numpy())
    assert np.array_equal(e_im.numpy()[~pad], alone[1].numpy())
    assert np.abs(alone[1].numpy()).max() > 1e-4   # the live rows found coupled states


@pytest.mark.parametrize("fill", ["empty", "full"])
@pytest.mark.parametrize("name", ["H2O", "synthetic"])
def test_sorted_local_energy_n_valid_0_and_all(name, fill):
    """n_valid 0: no coupled state is found, every row gets its diagonal and 0;
    n_valid = U (no padding): JAX's local_energy on the same buffer."""
    c = _case(name)
    dt_j, dt_t = _terms(c, False)
    cap = 96
    s, la, ph, _ = _batch(c, cap, cap, 9)
    m = 0 if fill == "empty" else cap
    e_re, e_im = le_t.local_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m, chunk_rows=64)
    re_j, im_j = _jax(dt_j, s, la, ph, m, chunk_rows=64)
    np.testing.assert_allclose(e_re.numpy(), re_j, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(e_im.numpy(), im_j, rtol=0, atol=ROW_TOL)
    diag = le_t.diagonal_energy(dt_t, torch.as_tensor(s)).numpy()
    if fill == "empty":
        assert np.array_equal(e_re.numpy(), diag) and np.all(e_im.numpy() == 0)
    else:
        assert np.abs(e_re.numpy() - diag).max() > 1e-3
