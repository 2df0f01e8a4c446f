"""Port local_energy against naqs_tpu on one shared sorted batch.

`_engines` gives the port's rank engine (`dataclasses.replace(dt, dense=None)`,
as for JAX: with its dense A, which the port's one launch does not read);
the port's default dispatch (the grid engines) is held against both JAX
engines in `test_local_energy_matches_jax_engines`, and module by module in
test_torch_dense_engine.py.

Tolerances: 1e-10 Ha for the f64 diagonal; 2e-5 Ha per E_loc row and 5e-6
Ha on the weighted mean, because the fp32 off-diagonal sums run in another
order (the port sums H term by term, JAX as P @ A) than XLA's. The chunk
epilogue's plain version (`rank_ratio_rowsum_ref`, on no path of the port,
fed JAX's P @ A row) is held to the same 2e-5 Ha per row against the
off-diagonal part of JAX's `_local_energy_chunk`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu.ops import rank as rank_j
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops import rank as rank_t
from naqs_tpu_torch.ops.dyn_gather import rank_ratio_rowsum, rank_ratio_rowsum_ref
from test_torch_support import case, h_row, near_hf_states, padded_batch, to_u64

ROW_TOL = 2e-5
MEAN_TOL = 5e-6


def _engines(c):
    """(JAX rank engine, JAX default engine, port rank engine) DeviceTerms."""
    dt_default = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    dt_rank = dataclasses.replace(dt_default, dense=None)
    return dt_rank, dt_default, dataclasses.replace(_port_default(c), dense=None)


def _port_default(c):
    return le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")


def _batch(c, m, cap, seed):
    rng = np.random.default_rng(seed)
    s, la, ph, counts = padded_batch(near_hf_states(c, m, rng), cap, rng)
    return s, la, ph, counts / counts.sum()


def _port(dt_t, s, la, ph, m, **kw):
    e_re, e_im = le_t.local_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m, **kw)
    return e_re.numpy(), e_im.numpy()


def _jax(dt, s, la, ph, m, **kw):
    e_re, e_im = le_j.local_energy(dt, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                   jnp.asarray(ph), jnp.int32(m), **kw)
    return np.asarray(e_re), np.asarray(e_im)


@pytest.mark.parametrize("name,m,cap", [("H2O", 150, 160), ("H2O_6-31G", 64, 80)])
def test_local_energy_matches_jax_engines(name, m, cap):
    """Both port engines (rank, and the default dispatch's grid engine: the
    main path) against both JAX engines on one batch."""
    c = case(name)
    dt_rank, dt_default, dt_t = _engines(c)
    dt_t_default = _port_default(c)
    assert dt_t.rank_spec is not None and dt_t.a_mat is not None and dt_t.dense is None
    engine = "DenseTerms" if name == "H2O" else "FactorTerms"
    assert type(dt_default.dense).__name__ == type(dt_t_default.dense).__name__ == engine
    s, la, ph, w = _batch(c, m, cap, 0)

    jax_runs = [_jax(dt, s, la, ph, m) for dt in (dt_rank, dt_default)]
    for dt_port in (dt_t, dt_t_default):
        re_t, im_t = _port(dt_port, s, la, ph, m)
        for re_j, im_j in jax_runs:
            np.testing.assert_allclose(re_t[:m], re_j[:m], rtol=0, atol=ROW_TOL)
            np.testing.assert_allclose(im_t[:m], im_j[:m], rtol=0, atol=ROW_TOL)
            assert abs(np.sum(w[:m] * re_t[:m]) - np.sum(w[:m] * re_j[:m])) < MEAN_TOL
    # the off-diagonal part is non-trivial: E_loc differs from the diagonal
    e_diag = le_t.diagonal_energy(dt_t, torch.as_tensor(s[:m])).numpy()
    assert np.abs(re_t[:m] - e_diag).max() > 1e-3


def test_diagonal_energy_matches_jax():
    c = case("H2O_6-31G")
    dt_rank, _, dt_t = _engines(c)
    s = near_hf_states(c, 64, np.random.default_rng(1))
    e_t = le_t.diagonal_energy(dt_t, torch.as_tensor(s)).numpy()
    e_j = np.asarray(le_j.diagonal_energy(dt_rank, jnp.asarray(to_u64(s))))
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-10)


def test_queries_contract():
    """E_loc of a query subset, resolved against the full table, equals the
    same rows of the full call (and JAX's queries= call)."""
    c = case("H2O")
    dt_rank, _, dt_t = _engines(c)
    m, cap = 150, 160
    s, la, ph, _ = _batch(c, m, cap, 2)
    full_re, full_im = _port(dt_t, s, la, ph, m)
    rows = np.arange(3, m, 7)
    q = tuple(torch.as_tensor(a[rows]) for a in (s, la, ph))
    q_re, q_im = _port(dt_t, s, la, ph, m, queries=q)
    np.testing.assert_array_equal(q_re, full_re[rows])
    np.testing.assert_array_equal(q_im, full_im[rows])
    qj = (jnp.asarray(to_u64(s[rows])), jnp.asarray(la[rows]), jnp.asarray(ph[rows]))
    j_re, _ = _jax(dt_rank, s, la, ph, m, queries=qj)
    np.testing.assert_allclose(q_re, j_re, rtol=0, atol=ROW_TOL)


def test_chunking_does_not_change_results():
    c = case("H2O")
    _, _, dt_t = _engines(c)
    s, la, ph, _ = _batch(c, 150, 160, 3)
    a = _port(dt_t, s, la, ph, 150)
    b = _port(dt_t, s, la, ph, 150, chunk_rows=48)
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)


def test_segment_sum_path_matches_dense_a():
    c = case("H2O")
    _, _, dt_t = _engines(c)
    dt_seg = dataclasses.replace(
        le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, dense_a=False, device="cpu"),
        dense=None)
    assert dt_seg.a_mat is None
    s, la, ph, _ = _batch(c, 150, 160, 4)
    a = _port(dt_t, s, la, ph, 150)
    b = _port(dt_seg, s, la, ph, 150)
    np.testing.assert_allclose(a[0][:150], b[0][:150], rtol=0, atol=ROW_TOL)


def test_quadratic_and_expectation_energy_match_jax():
    c = case("H2O")
    dt_rank, _, dt_t = _engines(c)
    m, cap = 150, 160
    s, la, ph, w = _batch(c, m, cap, 5)
    q_t = float(le_t.quadratic_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                      torch.as_tensor(ph), m))
    q_j = float(le_j.quadratic_energy(dt_rank, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                      jnp.asarray(ph), jnp.int32(m)))
    assert abs(q_t - q_j) < MEAN_TOL
    e_t, v_t, _ = le_t.expectation_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                          torch.as_tensor(ph), torch.as_tensor(w), m)
    e_j, v_j, _ = le_j.expectation_energy(dt_rank, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                          jnp.asarray(ph), jnp.asarray(w), jnp.int32(m))
    assert abs(float(e_t) - float(e_j)) < MEAN_TOL
    assert abs(float(v_t) - float(v_j)) < 1e-4 * max(1.0, float(v_j))


def test_quadratic_energy_is_the_rayleigh_quotient():
    """Over the full STO-3G sector, quadratic_energy equals <psi|H|psi>/<psi|psi>
    from the JAX package's host sparse H (f32 amplitudes: 1e-5 Ha)."""
    from naqs_tpu.hamiltonian import assemble_sparse_hamiltonian_np

    c = case("H2O")
    _, _, dt_t = _engines(c)
    basis = c.h_t.basis
    rng = np.random.default_rng(6)
    la = (-rng.uniform(0, 2, size=len(basis))).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=len(basis)).astype(np.float32)
    psi = np.exp(la.astype(np.float64) + 1j * ph.astype(np.float64))
    hmat = assemble_sparse_hamiltonian_np(c.terms_j, basis.astype(np.uint64))
    want = float(np.real(np.vdot(psi, hmat @ psi)) / np.vdot(psi, psi).real)
    got = float(le_t.quadratic_energy(dt_t, torch.as_tensor(basis), torch.as_tensor(la),
                                      torch.as_tensor(ph), len(basis)))
    assert abs(got - want) < 1e-5


def test_no_rank_spec_takes_the_sort_engine_and_matches_jax():
    """With no Hilbert space there is no RankSpec: the port takes its sort
    engine, as JAX does, and matches JAX's sort path per row and on the mean.
    (Cases of the sort engine: test_torch_sort_engine.py.)"""
    c = case("H2O")
    dt = le_t.DeviceTerms.from_terms(c.terms_t, device="cpu")  # no hilbert
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j)
    assert dt.rank_spec is None and dt.dense is None and dt_j.rank_spec is None
    s, la, ph, w = _batch(c, 20, 32, 7)
    re_t, im_t = _port(dt, s, la, ph, 20)
    re_j, im_j = _jax(dt_j, s, la, ph, 20)
    np.testing.assert_allclose(re_t[:20], re_j[:20], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:20], im_j[:20], rtol=0, atol=ROW_TOL)
    assert abs(np.sum(w[:20] * re_t[:20]) - np.sum(w[:20] * re_j[:20])) < MEAN_TOL


CHUNK_CASES = [
    ("H2O", None, 40),                          # one sector, 14 qubits
    ("H2O", ((5, 3), (4, 4), (3, 5)), 40),      # three sectors, 14 qubits
    ("H2O_6-31G", None, 512),                   # a main-path chunk, 26 qubits
]


@pytest.mark.parametrize("name,sectors,n_rows", CHUNK_CASES)
def test_rank_ratio_rowsum_ref_matches_jax_chunk(name, sectors, n_rows):
    """The fused epilogue's plain version against the off-diagonal part of
    JAX's _local_energy_chunk (rank table lookup), on one numpy-seeded chunk."""
    c = case(name)
    if sectors is None:
        h_j, h_t = c.h_j, c.h_t
    else:
        n_q = c.h_t.n_qubits
        h_j, h_t = nq.Hilbert(n_qubits=n_q, sectors=sectors), nt.Hilbert(n_qubits=n_q,
                                                                        sectors=sectors)
    dt_j = dataclasses.replace(le_j.DeviceTerms.from_terms(c.terms_j, hilbert=h_j),
                               dense=None)
    dt_t = dataclasses.replace(
        le_t.DeviceTerms.from_terms(c.terms_t, hilbert=h_t, device="cpu"), dense=None)
    rng = np.random.default_rng(8)
    if sectors is None:
        states = near_hf_states(c, 2 * n_rows, rng)
    else:
        states = np.sort(rng.choice(h_t.basis, size=2 * n_rows, replace=False))
    m = len(states)
    la = -rng.uniform(0.0, 1.5, size=m).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=m).astype(np.float32)
    rows = np.sort(rng.choice(m, size=n_rows, replace=False))
    s, my_la, my_ph = states[rows], la[rows], ph[rows]

    tab_j = rank_j.build_value_table(dt_j.rank_spec, jnp.asarray(to_u64(states)),
                                     jnp.asarray(la), jnp.asarray(ph), jnp.int32(m))
    s_j = jnp.asarray(to_u64(s))
    re_j, im_j = le_j._local_energy_chunk(dt_j, s_j, jnp.asarray(to_u64(states)), tab_j,
                                          jnp.asarray(my_la), jnp.asarray(my_ph),
                                          jnp.int32(m))
    off_j = np.asarray(re_j) - np.asarray(le_j.diagonal_energy(dt_j, s_j))

    tab_t = rank_t.build_value_table(dt_t.rank_spec, torch.as_tensor(states),
                                     torch.as_tensor(la), torch.as_tensor(ph), m)
    s_t = torch.as_tensor(s)
    args = (dt_t.rank_spec, s_t, dt_t.xy_unique, tab_t, torch.as_tensor(my_la),
            torch.as_tensor(my_ph), h_row(dt_t, s_t))
    e_re, e_im = rank_ratio_rowsum_ref(*args)
    assert e_re.dtype == e_im.dtype == torch.float32 and e_re.shape == (n_rows,)
    np.testing.assert_allclose(e_re.numpy(), off_j, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(e_im.numpy(), np.asarray(im_j), rtol=0, atol=ROW_TOL)
    assert np.abs(off_j).max() > 1e-3  # the chunk has hits: a non-trivial sum

    before = rank_ratio_rowsum.launches
    w_re, w_im = rank_ratio_rowsum(*args)
    assert rank_ratio_rowsum.launches == before  # CPU tensors take the plain version
    assert torch.equal(w_re, e_re) and torch.equal(w_im, e_im)
