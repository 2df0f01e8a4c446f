"""The port's data-parallel local energies and collectives against naqs_tpu,
across two processes on the CPU (gloo).

Two ranks share a `file://` store under the test's tmp_path (never a TCP
port: xdist workers run side by side), started by
`naqs_tpu_torch.parallel.launch.spawn` and joined with a timeout; they get
numpy inputs only, and run `tests/test_torch_parallel_ranks.py`, which imports
no JAX. The JAX reference runs here, on 2 of the 8 virtual CPU devices
(`conftest.py`), through `jax.shard_map`.

- E_loc: each rank's own rows against the merged buffer of both ranks'
  rows, on every engine (dense, factored, rank, sort and the staircase
  engine forced as `tests/test_torch_xl.py` forces it), held against JAX's
  `local_energy(..., axis_name="dp", axis_size=2)` under `shard_map`. The
  shards are ragged and OVERLAP: 10 states lie on both ranks, so the merged
  table holds each of them twice (JAX's own sharded test draws disjoint
  shards). Tolerance per live row: the single-device engine tests' own, 2e-5
  Ha for the grid, rank and sort engines, rtol 2e-6 / atol 2e-6 for the
  staircase engine; the merged buffer exactly.
- `comm.all_gather_rows`: bit for bit, for int64, float32 (with -0.0 and a
  NaN), float64 and bool rows in one call.
- `multihost.initialize_distributed`: a single process with no request is a
  no-op that returns False; an explicit request for two processes that
  fails raises. (Failures that raise at once: a rendezvous that no second
  process joins would wait for the group's timeout.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.ops import dense_engine as de_j
from naqs_tpu.ops.local_energy import DeviceTerms as DeviceTermsJ
from naqs_tpu.ops.local_energy import local_energy as local_energy_j
from naqs_tpu.parallel import make_mesh
from naqs_tpu_torch.parallel import initialize_distributed
from naqs_tpu_torch.parallel.launch import spawn
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case, to_u64

import test_torch_parallel_ranks as ranks

D = 2
N_PER = 24               # rows a rank
LIVE = (22, 19)          # live rows of each rank
SHARED = 10              # states on both ranks
ROW_TOL = 2e-5           # Ha: the grid, rank and sort engines against JAX
XL_TOL = 2e-6            # rtol and atol: the staircase engine against JAX
TIMEOUT = 120            # s: the ranks' join
ENGINES = ["dense", "fact", "rank", "sort", "xl"]


def _shards(basis: np.ndarray, seed: int):
    """Two sorted, SENTINEL-padded shards of N_PER rows with LIVE[r] live
    states each, SHARED of them on both ranks; each distinct state carries
    one (log_amp, phase) wherever it lies."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(basis, size=LIVE[0] + LIVE[1] - SHARED, replace=False)
    la = (rng.normal(size=len(pool)) - 1.0).astype(np.float32)
    ph = rng.normal(size=len(pool)).astype(np.float32)
    picks = [np.arange(LIVE[0]), np.arange(LIVE[0] - SHARED, len(pool))]
    out = []
    for sel in picks:
        sel = sel[np.argsort(pool[sel])]
        s = np.full(N_PER, SENTINEL, np.int64)
        a, p = np.zeros(N_PER, np.float32), np.zeros(N_PER, np.float32)
        s[:len(sel)], a[:len(sel)], p[:len(sel)] = pool[sel], la[sel], ph[sel]
        out.append((s, a, p, len(sel)))
    return out


def _jax_sharded_eloc(dt, shards):
    """JAX's sharded E_loc on a 2-device mesh: gather, sort, and each shard's
    own rows against the merged table, the grid engines' mask loop split
    over the mesh."""
    mesh = make_mesh(jax.devices()[:D])

    def f(qs, qla, qph):
        qs, qla, qph = qs[0], qla[0], qph[0]
        gs = jax.lax.all_gather(qs, "dp").reshape(-1)
        gla = jax.lax.all_gather(qla, "dp").reshape(-1)
        gph = jax.lax.all_gather(qph, "dp").reshape(-1)
        order = jnp.argsort(gs)
        gs, gla, gph = gs[order], gla[order], gph[order]
        gnv = jnp.sum(gs != jnp.uint64(0xFFFFFFFFFFFFFFFF)).astype(jnp.int32)
        e_re, e_im = local_energy_j(dt, gs, gla, gph, gnv, queries=(qs, qla, qph),
                                    axis_name="dp", axis_size=D)
        return e_re[None], e_im[None]

    run = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=P("dp"),
                                check_vma=False))
    qs = np.stack([to_u64(s) for s, _, _, _ in shards])
    re, im = run(jnp.asarray(qs), jnp.asarray(np.stack([a for _, a, _, _ in shards])),
                 jnp.asarray(np.stack([p for _, _, p, _ in shards])))
    return np.asarray(re), np.asarray(im)


def _jax_terms(h_j, terms_j, engine):
    dt = DeviceTermsJ.from_terms(terms_j, hilbert=h_j)
    if engine == "fact":
        return dataclasses.replace(dt, dense=de_j.FactorTerms.build(terms_j, h_j))
    if engine == "rank":
        return dataclasses.replace(dt, dense=None)
    if engine == "sort":
        return DeviceTermsJ.from_terms(terms_j)
    return dt


@pytest.fixture(scope="module")
def eloc_runs(tmp_path_factory):
    """The two ranks' E_loc on every engine, and JAX's, on the same shards."""
    c = case("LiH")
    h_xl_t = nt.Hilbert(n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors, n_exc_max=2)
    h_xl_j = nq.Hilbert(n_qubits=c.h_j.n_qubits, sectors=c.h_j.sectors, n_exc_max=2)
    t_xl_t = nt.compile_pauli_terms(c.mol_t.qubit_hamiltonian, c.mol_t.n_qubits,
                                    n_excitations_max=2)
    t_xl_j = nq.compile_pauli_terms(c.mol_j.qubit_hamiltonian, c.mol_j.n_qubits,
                                    n_excitations_max=2)
    shards = {"full": _shards(c.h_t.basis, 0), "xl": _shards(h_xl_t.basis, 1)}
    want = {}
    for engine in ENGINES:
        if engine == "xl":
            caps = de_j.DENSE_SIZE_MAX, de_j.FACT_SIZE_MAX
            de_j.DENSE_SIZE_MAX = de_j.FACT_SIZE_MAX = 1
            try:
                dt = DeviceTermsJ.from_terms(t_xl_j, hilbert=h_xl_j)
            finally:
                de_j.DENSE_SIZE_MAX, de_j.FACT_SIZE_MAX = caps
            assert type(dt.dense).__name__ == "FactorTermsXL"
            want[engine] = _jax_sharded_eloc(dt, shards["xl"])
        else:
            want[engine] = _jax_sharded_eloc(_jax_terms(c.h_j, c.terms_j, engine),
                                             shards["full"])
    work = tmp_path_factory.mktemp("eloc")
    full = {e: (c.h_t, c.terms_t) for e in ENGINES if e != "xl"}
    got = spawn(ranks.sharded_eloc, D, (full, shards["full"]), workdir=str(work),
                timeout=TIMEOUT)
    got_xl = spawn(ranks.sharded_eloc, D, ({"xl": (h_xl_t, t_xl_t)}, shards["xl"]),
                   workdir=str(work), timeout=TIMEOUT)
    for r in range(D):
        got[r]["xl"] = got_xl[r]["xl"]
    return shards, want, got


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_eloc_with_overlapping_shards_matches_jax(eloc_runs, engine):
    shards, want, got = eloc_runs
    tol = dict(rtol=XL_TOL, atol=XL_TOL) if engine == "xl" else dict(rtol=0, atol=ROW_TOL)
    for r in range(D):
        n = shards["xl" if engine == "xl" else "full"][r][3]
        re, im = got[r][engine]
        np.testing.assert_allclose(re[:n], want[engine][0][r, :n], err_msg=f"rank {r}", **tol)
        np.testing.assert_allclose(im[:n], want[engine][1][r, :n], err_msg=f"rank {r}", **tol)
        assert np.isfinite(re).all() and np.isfinite(im).all()


def test_merged_buffer_keeps_every_copy_and_counts_distinct_states(eloc_runs):
    """The merged buffer: both ranks' rows sorted by state (SENTINEL last),
    the same on both ranks; n_valid counts each copy of a shared state,
    n_unique each state once."""
    shards, _, got = eloc_runs
    states = np.concatenate([s for s, _, _, _ in shards["full"]])
    las = np.concatenate([a for _, a, _, _ in shards["full"]])
    order = np.argsort(states, kind="stable")
    for r in range(D):
        m_states, m_la, n_valid, n_unique = got[r]["merged"]
        np.testing.assert_array_equal(m_states, states[order])
        np.testing.assert_array_equal(m_la, las[order])
        assert n_valid == LIVE[0] + LIVE[1]
        assert n_unique == LIVE[0] + LIVE[1] - SHARED
        assert (m_states[n_valid:] == SENTINEL).all()


def test_all_gather_rows_is_bitwise(tmp_path):
    rng = np.random.default_rng(3)
    rows = []
    for r in range(D):
        f32 = rng.normal(size=(5, 3)).astype(np.float32)
        f32[0, 0], f32[1, 1] = -0.0, np.nan
        rows.append((rng.integers(-2**62, 2**62, size=5), f32, rng.normal(size=5),
                     rng.random(5) < 0.5))
    got = spawn(ranks.gather_bits, D, (rows,), workdir=str(tmp_path), timeout=TIMEOUT)
    for r in range(D):
        for k, g in enumerate(got[r]):
            want = np.concatenate([rows[q][k] for q in range(D)])
            assert g.dtype == want.dtype and g.shape == want.shape
            assert g.tobytes() == want.tobytes()


def test_initialize_distributed_without_a_request_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["rank out of range", "a backend torch lacks"])
def test_initialize_distributed_reraises_an_explicit_failure(how, tmp_path):
    """An explicit request for two processes that fails raises (a silent
    fall back to one process would train on half the data): a rank outside
    the group, or the MPI backend, which torch's wheels do not build."""
    store = f"file://{tmp_path}/store"
    args = (store, 2, 5) if how == "rank out of range" else (store, 2, 0)
    backend = None if how == "rank out of range" else "mpi"
    with pytest.raises((ValueError, RuntimeError)):
        initialize_distributed(*args, device="cpu", backend=backend)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world,local,want", [(2, None, "cuda:1"), (3, None, None),
                                              (3, "0", "cuda:0")])
def test_rank_device_refuses_more_ranks_than_cards(world, local, want, monkeypatch):
    """Without LOCAL_RANK, rank r of a group no larger than the cards seen runs
    on cuda:r; a larger group raises (NCCL refuses two ranks on one card)
    rather than putting two ranks on one card. LOCAL_RANK names the card."""
    from naqs_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 1)
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local)
    if want is None:
        with pytest.raises(RuntimeError, match="LOCAL_RANK"):
            multihost.rank_device()
    else:
        assert multihost.rank_device() == torch.device(want)
    assert multihost.rank_device("cpu") == torch.device("cpu")
