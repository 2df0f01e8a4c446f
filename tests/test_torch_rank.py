"""Rank addressing and the rank engine's gather, port against naqs_tpu.

Integers and gathered floats must agree bitwise. The JAX gather is the
Pallas kernel `table_gather2` run in interpret mode, fed JAX's rank_index.
The CUDA kernels' rank arithmetic (spin-word compaction and the two-lookup
colex tables of `rank.spec_table`) is replayed here in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.ops import rank as rank_j
from naqs_tpu.ops.dyn_gather import pad_tables, table_gather2
from naqs_tpu_torch.ops import rank as rank_t
from naqs_tpu_torch.ops.dyn_gather import rank_gather2, rank_gather2_ref
from naqs_tpu_torch.ops.rank import spec_table
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case, to_u64

SPACES = [
    (((5, 5),), 14),                   # H2O STO-3G
    (((2, 2),), 12),                   # LiH-like
    (((5, 3), (4, 4), (3, 5)), 14),    # multi-sector
    (((9, 7),), 20),                   # open shell
]


def _specs(sectors, n_qubits):
    hj = nq.Hilbert(n_qubits=n_qubits, sectors=sectors)
    ht = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    sj, st = rank_j.RankSpec.for_hilbert(hj), rank_t.RankSpec.for_hilbert(ht)
    return hj, ht, sj, st


@pytest.mark.parametrize("sectors,n_qubits", SPACES)
def test_spec_matches_jax(sectors, n_qubits):
    _, _, sj, st = _specs(sectors, n_qubits)
    assert (st.n_qubits, st.n_shells, st.size, st.offset, st.stride, st.expected_nb) == (
        sj.n_qubits, sj.n_shells, sj.size, sj.offset, sj.stride, sj.expected_nb)


@pytest.mark.parametrize("sectors,n_qubits", SPACES)
def test_rank_index_on_full_basis(sectors, n_qubits):
    hj, ht, sj, st = _specs(sectors, n_qubits)
    idx_t = rank_t.rank_index(st, torch.as_tensor(ht.basis)).numpy()
    np.testing.assert_array_equal(idx_t, rank_t.np_rank_index(st, ht.basis))
    np.testing.assert_array_equal(idx_t, np.asarray(rank_j.rank_index(sj, jnp.asarray(hj.basis))))
    np.testing.assert_array_equal(idx_t, rank_j.np_rank_index(sj, hj.basis))
    assert idx_t.min() == 0 and idx_t.max() == st.size - 1
    assert len(np.unique(idx_t)) == st.size


@pytest.mark.parametrize("sectors,n_qubits", SPACES)
def test_rank_index_on_random_states(sectors, n_qubits):
    """Mostly invalid states (and the SENTINEL) must hit slot spec.size."""
    hj, ht, sj, st = _specs(sectors, n_qubits)
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(0, 2 ** n_qubits, size=3000),
                        [SENTINEL]]).astype(np.int64)
    idx_t = rank_t.rank_index(st, torch.as_tensor(x)).numpy()
    idx_j = np.asarray(rank_j.rank_index(sj, jnp.asarray(to_u64(x))))
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(idx_t, rank_t.np_rank_index(st, x))
    valid = ht.contains(x)
    assert (idx_t[~valid] == st.size).all() and (idx_t[valid] < st.size).all()


def _table_inputs(c, m, seed):
    rng = np.random.default_rng(seed)
    basis = c.h_t.basis
    states = np.sort(rng.choice(basis, size=m, replace=False))
    la = -rng.uniform(0, 3, size=m).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=m).astype(np.float32)
    return states, la, ph


def test_build_value_table_matches_jax():
    c = case("H2O")
    sj = rank_j.RankSpec.for_hilbert(c.h_j)
    st = rank_t.RankSpec.for_hilbert(c.h_t)
    states, la, ph = _table_inputs(c, 120, 2)
    cap = 128  # 8 padding rows must not disturb the table
    s_pad = np.full(cap, SENTINEL, np.int64)
    s_pad[:120] = states
    la_p = np.pad(la, (0, 8), constant_values=5.0)
    ph_p = np.pad(ph, (0, 8), constant_values=5.0)
    for miss in (rank_t._MISS, -200.0):
        tab_j = np.asarray(rank_j.build_value_table(
            sj, jnp.asarray(to_u64(s_pad)), jnp.asarray(la_p), jnp.asarray(ph_p),
            jnp.int32(120), miss_log_amp=miss))
        tab_t = rank_t.build_value_table(
            st, torch.as_tensor(s_pad), torch.as_tensor(la_p), torch.as_tensor(ph_p),
            120, miss_log_amp=miss)
        assert tab_t.shape == (st.size + 1, 2) and tab_t.is_contiguous()
        np.testing.assert_array_equal(tab_t.numpy(), tab_j)


def test_rank_gather2_ref_matches_pallas_interpret():
    """rank_gather2_ref == table_gather2(interpret=True) o rank_index, bitwise,
    on the H2O STO-3G table with its real flip masks and live + miss rows."""
    c = case("H2O")
    sj = rank_j.RankSpec.for_hilbert(c.h_j)
    st = rank_t.RankSpec.for_hilbert(c.h_t)
    states, la, ph = _table_inputs(c, 200, 3)
    tab_j = rank_j.build_value_table(sj, jnp.asarray(to_u64(states)), jnp.asarray(la),
                                     jnp.asarray(ph), jnp.int32(200))
    tab_t = rank_t.build_value_table(st, torch.as_tensor(states), torch.as_tensor(la),
                                     torch.as_tensor(ph), 200)
    s = states[::5]                              # (40,) chunk rows
    xy = c.terms_t.xy_unique                     # (Kxy,) real flip masks
    idx_j = rank_j.rank_index(sj, jnp.asarray(to_u64(s))[:, None]
                              ^ jnp.asarray(xy.astype(np.uint64))[None, :])
    la_pad, ph_pad = pad_tables(tab_j, sj.size, tile_w=128, miss=rank_j._MISS)
    g_la_j, g_ph_j = table_gather2(la_pad, ph_pad, idx_j, tile_w=128, block_rows=8,
                                   interpret=True)
    before = rank_gather2.launches
    g_la_t, g_ph_t = rank_gather2_ref(st, torch.as_tensor(s), torch.as_tensor(xy), tab_t)
    g2_la, g2_ph = rank_gather2(st, torch.as_tensor(s), torch.as_tensor(xy), tab_t)
    assert rank_gather2.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(g_la_t.numpy(), np.asarray(g_la_j))
    np.testing.assert_array_equal(g_ph_t.numpy(), np.asarray(g_ph_j))
    np.testing.assert_array_equal(g2_la.numpy(), g_la_t.numpy())
    np.testing.assert_array_equal(g2_ph.numpy(), g_ph_t.numpy())
    found = (g_la_t > rank_t._MISS_THRESHOLD).numpy()
    assert 0 < found.sum() < found.size  # both hits and misses exercised


def test_lookup_matches_jax():
    c = case("H2O")
    sj = rank_j.RankSpec.for_hilbert(c.h_j)
    st = rank_t.RankSpec.for_hilbert(c.h_t)
    states, la, ph = _table_inputs(c, 150, 4)
    tab_j = rank_j.build_value_table(sj, jnp.asarray(to_u64(states)), jnp.asarray(la),
                                     jnp.asarray(ph), jnp.int32(150))
    tab_t = rank_t.build_value_table(st, torch.as_tensor(states), torch.as_tensor(la),
                                     torch.as_tensor(ph), 150)
    q = c.h_t.basis
    fj, laj, phj = rank_j.lookup(sj, tab_j, jnp.asarray(to_u64(q)))
    ft, lat, pht = rank_t.lookup(st, tab_t, torch.as_tensor(q))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lat.numpy(), np.asarray(laj))
    np.testing.assert_array_equal(pht.numpy(), np.asarray(phj))
    assert ft.sum().item() == 150


def _even_bits(x):
    """csrc/rank_gather.cu::even_bits on uint32 values held in int64."""
    x = x & 0x55555555
    for shift, mask in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                        (8, 0x0000FFFF)):
        x = (x | (x >> shift)) & mask
    return x


def _popc(x):
    return sum((x >> j) & 1 for j in range(16))


def _kernel_rank(st, states):
    """csrc/rank_gather.cu::rank_of, replayed in numpy on int64 states."""
    flat, lo_bits, qmask = spec_table(st)
    flat = flat.astype(np.int64)
    n = st.n_shells
    sect = flat[:4 * (n + 1)].reshape(n + 1, 4)
    lo = flat[4 * (n + 1):4 * (n + 1) + (1 << lo_bits)]
    hi = flat[4 * (n + 1) + (1 << lo_bits):]
    lo_mask = (1 << lo_bits) - 1

    def colex(w):
        low = w & lo_mask
        return lo[low] + hi[(w >> lo_bits) * (lo_bits + 1) + _popc(low)]

    x = np.asarray(states, np.int64) & 0xFFFFFFFF & qmask
    a, b = _even_bits(x), _even_bits(x >> 1)
    rec = sect[_popc(a)]
    ok = rec[:, 2] == _popc(b)
    return np.where(ok, rec[:, 0] + colex(a) * rec[:, 1] + colex(b), st.size)


@pytest.mark.parametrize("sectors,n_qubits", SPACES)
def test_kernel_rank_tables_match_rank_index(sectors, n_qubits):
    """The kernels' compacted-word, two-lookup rank equals rank_index on the
    whole basis, on random (mostly invalid) states and on SENTINEL."""
    _, ht, _, st = _specs(sectors, n_qubits)
    rng = np.random.default_rng(5)
    x = np.concatenate([ht.basis, rng.integers(0, 2 ** n_qubits, size=3000),
                        rng.integers(0, 2 ** 62, size=500), [SENTINEL]]).astype(np.int64)
    np.testing.assert_array_equal(_kernel_rank(st, x), rank_t.np_rank_index(st, x))
    flat, lo_bits, qmask = spec_table(st)
    assert flat.dtype == np.int32 and qmask == (1 << n_qubits) - 1
    n, n_hi = st.n_shells, st.n_shells - lo_bits
    assert flat.size == 4 * (n + 1) + (1 << lo_bits) + (1 << n_hi) * (lo_bits + 1)
