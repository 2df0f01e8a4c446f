"""The grid and rank engines' E_loc glue (ops/rank.py::rank_index,
ops/grid_glue.py: grid_scatter, grid_readout) against naqs_tpu, and the
per-thread arithmetic of their kernels (csrc/grid_glue.cu) replayed in numpy
against the plain versions.

On the CPU each wrapper runs its plain version, the engines' chains as they
were, so these hold the chains against the JAX package on inputs the engine
tests do not cover (the XL blocked index on every kind of state, the table
scatter with out-of-sector live rows and float64 inputs, an empty batch,
float64 model outputs) and hold each kernel's index arithmetic, order-
preserving max key, cell choice, readout arithmetic and XL diagonal branch to
the chains. The kernels themselves run on the card
(`tests/test_torch_cuda.py -k grid_glue`, `chip_smoke.py`).

Tolerances: indices, tables and the replays of the kernels' cell choice and
readout arithmetic exactly (integer maps; the same float32 operations, each
rounded, on the same torch-computed transcendentals); E_loc per row within
ROW_TOL = 2e-5 Ha of the JAX engine (the engine tests' bar: fp32 numerator
sums in another order); at n_valid = 0 every row is its diagonal, within
DIAG_TOL = 1e-10 Ha (an f64 sum of the same terms in another order); the
replayed XL diagonal, summed in term order as the kernel sums it, within
grid_glue.DIAG_ATOL of torch.sum's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naqs_tpu.ops import dense_engine as de_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu.ops import rank as rank_j
from naqs_tpu_torch.ops import dense_engine as de_t
from naqs_tpu_torch.ops import grid_glue as gg
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops import rank as rank_t
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_rank import _kernel_rank
from test_torch_support import case, padded_batch, to_u64
from test_torch_xl import _mixed_buffer, _space

ROW_TOL = 2e-5     # Ha, against the JAX engine
DIAG_TOL = 1e-10   # Ha, an empty batch's rows (their diagonal) against JAX's


@pytest.fixture
def force_xl(monkeypatch):
    """Both packages past their DenseTerms and FactorTerms caps."""
    for mod in (de_j, de_t):
        monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
        monkeypatch.setattr(mod, "FACT_SIZE_MAX", 1)


@pytest.fixture
def force_factored(monkeypatch):
    """Both packages past their DenseTerms cap: FactorTerms on H2O STO-3G."""
    for mod in (de_j, de_t):
        monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)


def _xl_program(e=1):
    _, h_t, h_j, t_t, t_j = _space("LiH", e, t_exc=4)
    prog_t = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    prog_j = de_j.FactorTermsXL.build(t_j, h_j)
    return h_t, prog_t, prog_j, rank_t.RankSpec.for_hilbert(h_t), \
        rank_j.RankSpec.for_hilbert(h_j)


def _xl_states(h_t, rng):
    """Every kind of state the XL blocked index sees: staircase states, states
    inside the rectangle but outside the staircase, states outside the
    rectangle (inside the sector), states outside the sector, SENTINEL."""
    s, _, _, kinds = _mixed_buffer(h_t, 1, rng)
    m = len(kinds)
    full = rank_t.np_rank_index(rank_t.RankSpec.for_hilbert(h_t),
                                np.arange(1 << h_t.n_qubits, dtype=np.int64))
    outside = np.flatnonzero(full == full.max())[:9].astype(np.int64)  # rank == size
    return np.concatenate([s[:m], outside, [SENTINEL] * 3]).astype(np.int64), kinds


# ------------------------------------------------------------- plain vs JAX

def test_xl_blocked_index_matches_jax(force_xl):
    h_t, prog_t, prog_j, spec_t, spec_j = _xl_program()
    s, kinds = _xl_states(h_t, np.random.default_rng(2))
    assert {0, 1, 2} <= set(kinds.tolist())
    ah_t, bh_t = de_t._xl_blocked_idx(prog_t, spec_t, torch.as_tensor(s))
    ah_j, bh_j = de_j._xl_blocked_idx(prog_j, spec_j, jnp.asarray(to_u64(s)))
    np.testing.assert_array_equal(ah_t.numpy(), np.asarray(ah_j))
    np.testing.assert_array_equal(bh_t.numpy(), np.asarray(bh_j))
    assert ah_t.dtype == bh_t.dtype == torch.int64
    tail = slice(len(kinds), None)       # outside the sector, and SENTINEL
    assert bool((ah_t[tail] == prog_t.sa).all() and (bh_t[tail] == prog_t.sb).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_table_scatter_matches_jax(dtype):
    """build_value_table (rank index + the table scatter) against JAX's, with
    live rows outside the sector, stale values behind n_valid, both miss
    values and n_valid as an int and as a 0-d tensor."""
    c = case("H2O")
    spec_t, spec_j = rank_t.RankSpec.for_hilbert(c.h_t), rank_j.RankSpec.for_hilbert(c.h_j)
    rng = np.random.default_rng(8)
    states = np.sort(np.concatenate([rng.choice(c.h_t.basis, 90, replace=False),
                                     [0b111, 0b1, 0b101010]])).astype(np.int64)
    s, la, ph, _ = padded_batch(states, 110, rng)
    la, ph = la.astype(dtype), ph.astype(dtype)
    la[len(states):], ph[len(states):] = 3.0, 2.0
    for miss in (rank_t._MISS, -200.0):
        want = np.asarray(rank_j.build_value_table(
            spec_j, jnp.asarray(to_u64(s)), jnp.asarray(la), jnp.asarray(ph),
            jnp.int32(len(states)), miss_log_amp=miss))
        for n_valid in (len(states), torch.tensor(len(states))):
            got = rank_t.build_value_table(spec_t, torch.as_tensor(s), torch.as_tensor(la),
                                           torch.as_tensor(ph), n_valid, miss_log_amp=miss)
            np.testing.assert_array_equal(got.numpy(), want)
        assert int((got[:, 0] > miss).sum()) == 90


def _engine(engine, c_name="H2O"):
    """(port DeviceTerms, JAX DeviceTerms) of one engine on a molecule."""
    c = case(c_name)
    dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    if engine == "rank":
        dt_t, dt_j = dataclasses.replace(dt_t, dense=None), dataclasses.replace(dt_j, dense=None)
    return c, dt_t, dt_j


ENGINE_TYPES = {"dense": "DenseTerms", "factored": "FactorTerms", "rank": "NoneType"}


def _both(dt_t, dt_j, s, la, ph, n_valid, queries=None):
    """(port, JAX) local_energy on the same buffer, numpy (re, im) each."""
    got = le_t.local_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph),
                            n_valid, queries=None if queries is None else tuple(
                                torch.as_tensor(a) for a in queries))
    want = le_j.local_energy(dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la), jnp.asarray(ph),
                             jnp.int32(n_valid), queries=None if queries is None else (
                                 jnp.asarray(to_u64(queries[0])), jnp.asarray(queries[1]),
                                 jnp.asarray(queries[2])))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("engine", ["dense", "factored", "rank"])
def test_empty_batch_matches_jax(engine, monkeypatch):
    """n_valid = 0: ref is -inf, the grid or table holds nothing, and every
    row's E_loc is its diagonal (its imaginary part 0), in both packages."""
    if engine == "factored":
        for mod in (de_j, de_t):
            monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
    c, dt_t, dt_j = _engine(engine)
    assert type(dt_t.dense).__name__ == type(dt_j.dense).__name__ == ENGINE_TYPES[engine]
    rng = np.random.default_rng(4)
    states = np.sort(rng.choice(c.h_t.basis, 60, replace=False))
    s, la, ph, _ = padded_batch(states, 70, rng)
    (re_t, im_t), (re_j, im_j) = _both(dt_t, dt_j, s, la, ph, 0)
    rows = s != SENTINEL     # the rank engine's SENTINEL rows are garbage in JAX
    np.testing.assert_allclose(re_t[rows], re_j[rows], rtol=0, atol=DIAG_TOL)
    np.testing.assert_array_equal(im_t[rows], 0.0)
    np.testing.assert_allclose(im_j[rows], 0.0, rtol=0, atol=DIAG_TOL)
    diag = le_t.diagonal_energy(dt_t, torch.as_tensor(states)).numpy()
    np.testing.assert_allclose(re_t[:60], diag, rtol=0, atol=DIAG_TOL)


def test_xl_empty_batch_matches_jax(force_xl):
    _, h_t, h_j, t_t, t_j = _space("LiH", 1, 4)
    dt_t = le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(t_j, hilbert=h_j)
    assert type(dt_t.dense).__name__ == "FactorTermsXL"
    s, la, ph, kinds = _mixed_buffer(h_t, 1, np.random.default_rng(6))
    (re_t, im_t), (re_j, im_j) = _both(dt_t, dt_j, s, la, ph, 0)
    np.testing.assert_allclose(re_t, re_j, rtol=0, atol=DIAG_TOL)
    np.testing.assert_allclose(im_t, im_j, rtol=0, atol=DIAG_TOL)
    diag = le_t.diagonal_energy(dt_t, torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(re_t, diag, rtol=0, atol=DIAG_TOL)   # staircase or not


@pytest.mark.parametrize("engine", ["dense", "factored", "rank", "xl"])
def test_float64_model_outputs_match_jax(engine, monkeypatch):
    """A float64 model's log-amps and phases (NAQSConfig(param_dtype="float64")):
    the value grid's and the readout's exp, cos and sin run in float64 before
    the cast to float32, in both packages; with a queries= readout."""
    if engine in ("factored", "xl"):
        for mod in (de_j, de_t):
            monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
            if engine == "xl":
                monkeypatch.setattr(mod, "FACT_SIZE_MAX", 1)
    rng = np.random.default_rng(12)
    if engine == "xl":
        _, h_t, h_j, t_t, t_j = _space("LiH", 1, 4)
        dt_t = le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu")
        dt_j = le_j.DeviceTerms.from_terms(t_j, hilbert=h_j)
        s, la, ph, kinds = _mixed_buffer(h_t, 1, rng)
        m = len(kinds)
    else:
        c, dt_t, dt_j = _engine(engine)
        m = 150
        s, la, ph, _ = padded_batch(np.sort(rng.choice(c.h_t.basis, m, replace=False)), 160,
                                    rng)
    la64 = la.astype(np.float64) + rng.normal(size=len(la)) * 1e-3   # not float32 values
    ph64 = ph.astype(np.float64) + rng.normal(size=len(ph)) * 1e-3
    (re_t, im_t), (re_j, im_j) = _both(dt_t, dt_j, s, la64, ph64, m)
    np.testing.assert_allclose(re_t[:m], re_j[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], im_j[:m], rtol=0, atol=ROW_TOL)
    assert np.abs(im_t[:m]).max() > 1e-4
    rows = np.arange(1, m, 5)
    q = (s[rows], la64[rows], ph64[rows])
    (qr_t, qi_t), (qr_j, qi_j) = _both(dt_t, dt_j, s, la64, ph64, m, queries=q)
    np.testing.assert_allclose(qr_t, qr_j, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(qi_t, qi_j, rtol=0, atol=ROW_TOL)
    np.testing.assert_array_equal(qr_t, re_t[rows])


# ----------------------------------------------- the kernels' arithmetic replayed

def _xl_replay(prog, spec, s):
    """rank_index_kernel's XL mode: the spec-table rank, then the blocked
    maps with C's integer division and remainder of non-negative ints."""
    idx = _kernel_rank(spec, s).astype(np.int64)
    sa_f, sb_f = prog.sa_full, prog.sb_full
    ra = np.minimum(idx // sb_f, sa_f)
    rb = np.where(idx >= sa_f * sb_f, sb_f, idx % sb_f)
    return prog.perm_a.numpy()[ra].astype(np.int64), prog.perm_b.numpy()[rb].astype(np.int64)


def test_rank_index_kernel_replayed_in_numpy(force_xl):
    h_t, prog, _, spec, _ = _xl_program()
    s, _ = _xl_states(h_t, np.random.default_rng(3))
    rng = np.random.default_rng(3)
    s = np.concatenate([s, rng.integers(0, 1 << 62, 200)]).astype(np.int64)
    want = de_t._xl_blocked_idx(prog, spec, torch.as_tensor(s))
    for g, w in zip(_xl_replay(prog, spec, s), want):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(_kernel_rank(spec, s),
                                  rank_t.rank_index(spec, torch.as_tensor(s)).numpy())


def _order_key(v):
    """order_key of csrc/grid_glue.cu on a numpy float32/float64 array: uint64
    keys in the values' order, 0 for none, NaN above every number."""
    bits = 32 if v.dtype == np.float32 else 64
    u = v.view(np.uint32 if bits == 32 else np.uint64).astype(np.uint64)
    sign = np.uint64(1) << np.uint64(bits - 1)
    full = np.uint64((1 << bits) - 1)
    key = np.where(u & sign, ~u & full, u | sign)
    return np.where(np.isnan(v), full, key)


def _from_key(k, dtype):
    bits = 32 if dtype == np.float32 else 64
    if k == 0:
        return dtype(-np.inf)
    sign = 1 << (bits - 1)
    u = k ^ sign if k & sign else ~k & ((1 << bits) - 1)
    return np.array([u], np.uint32 if bits == 32 else np.uint64).view(dtype)[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_order_preserving_max_key_replayed_in_numpy(dtype):
    """The scatter's ref: the largest key of the live rows, decoded, equals
    torch.max over the same rows; no live row gives -inf; a NaN wins."""
    rng = np.random.default_rng(5)
    for v in (rng.normal(size=500).astype(dtype) * 50, np.array([-np.inf, -3.0], dtype),
              -np.abs(rng.normal(size=40)).astype(dtype), np.array([1.0, np.nan, 2.0], dtype)):
        keys = _order_key(v)
        assert np.all(np.argsort(keys[~np.isnan(v)], kind="stable")
                      == np.argsort(v[~np.isnan(v)], kind="stable"))
        got = _from_key(int(keys.max()), dtype)
        want = torch.max(torch.as_tensor(v)).numpy()
        assert (np.isnan(got) and np.isnan(want)) or got == want
    assert _from_key(0, dtype) == -np.inf and int(_order_key(np.array([-np.inf], dtype))[0]) > 0


def _scatter_replay(mode, cells, u, n_valid, sa, sb):
    """scatter_kernel's writes: (U, 2) values u (the plain version's own)
    written at each live row's flat float2 position; every other entry 0."""
    out = np.zeros(((sa + 1) * (sb + 1), 2), np.float32)
    for i in range(min(n_valid, len(u))):
        if mode == "grid":
            idx = int(cells[i])
            if idx >= sa * sb:
                continue
            pos = idx // sb * (sb + 1) + idx % sb
        else:
            ah, bh = int(cells[0][i]), int(cells[1][i])
            if ah >= sa or bh >= sb:
                continue
            pos = ah * (sb + 1) + bh
        out[pos] = u[i]
    return out.reshape(sa + 1, sb + 1, 2)


def _ref_values(cells_live, la, ph, n_valid):
    """The plain chain's (U, 2) unit values and ref, for the replay."""
    live = (torch.arange(la.shape[0]) < n_valid) & cells_live
    ref = torch.max(torch.where(live, la, -torch.inf))
    w = torch.where(live, torch.exp(la - ref), 0.0).to(torch.float32)
    return gg._unit(w, ph).numpy(), ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_cells_replayed_in_numpy(dtype, force_xl):
    """The grid scatter's cell choice: every live row inside the grid writes
    its value at its cell, nothing else is written (dense/factored grid on
    H2O STO-3G with a live row outside the sector; the XL rectangle on LiH)."""
    c = case("H2O")
    spec = rank_t.RankSpec.for_hilbert(c.h_t)
    rng = np.random.default_rng(1)
    s, la, ph, _ = padded_batch(np.sort(rng.choice(c.h_t.basis, 120, replace=False)), 130, rng)
    s[7] = 0b111                         # live, outside the sector
    la, ph = torch.as_tensor(la).to(dtype), torch.as_tensor(ph).to(dtype)
    sa = sb = 21
    idx = rank_t.rank_index(spec, torch.as_tensor(s))
    for n_valid in (120, 0, 33):
        grid, ref = gg.grid_scatter("grid", idx, la, ph, n_valid, sa, sb)
        u, ref_w = _ref_values(idx < sa * sb, la, ph, n_valid)
        assert torch.equal(ref, ref_w)
        np.testing.assert_array_equal(grid.numpy(),
                                      _scatter_replay("grid", idx.numpy(), u, n_valid, sa, sb))

    h_t, prog, _, spec_x, _ = _xl_program()
    s, _, _, kinds = _mixed_buffer(h_t, 1, rng)
    m = len(kinds)
    la = torch.as_tensor(rng.normal(size=len(s))).to(dtype)
    ph = torch.as_tensor(rng.uniform(-3, 3, size=len(s))).to(dtype)
    cells = de_t._xl_blocked_idx(prog, spec_x, torch.as_tensor(s))
    grid, ref = de_t.xl_value_grid(prog, spec_x, torch.as_tensor(s), la, ph, m)
    u, ref_w = _ref_values(torch.ones(len(s), dtype=torch.bool), la, ph, m)
    assert torch.equal(ref, ref_w)
    np.testing.assert_array_equal(grid.numpy(), _scatter_replay(
        "xl", [x.numpy() for x in cells], u, m, prog.sa, prog.sb))


def _readout_replay(mode, num, e_diag, cells, ref, q_la, q_ph, sa, sb, width=None,
                    cells_off=None, q_states=None, diag_yz=None, diag_coeff=None):
    """readout_kernel per row in numpy: the cell and numerator, the diagonal
    (for an XL row outside the staircase the f64 sum in term order), then
    ratio (n0 c + n1 s) and ratio (n1 c - n0 s) as float32 operations, each
    rounded, on torch's ratio, cos and sin."""
    ratio = torch.exp(torch.clamp(ref - q_la, -30.0, 30.0)).to(torch.float32).numpy()
    c = torch.cos(q_ph).to(torch.float32).numpy()
    s = torch.sin(q_ph).to(torch.float32).numpy()
    num, e_diag = num.numpy().reshape(-1, 2), e_diag.numpy()
    u = q_la.shape[0]
    n = np.zeros((u, 2), np.float32)
    ed = np.zeros(u)
    for i in range(u):
        if mode == "xl":
            ah, bh = int(cells[0][i]), int(cells[1][i])
            row = min(ah, sa)
            valid = ah < sa and bh < int(width[row])
            cell = int(cells_off[row]) + bh if valid else num.shape[0]
            if valid:
                n[i] = num[cell]
            ed[i] = e_diag[cell]
            if not valid and diag_yz is not None:
                d = 0.0
                for yz, cf in zip(diag_yz.numpy(), diag_coeff.numpy()):
                    d += -cf if bin(int(q_states[i]) & int(yz) & (2**64 - 1)).count("1") & 1 \
                        else cf
                ed[i] = d
        else:
            idx = int(cells[i])
            if mode == "rows" or idx < sa * sb:
                n[i] = num[i] if mode == "rows" else num[idx % sb * sa + idx // sb]
            ed[i] = e_diag[min(idx, sa * sb)]
    f = np.float32
    re = ratio * (f(n[:, 0] * c) + f(n[:, 1] * s))
    im = ratio * (f(n[:, 1] * c) - f(n[:, 0] * s))
    return ed + re.astype(np.float64), im.astype(np.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["dense", "rows"])
def test_readout_replayed_in_numpy(mode, dtype):
    c = case("H2O")
    dn = de_t.DenseTerms.build(c.terms_t, c.h_t, device="cpu")
    spec = rank_t.RankSpec.for_hilbert(c.h_t)
    rng = np.random.default_rng(11)
    s, la, ph, _ = padded_batch(np.sort(rng.choice(c.h_t.basis, 90, replace=False)), 100, rng)
    s[3] = 0b111
    idx = rank_t.rank_index(spec, torch.as_tensor(s))
    la, ph = torch.as_tensor(la).to(dtype), torch.as_tensor(ph).to(dtype)
    la[5] = -40.0                        # a ratio clipped at e^30
    ref = torch.max(la[:90])
    num = torch.as_tensor(rng.normal(size=(dn.sb, dn.sa, 2)).astype(np.float32)) if \
        mode == "dense" else torch.as_tensor(rng.normal(size=(100, 2)).astype(np.float32))
    got = gg.grid_readout(mode, num, dn.e_diag, idx, ref, la, ph, dn.sa, dn.sb)
    want = _readout_replay(mode, num, dn.e_diag, idx.numpy(), ref, la, ph, dn.sa, dn.sb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_xl_readout_and_diagonal_branch_replayed_in_numpy(dtype, force_xl):
    """The XL readout: the staircase cell, the true diagonal of rows outside
    it (in term order, within DIAG_ATOL of torch.sum's), 0 without terms."""
    _, h_t, _, t_t, _ = _space("LiH", 1, 4)
    dt = le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu")
    prog, spec = dt.dense, dt.rank_spec
    rng = np.random.default_rng(9)
    s, _ = _xl_states(h_t, rng)
    q = torch.as_tensor(s)
    la = torch.as_tensor(rng.normal(size=len(s))).to(dtype)
    ph = torch.as_tensor(rng.uniform(-3, 3, size=len(s))).to(dtype)
    ref = torch.max(la)
    num = torch.as_tensor(rng.normal(size=(prog.n_cells, 2)).astype(np.float32))
    cells = de_t._xl_blocked_idx(prog, spec, q)
    for diag in ((dt.diag_yz, dt.diag_coeff), (None, None)):
        kw = dict(width=prog.width, cells_off=prog.cells_off, q_states=q, diag_yz=diag[0],
                  diag_coeff=diag[1])
        got = gg.grid_readout("xl", num, prog.e_diag, cells, ref, la, ph, prog.sa, prog.sb,
                              **kw)
        want = _readout_replay("xl", num, prog.e_diag, [x.numpy() for x in cells], ref, la, ph,
                               prog.sa, prog.sb, prog.width.numpy(), prog.cells_off.numpy(),
                               s, *diag)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=gg.DIAG_ATOL)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        out = (cells[0] >= prog.sa) | (cells[1] >= prog.width[torch.clamp(cells[0],
                                                                         max=prog.sa)])
        assert bool(out.any())
        if diag[0] is None:
            np.testing.assert_array_equal(got[0].numpy()[out.numpy()],
                                          want[0][out.numpy()])
        else:
            true = le_t.diagonal_energy(dt, q).numpy()
            np.testing.assert_allclose(got[0].numpy()[out.numpy()], true[out.numpy()],
                                       rtol=0, atol=gg.DIAG_ATOL)


# ------------------------------------------------------------ the wrappers

def test_wrappers_check_their_inputs_and_count_no_cpu_launch():
    c = case("H2O")
    spec = rank_t.RankSpec.for_hilbert(c.h_t)
    s = torch.as_tensor(c.h_t.basis[:40])
    la, ph = torch.zeros(40), torch.zeros(40)
    before = (rank_t.rank_index.launches, gg.grid_scatter.launches, gg.grid_readout.launches)
    idx = rank_t.rank_index(spec, s)
    grid, ref = gg.grid_scatter("grid", idx, la, ph, 40, 21, 21)
    dn = de_t.DenseTerms.build(c.terms_t, c.h_t, device="cpu")
    gg.grid_readout("dense", torch.zeros(21, 21, 2), dn.e_diag, idx, ref, la, ph, 21, 21)
    assert (rank_t.rank_index.launches, gg.grid_scatter.launches,
            gg.grid_readout.launches) == before
    with pytest.raises(ValueError, match="states"):
        rank_t.rank_index(spec, s.to(torch.int32))
    with pytest.raises(ValueError, match="mode"):
        gg.grid_scatter("cells", idx, la, ph, 40, 21, 21)
    with pytest.raises(ValueError, match="phase"):
        gg.grid_scatter("grid", idx, la, ph.double(), 40, 21, 21)
    with pytest.raises(ValueError, match="cells"):
        gg.grid_scatter("grid", idx[:5], la, ph, 40, 21, 21)
    with pytest.raises(ValueError, match="ref"):
        gg.grid_readout("dense", torch.zeros(21, 21, 2), dn.e_diag, idx, ref.double(), la, ph,
                        21, 21)
    with pytest.raises(ValueError, match="num"):
        gg.grid_readout("dense", torch.zeros(21, 20, 2), dn.e_diag, idx, ref, la, ph, 21, 21)
    with pytest.raises(ValueError, match="e_diag"):
        gg.grid_readout("rows", torch.zeros(40, 2), dn.e_diag[:-1], idx, ref, la, ph, 21, 21)
    with pytest.raises(ValueError, match="blocked pair"):
        rank_t.rank_index(spec, s[:, None], perm=(torch.zeros(3, dtype=torch.int32),
                                                  torch.zeros(3, dtype=torch.int32)))
