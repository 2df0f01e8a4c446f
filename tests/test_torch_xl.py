"""The port's n_exc-filtered spaces against naqs_tpu's: `Hilbert.n_exc_max`,
`compile_pauli_terms(n_excitations_max=)`, `FactorTermsXL` and its dispatch,
and E_loc through the staircase engine.

Molecules: LiH (Li-H 1.5949 A) and H2O STO-3G, generated by
`naqs_tpu.chem.generate` (`test_torch_support.py`). XL is forced on both
sides by setting `DENSE_SIZE_MAX` and `FACT_SIZE_MAX` to 1 in both packages,
as `tests/test_dense_engine.py::TestFactorXL` does.

Tolerances: Hilbert, term and build fields exactly (integer maps and f32
tables come from the same host arithmetic), the f64 diagonal within 1e-10
Ha (a product per block against the JAX package's term loop); E_loc per row
within the JAX package's own XL bar (rtol 2e-6, atol 2e-6: fp32 numerator
sums in another order); against the float64 oracle 2e-4 Ha; the plain
accumulation against a float64 replay within `grid_tolerance`; the CISD
energy within 5e-6 Ha (`tests/test_dense_engine.py`'s bar).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu as nq
import naqs_tpu_torch as nt
from naqs_tpu.ops import dense_engine as de_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu_torch.hamiltonian import diagonal_energy_np, local_energy_np
from naqs_tpu_torch.ops import dense_engine as de_t
from naqs_tpu_torch.ops import grid_kernels as gk
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops.rank import RankSpec
from naqs_tpu_torch.utils.bits import SENTINEL, np_parity_pm1
from test_torch_support import case, to_u64

ROW_RTOL = ROW_ATOL = 2e-6   # the JAX package's bar between its XL and rank engines
ORACLE_TOL = 2e-4
OPEN_SHELL = ((3, 2),)       # a synthetic open-shell sector on 12 qubits


@pytest.fixture
def force_xl(monkeypatch):
    """Both packages past their DenseTerms and FactorTerms caps."""
    for mod in (de_j, de_t):
        monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
        monkeypatch.setattr(mod, "FACT_SIZE_MAX", 1)


def _space(name, e, t_exc=None):
    """(case, port Hilbert, JAX Hilbert, port terms, JAX terms) of a molecule
    restricted to at most e excitations; the terms keep at most t_exc X/Y
    sites (default e, as the CLI's -n_excitations_max does: 2 keeps the
    one-body hops, 4 every term of a two-body Hamiltonian)."""
    t_exc = e if t_exc is None else t_exc
    c = case(name)
    h_t = nt.Hilbert(n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors, n_exc_max=e)
    h_j = nq.Hilbert(n_qubits=c.h_j.n_qubits, sectors=c.h_j.sectors, n_exc_max=e)
    t_t = nt.compile_pauli_terms(c.mol_t.qubit_hamiltonian, c.mol_t.n_qubits,
                                 n_excitations_max=t_exc)
    t_j = nq.compile_pauli_terms(c.mol_j.qubit_hamiltonian, c.mol_j.n_qubits,
                                 n_excitations_max=t_exc)
    return c, h_t, h_j, t_t, t_j


def _spin_excitations(states, n_shells):
    """(exc_a, exc_b) of packed int64 states: electrons of each spin outside
    that spin's lowest occupied shells."""
    shells = np.arange(n_shells)
    out = []
    for spin in (0, 1):
        bits = (states[:, None] >> (2 * shells + spin)) & 1
        out.append((bits * (shells[None, :] >= bits.sum(1)[:, None])).sum(1))
    return out


# ---------------------------------------------------------------- (a) Hilbert

@pytest.mark.parametrize("e", [1, 2, 3])
@pytest.mark.parametrize("space", ["LiH", "H2O", "open_shell"])
def test_hilbert_matches_jax(space, e):
    if space == "open_shell":
        h_t = nt.Hilbert(n_qubits=12, sectors=OPEN_SHELL, n_exc_max=e)
        h_j = nq.Hilbert(n_qubits=12, sectors=OPEN_SHELL, n_exc_max=e)
        n_qubits, n_el = 12, 5
    else:
        _, h_t, h_j, _, _ = _space(space, e)
        n_qubits, n_el = h_t.n_qubits, sum(h_t.sectors[0])
    full = nt.Hilbert(n_qubits=h_t.n_qubits, sectors=h_t.sectors).basis
    np.testing.assert_array_equal(h_t.basis, h_j.basis.astype(np.int64))
    assert h_t.basis.dtype == np.int64 and 0 < h_t.size == h_j.size < len(full)
    assert h_t.sector_size == h_j.sector_size == len(full)
    np.testing.assert_array_equal(h_t.excitation_count(full),
                                  h_j.excitation_count(full.astype(np.uint64)))
    rng = np.random.default_rng(e)
    probe = np.concatenate([full, rng.integers(0, 1 << n_qubits, 200), [0, (1 << n_qubits) - 1]])
    np.testing.assert_array_equal(h_t.state_to_index(probe),
                                  h_j.state_to_index(probe.astype(np.uint64)))
    np.testing.assert_array_equal(h_t.contains(probe), h_j.contains(probe.astype(np.uint64)))
    assert not h_t.contains(np.array([SENTINEL]))[0]
    idx = rng.integers(0, h_t.size, 50)
    np.testing.assert_array_equal(h_t.index_to_state(idx),
                                  h_j.index_to_state(idx).astype(np.int64))
    for sector in (None, *h_t.sectors, (1, 0)):
        assert h_t.hf_state(sector) == int(h_j.hf_state(sector))
    f_t = nt.Hilbert.full_n_up(n_qubits, n_el, n_exc_max=e)
    f_j = nq.Hilbert.full_n_up(n_qubits, n_el, n_exc_max=e)
    assert f_t.sectors == f_j.sectors and f_t.n_exc_max == f_j.n_exc_max == e
    np.testing.assert_array_equal(f_t.basis, f_j.basis.astype(np.int64))
    with pytest.raises(ValueError):
        nt.Hilbert(n_qubits=12, sectors=((3, 2), (3, 3)), n_exc_max=e)


# ------------------------------------------------------------------ (b) terms

@pytest.mark.parametrize("e", [2, 4])
@pytest.mark.parametrize("name", ["LiH", "H2O"])
def test_compile_pauli_terms_with_an_excitation_cap_matches_jax(name, e):
    _, _, _, t_t, t_j = _space(name, e)
    full = case(name).terms_t
    assert len(t_t.coeff) <= len(full.coeff) and (e == 4 or len(t_t.coeff) < len(full.coeff))
    for f in dataclasses.fields(t_j):
        got, want = getattr(t_t, f.name), getattr(t_j, f.name)
        if f.name == "n_qubits":
            assert got == want
            continue
        want = np.asarray(want)
        assert got.shape == want.shape, f.name
        if want.dtype == np.uint64:
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f.name)
        assert got.dtype == want.dtype or f.name in ("gxy", "gyz"), f.name


# ------------------------------------------------------------------ (c) build

def _assert_program_equal(prog_t, prog_j):
    for f in dataclasses.fields(prog_j):
        got, want = getattr(prog_t, f.name), getattr(prog_j, f.name)
        if f.name.startswith("b_") and f.name != "b_pneed":
            assert len(got) == len(want), f.name
            for g, w in zip(got, want):
                assert g.numpy().dtype == np.asarray(w).dtype, f.name
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
        elif torch.is_tensor(got):
            w = np.asarray(want)
            assert got.numpy().shape == w.shape and got.numpy().dtype == w.dtype, f.name
            if f.name == "e_diag":
                np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-10)
            else:
                np.testing.assert_array_equal(got.numpy(), w, err_msg=f.name)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("name", ["LiH", "H2O"])
def test_xl_build_matches_jax_field_by_field(name):
    _, h_t, h_j, t_t, t_j = _space(name, 2)
    assert de_t.FactorTermsXL.supported(t_t, h_t) and de_j.FactorTermsXL.supported(t_j, h_j)
    prog_t = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    _assert_program_equal(prog_t, de_j.FactorTermsXL.build(t_j, h_j))
    assert prog_t.n_cells == h_t.size == sum(cnt * pw for _, cnt, pw in prog_t.blocks)
    # the kernel's fields: the factor lists are the plain version's, the signs
    # from the word tables are par_a / par_b, n_fact counts the filled slots
    n_fact = prog_t.n_fact.numpy()
    np.testing.assert_array_equal(n_fact, np.bincount(t_t.gxy))
    slots = np.arange(prog_t.fcoeff.shape[1])[None, :]
    assert np.all(prog_t.fcoeff.numpy()[slots >= n_fact[:, None]] == 0)
    for words, ys, par in ((prog_t.alpha_words, prog_t.ya_words, prog_t.par_a),
                           (prog_t.beta_words, prog_t.yb_words, prog_t.par_b)):
        np.testing.assert_array_equal(
            np_parity_pm1(words.numpy()[None, :] & ys.numpy()[:, None]).astype(np.float32),
            par.numpy())
    for pa_row, pb_row, fc in zip(prog_t.b_pa_row, prog_t.b_pb_row, prog_t.b_fc):
        for c, g in enumerate(pa_row.numpy()):
            ms = np.flatnonzero(prog_t.ga.numpy() == g)
            live = np.flatnonzero(fc.numpy()[c].any(axis=1))
            assert set(prog_t.gb.numpy()[ms]) >= set(pb_row.numpy()[c][live])


@pytest.mark.parametrize("name,e", [("LiH", 2), ("H2O", 1), ("H2O", 2)])
def test_xl_tiles_cover_the_staircase_once(name, e):
    """The kernel's blocks: each covers at most XL_TILE_CELLS cells of one
    column (rb fixed) or one row (ra fixed), and together every staircase
    cell exactly once; columns hold at most e // 2 beta excitations."""
    _, h_t, _, t_t, _ = _space(name, e, t_exc=4)
    prog = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    width, off = prog.width.numpy(), prog.cells_off.numpy()
    seen = np.zeros(prog.n_cells, np.int64)
    nb = h_t.sectors[0][1]
    b_exc = np.bitwise_count(prog.beta_words.numpy() & ~((1 << nb) - 1))
    for orient, p, lo, hi in prog.tiles.numpy():
        assert 0 < hi - lo <= gk.XL_TILE_CELLS and orient in (0, 1)
        q = np.arange(lo, hi)
        ra, rb = (q, np.full_like(q, p)) if orient == 0 else (np.full_like(q, p), q)
        assert np.all(rb < width[ra])
        assert np.all((b_exc[rb] <= e // 2) == (orient == 0))
        np.add.at(seen, off[ra] + rb, 1)
    assert np.all(seen == 1)
    assert gk.XL_TILE_CELLS % 96 == 0 and gk.XL_TILE_CELLS // 3 <= 256


# --------------------------------------------------------------- (d) dispatch

def test_dispatch_picks_the_engine_jax_picks(monkeypatch):
    for name in ("LiH", "H2O"):
        _, h_t, h_j, t_t, t_j = _space(name, 2)
        pick = lambda: (type(le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu").dense),
                        type(le_j.DeviceTerms.from_terms(t_j, hilbert=h_j).dense))
        got_t, got_j = pick()                         # filtered and small
        assert got_t.__name__ == got_j.__name__ == "DenseTerms"
        for mod in (de_j, de_t):
            monkeypatch.setattr(mod, "DENSE_SIZE_MAX", 1)
            monkeypatch.setattr(mod, "FACT_SIZE_MAX", 1)
        got_t, got_j = pick()                         # caps forced
        assert got_t.__name__ == got_j.__name__ == "FactorTermsXL"
        c = case(name)                                # unfiltered: no staircase
        dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
        dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
        assert dt_t.dense is None and dt_j.dense is None
        monkeypatch.undo()


# ------------------------------------------------------------- (e) local energy

def _mixed_buffer(h_t, e, rng, extra=7):
    """(states, la, ph, kinds) SENTINEL-padded numpy buffers: staircase states,
    sampled states inside the restricted rectangle but outside the staircase,
    and states outside the rectangle, sorted; kinds 0, 1, 2 per live row."""
    full = nt.Hilbert(n_qubits=h_t.n_qubits, sectors=h_t.sectors).basis
    ea, eb = _spin_excitations(full, h_t.n_shells)
    kind = np.where(ea + eb <= e, 0, np.where((ea <= e) & (eb <= e), 1, 2))
    picks = [rng.choice(full[kind == k], size=min(n, int((kind == k).sum())), replace=False)
             for k, n in ((0, 60), (1, 8), (2, 8))]
    states = np.concatenate(picks)
    order = np.argsort(states)
    states = states[order]
    kinds = np.concatenate([np.full(len(p), k) for k, p in enumerate(picks)])[order]
    m, cap = len(states), len(states) + extra
    s = np.full(cap, SENTINEL, np.int64)
    s[:m] = states
    la = np.zeros(cap, np.float32)
    la[:m] = rng.normal(size=m) - 1.0
    ph = np.zeros(cap, np.float32)
    ph[:m] = rng.uniform(-np.pi, np.pi, size=m)
    return s, la, ph, kinds


@pytest.mark.parametrize("name,e,t_exc", [("LiH", 1, 4), ("LiH", 2, 2), ("H2O", 1, 4),
                                          ("H2O", 2, 4)])
def test_xl_local_energy_matches_jax(force_xl, name, e, t_exc):
    _, h_t, h_j, t_t, t_j = _space(name, e, t_exc)
    dt_t = le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(t_j, hilbert=h_j)
    assert type(dt_t.dense).__name__ == type(dt_j.dense).__name__ == "FactorTermsXL"
    rng = np.random.default_rng(e)
    s, la, ph, kinds = _mixed_buffer(h_t, e, rng)
    m = len(kinds)
    assert (kinds == 1).any() and ((kinds == 2).any() or e == 2)
    args_j = (jnp.asarray(to_u64(s)), jnp.asarray(la), jnp.asarray(ph), jnp.int32(m))
    args_t = (torch.as_tensor(s), torch.as_tensor(la), torch.as_tensor(ph), m)
    for got, want in zip(le_t.local_energy(dt_t, *args_t), le_j.local_energy(dt_j, *args_j)):
        np.testing.assert_allclose(got.numpy()[:m], np.asarray(want)[:m], rtol=ROW_RTOL,
                                   atol=ROW_ATOL)
    e_re, e_im = (x.numpy()[:m] for x in le_t.local_energy(dt_t, *args_t))

    # outside the staircase: the true diagonal and no off-diagonal part
    out = kinds > 0
    np.testing.assert_allclose(e_re[out], diagonal_energy_np(t_t, s[:m][out]), rtol=0,
                               atol=1e-10)
    assert np.all(e_im[out] == 0)
    # inside: the oracle with psi on every sampled state of the rectangle (the
    # rectangle's out-of-staircase states are read as sampled) and psi = 0
    # outside it
    rect = kinds < 2
    psi = np.exp(la[:m].astype(np.float64) + 1j * ph[:m].astype(np.float64))
    e_np = local_energy_np(t_t, s[:m][rect], psi[rect])
    stair = kinds[rect] == 0
    np.testing.assert_allclose(e_re[kinds == 0], e_np.real[stair], rtol=0, atol=ORACLE_TOL)
    np.testing.assert_allclose(e_im[kinds == 0], e_np.imag[stair], rtol=0, atol=ORACLE_TOL)
    assert np.abs(e_re[kinds == 0] - diagonal_energy_np(t_t, s[:m][kinds == 0])).max() > 1e-3

    # queries=: staircase rows, out-of-staircase rows and SENTINEL padding
    rows = np.concatenate([np.flatnonzero(kinds == 0)[::5], np.flatnonzero(out), [m, m + 1]])
    q_t = tuple(torch.as_tensor(a[rows]) for a in (s, la, ph))
    q_j = tuple(jnp.asarray(a) for a in (to_u64(s[rows]), la[rows], ph[rows]))
    got = le_t.local_energy(dt_t, *args_t, queries=q_t)
    want = le_j.local_energy(dt_j, *args_j, queries=q_j)
    live = rows < m
    for g, w, full_row in zip(got, want, (e_re, e_im)):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=ROW_RTOL,
                                   atol=ROW_ATOL)
        np.testing.assert_array_equal(g.numpy()[live], full_row[rows[live]])


def test_xl_value_grid_reads_the_rectangle(force_xl):
    """Every live state inside the rectangle lands on its cell, staircase or
    not; dead rows, SENTINEL rows and states outside it leave the grid's pad
    row and column zero."""
    _, h_t, _, t_t, _ = _space("LiH", 1, t_exc=4)
    prog = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    spec = RankSpec.for_hilbert(h_t)
    s, la, ph, kinds = _mixed_buffer(h_t, 1, np.random.default_rng(4))
    m = len(kinds)
    la[m:], ph[m:] = 0.7, 1.3                 # stale values behind n_valid
    grid, ref = de_t.xl_value_grid(prog, spec, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m)
    assert grid.shape == (prog.sa + 1, prog.sb + 1, 2)
    assert not grid[prog.sa].any() and not grid[:, prog.sb].any()
    assert int((grid[..., 0] ** 2 + grid[..., 1] ** 2 > 0).sum()) == int((kinds < 2).sum())
    assert float(ref) == la[:m].max()
    ah, bh = de_t._xl_blocked_idx(prog, spec, torch.as_tensor(s))
    assert bool((ah[m:] == prog.sa).all() and (bh[m:] == prog.sb).all())
    assert bool(((ah[:m] == prog.sa) | (bh[:m] == prog.sb)).numpy()[kinds == 2].all())


# ---------------------------------------------- (f) plain version vs a replay

def _replay_full_rectangle(prog, grid):
    """The staircase numerator in float64, mask by mask in index order and
    per the kernel's tiles, reading the FULL rectangle (no beta prefix
    slices): T = grid[pa_idx[ga, ra], pb_idx[gb, rb]] with the pad row and
    column for images outside it, the signs from the word tables."""
    g = grid.numpy().astype(np.float64)
    out = np.zeros((prog.n_cells, 2))
    pa_idx, pb_idx = prog.pa_idx.numpy(), prog.pb_idx.numpy()
    aw, bw = prog.alpha_words.numpy(), prog.beta_words.numpy()
    ya, yb = prog.ya_words.numpy(), prog.yb_words.numpy()
    fa, fb, fc = prog.fa_idx.numpy(), prog.fb_idx.numpy(), prog.fcoeff.numpy()
    off = prog.cells_off.numpy()
    for orient, p, lo, hi in prog.tiles.numpy():
        q = np.arange(lo, hi)
        ra, rb = (q, np.full_like(q, p)) if orient == 0 else (np.full_like(q, p), q)
        acc = np.zeros((len(q), 2))
        for k in range(len(prog.ga)):
            h = np.zeros(len(q))
            for r in range(int(prog.n_fact[k])):
                h += (float(fc[k, r]) * np_parity_pm1(aw[ra] & ya[fa[k, r]])
                      * np_parity_pm1(bw[rb] & yb[fb[k, r]]))
            acc += h[:, None] * g[pa_idx[prog.ga[k], ra], pb_idx[prog.gb[k], rb]]
        out[off[ra] + rb] = acc
    return out


@pytest.mark.parametrize("name,e,t_exc", [("LiH", 2, 2), ("LiH", 2, 4), ("H2O", 1, 4),
                                          ("H2O", 2, 4)])
def test_plain_accumulation_equals_a_full_rectangle_replay(name, e, t_exc):
    """The b_pneed slicing of the plain version changes nothing: every beta
    image of a block's staircase cells under a bucket's masks lies inside the
    bucket's prefix or outside the rectangle (then both read zero)."""
    _, h_t, _, t_t, _ = _space(name, e, t_exc)
    prog = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    spec = RankSpec.for_hilbert(h_t)
    s, la, ph, _ = _mixed_buffer(h_t, e, np.random.default_rng(11))
    grid, _ = de_t.xl_value_grid(prog, spec, torch.as_tensor(s), torch.as_tensor(la),
                                 torch.as_tensor(ph), int((s != SENTINEL).sum()))
    for pb_row, fc, pneed in zip(prog.b_pb_row, prog.b_fc, prog.b_pneed):
        live = fc.numpy().any(axis=2)
        for k, (_, _, pw) in enumerate(prog.blocks):
            img = prog.pb_idx.numpy()[pb_row.numpy()[live]][:, :pw]
            assert np.all((img < pneed[k]) | (img == prog.sb))
    want = gk.xl_grid_accumulate(prog, grid)          # a CPU tensor: the plain version
    assert want.shape == (prog.n_cells, 2) and float(want.abs().max()) > 1e-3
    tol = gk.grid_tolerance(prog, grid).numpy()
    got = _replay_full_rectangle(prog, grid)
    diff = np.abs(got - want.numpy())
    assert np.all(diff <= tol), float((diff / tol).max())
    assert np.all(np.abs(want.numpy()) * gk.GRID_RTOL <= tol)


def test_xl_wrapper_checks_its_inputs_and_counts_no_cpu_launch():
    _, h_t, _, t_t, _ = _space("H2O", 2)
    prog = de_t.FactorTermsXL.build(t_t, h_t, device="cpu")
    grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2))
    before = gk.xl_grid_accumulate.launches
    assert gk.xl_grid_accumulate(prog, grid).shape == (prog.n_cells, 2)
    assert gk.xl_grid_accumulate.launches == before
    for bad in (grid.double(), grid[:-1], grid[..., :1]):
        with pytest.raises(ValueError):
            gk.xl_grid_accumulate(prog, bad)
    for field, value in (("prog", prog.prog.long()), ("tiles", prog.tiles[:, :3]),
                         ("pb_idx", prog.pb_idx[:, :-1]), ("cells_off", prog.cells_off[:-1]),
                         ("chunks", prog.chunks[:, :3]),
                         ("n_col_chunks", prog.chunks.shape[0] + 1), ("n_col_chunks", -1)):
        with pytest.raises(ValueError):
            gk.xl_grid_accumulate(dataclasses.replace(prog, **{field: value}), grid)


# ------------------------------------------------------ (g) CISD ground state

@pytest.mark.parametrize("name", ["LiH", "H2O"])
def test_cisd_ground_state_energy(force_xl, name):
    """The whole filtered basis in the buffer with the CISD ground vector's
    amplitudes: <E_loc> under |psi|^2 is the CISD eigenvalue."""
    from scipy.sparse.linalg import eigsh

    from naqs_tpu.hamiltonian import assemble_sparse_hamiltonian_np

    _, h_t, _, t_t, t_j = _space(name, 2)
    basis = h_t.basis
    w, v = eigsh(assemble_sparse_hamiltonian_np(t_j, basis.astype(np.uint64)), k=1, which="SA")
    vec = v[:, 0]
    dt = le_t.DeviceTerms.from_terms(t_t, hilbert=h_t, device="cpu")
    assert type(dt.dense).__name__ == "FactorTermsXL"
    la = np.log(np.abs(vec) + 1e-12).astype(np.float32)
    ph = np.where(vec >= 0, 0.0, np.pi).astype(np.float32)
    e_re, _ = le_t.local_energy(dt, torch.as_tensor(basis), torch.as_tensor(la),
                                torch.as_tensor(ph), len(basis))
    e = float(np.sum(vec ** 2 * e_re.numpy()))
    assert abs(e - w[0]) < 5e-6, (e, w[0])


# ------------------------------------- (h) the kernel's static program and schedule

_progs = {}


def _programs(name, e):
    """(port FactorTermsXL, JAX FactorTermsXL, port Hilbert) at e
    excitations, terms with at most e X/Y sites; cached per process."""
    if (name, e) not in _progs:
        _, h_t, h_j, t_t, t_j = _space(name, e)
        _progs[name, e] = (de_t.FactorTermsXL.build(t_t, h_t, device="cpu"),
                           de_j.FactorTermsXL.build(t_j, h_j), h_t)
    return _progs[name, e]


def _program_runs(prog):
    """Per orientation (columns, rows), the runs of `prog.prog` in chunk
    order: (chunk, row of the fixed spin's map, row of the cells' map, mask,
    factors (n, 4) int32)."""
    pg, ch = prog.prog.numpy(), prog.chunks.numpy()
    runs = ([], [])
    for c, (row, start, masks, g_first) in enumerate(ch):
        off = masks
        for i, (g_q, nf, k, f_off) in enumerate(pg[start:start + masks]):
            assert i + f_off == off   # the factors follow the headers, mask by mask
            runs[int(c >= prog.n_col_chunks)].append(
                (c, row, g_q, k, pg[start + off:start + off + nf]))
            off += nf
        assert 0 < off <= gk.XL_CHUNK_INT4 and g_first == pg[start, 0]
        assert start + off == (ch[c + 1, 1] if c + 1 < len(ch) else len(pg))
    return runs


XL_SPACES = [(n, e) for n in ("LiH", "H2O", "N2") for e in (2, 4)]


@pytest.mark.parametrize("name,e", XL_SPACES)
def test_static_program_expands_to_the_jax_factors(name, e):
    """For every mask, H_k over the rectangle's cells (all of them, or 400
    random ones for N2) summed factor by factor in float64 from the static
    program, its signs by the parity of both words against the cell's, equals
    the same sum of fc * par_a * par_b from the JAX package's bucket fields,
    in both orientations: each term is +-fc, so the sums agree exactly."""
    prog_t, prog_j, _ = _programs(name, e)
    sa, sb = prog_t.sa, prog_t.sb
    rng = np.random.default_rng(7)
    n = min(sa * sb, 400)
    cells = rng.choice(sa * sb, n, replace=False) if n < sa * sb else np.arange(n)
    ra, rb = cells // sb, cells % sb
    par_a, par_b = np.asarray(prog_j.par_a), np.asarray(prog_j.par_b)
    want = {}
    for pa_row, pb_row, fa, fb, fc in zip(prog_j.b_pa_row, prog_j.b_pb_row, prog_j.b_fa,
                                          prog_j.b_fb, prog_j.b_fc):
        pa_row, pb_row, fa, fb, fc = map(np.asarray, (pa_row, pb_row, fa, fb, fc))
        for c, g in enumerate(pa_row):
            for i in np.flatnonzero(fc[c].any(axis=1)):
                h = np.zeros(n)
                for r in range(fc.shape[2]):
                    h += (np.float64(fc[c, i, r]) * par_a[fa[c, i, r], ra].astype(np.float64)
                          * par_b[fb[c, i, r], rb])
                want[int(g), int(pb_row[c, i])] = h
    aw, bw = prog_t.alpha_words.numpy(), prog_t.beta_words.numpy()
    for orient, runs in enumerate(_program_runs(prog_t)):
        cell_w, fix_w = (aw[ra], bw[rb]) if orient == 0 else (bw[rb], aw[ra])
        got = {}
        for _, row, g_q, _, f in runs:
            coef = f[:, 2].copy().view(np.float32).astype(np.float64)
            h = np.zeros(n)
            for r in range(len(f)):
                h += coef[r] * np_parity_pm1((cell_w & f[r, 0]) ^ (fix_w & f[r, 1]))
            got[(int(g_q), int(row)) if orient == 0 else (int(row), int(g_q))] = h
        assert got.keys() == want.keys()
        for key, h in want.items():
            np.testing.assert_array_equal(got[key], h, err_msg=str(key))


@pytest.mark.parametrize("name,e", XL_SPACES)
def test_static_program_orders_each_orientation(name, e):
    """Each orientation lists every mask once (a permutation of the masks),
    ordered by the row of the fixed spin's image map (gb for columns, ga for
    rows) and then by mask; a chunk holds masks of one row; each header's
    row of the cells' map is the mask's, and its factors are the mask's
    slots in order."""
    prog, _, _ = _programs(name, e)
    ga, gb = prog.ga.numpy(), prog.gb.numpy()
    fa, fb, fc = prog.fa_idx.numpy(), prog.fb_idx.numpy(), prog.fcoeff.numpy()
    ya, yb = prog.ya_words.numpy(), prog.yb_words.numpy()
    for orient, runs in enumerate(_program_runs(prog)):
        g_fix, g_cell = (gb, ga) if orient == 0 else (ga, gb)
        ks = np.array([k for _, _, _, k, _ in runs])
        np.testing.assert_array_equal(np.sort(ks), np.arange(len(ga)))
        np.testing.assert_array_equal(ks, np.lexsort((np.arange(len(ga)), g_fix)))
        for c, row, g_q, k, f in runs:
            assert row == g_fix[k] and g_q == g_cell[k] and len(f) == prog.n_fact[k]
            y_cell, y_fix = (ya[fa[k]], yb[fb[k]]) if orient == 0 else (yb[fb[k]], ya[fa[k]])
            np.testing.assert_array_equal(f[:, 0], y_cell[:len(f)])
            np.testing.assert_array_equal(f[:, 1], y_fix[:len(f)])
            np.testing.assert_array_equal(f[:, 2].copy().view(np.float32), fc[k, :len(f)])
            assert not f[:, 3].any()
    assert prog.chunks.numpy()[:prog.n_col_chunks, 0].tolist() == sorted(
        prog.chunks.numpy()[:prog.n_col_chunks, 0].tolist())


def _sampled_grid(name, e, seed):
    """A sampled value grid of the rectangle with staircase states, states of
    the rectangle outside the staircase and states outside it, SENTINEL rows
    and stale values past n_valid."""
    prog, _, h_t = _programs(name, e)
    s, la, ph, kinds = _mixed_buffer(h_t, e, np.random.default_rng(seed))
    m = len(kinds)
    la[m:], ph[m:] = 0.7, 1.3
    grid, _ = de_t.xl_value_grid(prog, RankSpec.for_hilbert(h_t), torch.as_tensor(s),
                                 torch.as_tensor(la), torch.as_tensor(ph), m)
    return prog, grid, kinds


def _unpack(words, n):
    """(R, W) int32 bitmap rows -> (R, n) bool, bit c of word w = column 32 w + c."""
    u = words.numpy().view(np.uint32)
    return ((u[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(len(u), -1)[:, :n] > 0


@pytest.mark.parametrize("name,e", XL_SPACES)
def test_occupancy_bitmaps_are_the_set_cells(name, e):
    """The plain build of the kernel's first phase: bits_a is grid != 0 (either
    part), bits_b its transpose, both padded to 16-byte rows with clear bits;
    the pad row and column (where SENTINEL rows, dead rows and states outside
    the rectangle land) are clear; any_a / any_b flag the rows that are not."""
    prog, grid, kinds = _sampled_grid(name, e, 12)
    sa, sb = prog.sa, prog.sb
    bits_a, bits_b, any_a, any_b = gk.xl_occupancy_ref(grid)
    occ = (grid != 0).any(-1).numpy()
    assert occ.sum() == (kinds < 2).sum()   # every live state inside the rectangle, once
    for n in (sa + 1, sb + 1):   # the fewest whole 16-byte pieces that hold n bits
        words = gk._xl_row_words(n)
        assert words % 4 == 0 and words * 32 >= n > (words - 4) * 32
    assert bits_a.shape == (sa + 1, gk._xl_row_words(sb + 1)) and bits_a.dtype == torch.int32
    assert bits_b.shape == (sb + 1, gk._xl_row_words(sa + 1)) and bits_b.dtype == torch.int32
    full_a, full_b = _unpack(bits_a, bits_a.shape[1] * 32), _unpack(bits_b, bits_b.shape[1] * 32)
    np.testing.assert_array_equal(full_a[:, :sb + 1], occ)
    np.testing.assert_array_equal(full_b[:, :sa + 1], occ.T)
    assert not full_a[:, sb + 1:].any() and not full_b[:, sa + 1:].any()
    assert not full_a[sa].any() and not full_a[:, sb].any()
    assert not full_b[sb].any() and not full_b[:, sa].any()
    np.testing.assert_array_equal(any_a.numpy(), occ.any(1))
    np.testing.assert_array_equal(any_b.numpy(), occ.any(0))


@pytest.mark.parametrize("name,e", XL_SPACES)
def test_flip_maps_are_their_own_inverse(name, e):
    """What the kernel's listing of a row's set cells rests on: for every
    flip, pa_idx[g, pa_idx[g, ra]] = ra wherever the image lies in the
    rectangle (and no other cell maps there); the same for pb_idx."""
    prog, _, _ = _programs(name, e)
    for idx, s in ((prog.pa_idx.numpy(), prog.sa), (prog.pb_idx.numpy(), prog.sb)):
        for row in idx:
            ok = row < s
            np.testing.assert_array_equal(row[row[ok]], np.flatnonzero(ok))


def _replay_kernel(prog, grid, list_max=gk.XL_LIST_MAX):
    """The XL kernel's schedule in numpy (float64 sums): per tile, the chunks
    of its orientation whose fixed image's bitmap row is not clear, each
    either listing the row's set cells and mapping them back through the
    mask's flip (at most list_max and no pad cell) or probing the tile's
    cells;
    H from the static program. Returns (sums, pairs run, pairs listed)."""
    bits_a, bits_b, any_a, any_b = gk.xl_occupancy_ref(grid)
    g = grid.numpy().astype(np.float64)
    pg, ch = prog.prog.numpy(), prog.chunks.numpy()
    pa, pb = prog.pa_idx.numpy(), prog.pb_idx.numpy()
    aw, bw = prog.alpha_words.numpy(), prog.beta_words.numpy()
    sa, sb = prog.sa, prog.sb
    out = np.zeros((prog.n_cells, 2))
    n_pairs = n_listed = 0
    for orient, p, lo, hi in prog.tiles.numpy():
        column = orient == 0
        sq, q_idx, q_w = (sa, pa, aw) if column else (sb, pb, bw)
        p_idx, pw = (pb, bw[p]) if column else (pa, aw[p])
        bits = _unpack(bits_b if column else bits_a, sq + 1)
        anyf = (any_b if column else any_a).numpy()
        acc = np.zeros((hi - lo, 2))
        for c in range(*((0, prog.n_col_chunks) if column else (prog.n_col_chunks, len(ch)))):
            row, start, masks, _ = ch[c]
            img = p_idx[row, p]
            if not anyf[img]:
                continue
            set_q = np.flatnonzero(bits[img])
            listed = len(set_q) <= list_max and sq not in set_q
            for i, (g_q, nf, _, f_off) in enumerate(pg[start:start + masks]):
                if listed:
                    t = q_idx[g_q, set_q]
                    hit = (t >= lo) & (t < hi)
                    cells, qi = t[hit] - lo, set_q[hit]
                    n_listed += len(cells)
                else:
                    qi_all = q_idx[g_q, lo:hi]
                    cells = np.flatnonzero(bits[img, qi_all])
                    qi = qi_all[cells]
                f = pg[start + i + f_off:start + i + f_off + nf]
                coef = f[:, 2].copy().view(np.float32).astype(np.float64)
                cw = q_w[lo + cells]
                h = (coef[None, :] * np_parity_pm1((cw[:, None] & f[None, :, 0])
                                                   ^ (pw & f[None, :, 1]))).sum(1)
                acc[cells] += h[:, None] * (g[qi, img] if column else g[img, qi])
                n_pairs += len(cells)
        q = np.arange(lo, hi)
        ra, rb = (q, np.full_like(q, p)) if column else (np.full_like(q, p), q)
        out[prog.cells_off.numpy()[ra] + rb] = acc
    return out, n_pairs, n_listed


def _fill(prog, grid, fill):
    """Test grids beside the sampled one: all zero; one set cell (a staircase
    cell near the Hartree-Fock corner); one cell that many masks reach
    together with the sampled ones; every staircase cell set; every cell of
    the rectangle set."""
    if fill == "sampled":
        return grid
    if fill == "zero":
        return torch.zeros_like(grid)
    if fill == "one":
        out = torch.zeros_like(grid)
        out[1, 0] = torch.tensor([0.6, -0.8])
        return out
    if fill == "crowded":   # the HF cell: every single and double flip reaches it
        out = grid.clone()
        out[0, 0] = torch.tensor([1.0, 0.25])
        return out
    gen = torch.Generator().manual_seed(3)
    out = torch.zeros_like(grid)
    if fill == "staircase":   # the whole filtered basis, as exact E_loc over it sets it
        in_stair = torch.arange(prog.sb)[None, :] < prog.width[:-1, None]
        out[:-1, :-1][in_stair] = torch.rand((prog.n_cells, 2), generator=gen) - 0.5
        return out
    out[:-1, :-1] = torch.rand((prog.sa, prog.sb, 2), generator=gen) - 0.5
    return out


@pytest.mark.parametrize("fill", ["sampled", "zero", "one", "crowded", "staircase", "full"])
@pytest.mark.parametrize("name,e", [("H2O", 2), ("H2O", 4), ("N2", 2)])
def test_kernel_schedule_replay_matches_plain(name, e, fill):
    """The kernel's schedule replayed in numpy (tiles, chunks of non-empty
    rows, listed or probed set cells, H from the static program) gives the
    plain version's sums within grid_tolerance; exactly zero on the zero
    grid. The sampled grids run every row listed; rows of more set cells
    than XL_LIST_MAX are probed."""
    prog, grid, _ = _sampled_grid(name, e, 13)
    grid = _fill(prog, grid, fill)
    got, n_pairs, n_listed = _replay_kernel(prog, grid)
    want = gk.xl_grid_accumulate(prog, grid).numpy()
    tol = gk.grid_tolerance(prog, grid).numpy()
    assert np.all(np.abs(got - want) <= tol), float((np.abs(got - want) / tol).max())
    if fill == "zero":
        assert n_pairs == 0 and not want.any() and not got.any()
    else:
        assert n_pairs > 0 and np.abs(want).max() > 1e-3
    if fill in ("sampled", "one"):
        assert n_listed == n_pairs
    if fill == "full" and min(prog.sa, prog.sb) > gk.XL_LIST_MAX:   # rows too full to list
        assert n_listed == 0


@pytest.mark.parametrize("fill", ["sampled", "staircase", "full"])
@pytest.mark.parametrize("name,e", [("H2O", 4), ("N2", 2)])
def test_kernel_schedule_replay_probes_fuller_rows(name, e, fill):
    """The replay with rows of more than 2 set cells probed, as the kernel
    probes rows of more than XL_LIST_MAX on larger grids (every row of
    Li2O's staircase grid): the same sums; the fully set grid probes every
    row and lists nothing."""
    prog, grid, _ = _sampled_grid(name, e, 13)
    grid = _fill(prog, grid, fill)
    got, n_pairs, n_listed = _replay_kernel(prog, grid, list_max=2)
    want = gk.xl_grid_accumulate(prog, grid).numpy()
    tol = gk.grid_tolerance(prog, grid).numpy()
    assert np.all(np.abs(got - want) <= tol), float((np.abs(got - want) / tol).max())
    assert n_pairs > 0 and n_listed < n_pairs
    if fill == "full":
        assert n_listed == 0
