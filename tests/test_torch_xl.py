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
    for field, value in (("ga", prog.ga.long()), ("tiles", prog.tiles[:, :3]),
                         ("pb_idx", prog.pb_idx[:, :-1]), ("cells_off", prog.cells_off[:-1])):
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
