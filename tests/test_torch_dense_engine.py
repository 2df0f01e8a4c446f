"""Port grid E_loc engines (ops/dense_engine.py) against naqs_tpu's.

Tolerances: the builds are compared field by field, integer maps and f32
tables exactly (same host arithmetic) and the f64 diagonal within 1e-10 Ha.
E_loc per row within 2e-5 Ha of the JAX engine on the same buffer (the fp32
numerator sums run in another order: torch's reductions against XLA's) and
within 2e-4 Ha of the float64 host oracle `local_energy_np` (fp32
amplitudes and sums; the bar of tests/test_dense_engine.py). The factored
engine's numerator at the listed cells (`factored_cells_accumulate`) against
the whole-grid plain version read at the same cells within 2e-6 (fp32 sums
in another order), and exactly 0 on every row that lists no cell. The H2O 6-31G
case through the default dispatch (FactorTerms on both sides, 1,656,369
cells) is `test_torch_local_energy.py::test_local_energy_matches_jax_engines`,
so that the JAX engine's minute on this grid runs once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naqs_tpu.ops import dense_engine as de_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu.ops.rank import RankSpec as RankSpecJ
from naqs_tpu_torch.hamiltonian import diagonal_energy_np, local_energy_np
from naqs_tpu_torch.ops import dense_engine as de_t
from naqs_tpu_torch.ops import grid_kernels as gk
from naqs_tpu_torch.ops import local_energy as le_t
from naqs_tpu_torch.ops.rank import RankSpec
from naqs_tpu_torch.utils.bits import SENTINEL, np_parity_pm1
from test_torch_support import case, padded_batch, to_u64

ROW_TOL = 2e-5      # Ha, against the JAX engine
ORACLE_TOL = 2e-4   # Ha, against float64 numpy

ENGINES = {
    "dense": (de_t.DenseTerms, de_t.dense_local_energy, gk.dense_grid_accumulate,
              de_j.DenseTerms, de_j.dense_local_energy),
    "factored": (de_t.FactorTerms, de_t.factored_local_energy, gk.factored_cells_accumulate,
                 de_j.FactorTerms, de_j.factored_local_energy),
}


def _accumulate(engine, prog, grid, idx, n):
    """The engine's kernel wrapper on the CPU: the dense program's (Sb, Sa, 2)
    numerator grid, the factored program's (U, 2) rows of the first n of idx."""
    if engine == "dense":
        return gk.dense_grid_accumulate(prog, grid)
    return gk.factored_cells_accumulate(prog, grid, idx, torch.tensor(n))


def _tolerance(engine, prog, grid, idx, n):
    return gk.grid_tolerance(prog, grid) if engine == "dense" else \
        gk.grid_tolerance(prog, grid, idx, torch.tensor(n))


def _programs(engine, name):
    """(port program, JAX program, port RankSpec, JAX RankSpec) of a molecule."""
    c = case(name)
    cls_t, _, _, cls_j, _ = ENGINES[engine]
    assert cls_t.supported(c.terms_t, c.h_t) and cls_j.supported(c.terms_j, c.h_j)
    return (cls_t.build(c.terms_t, c.h_t, device="cpu"), cls_j.build(c.terms_j, c.h_j),
            RankSpec.for_hilbert(c.h_t), RankSpecJ.for_hilbert(c.h_j))


def _buffer(c, m, cap, seed, full=False):
    """(states, la, ph) SENTINEL-padded numpy buffers with m live rows: a
    random subset of the basis, or (full) the whole basis."""
    rng = np.random.default_rng(seed)
    basis = c.h_t.basis
    states = basis if full else np.sort(rng.choice(basis, size=m, replace=False))
    s, la, ph, _ = padded_batch(states, cap, rng)
    la[:m] = rng.normal(size=m) - 1.0
    return s, la, ph


def _port(fn, *arrays, **kw):
    e_re, e_im = fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                      for a in arrays), **kw)
    return e_re.numpy(), e_im.numpy()


@pytest.mark.parametrize("name", ["H2", "H2O"])
@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_build_matches_jax_field_by_field(engine, name):
    prog_t, prog_j, _, _ = _programs(engine, name)
    assert (prog_t.sa, prog_t.sb) == (prog_j.sa, prog_j.sb)
    fields = [f.name for f in dataclasses.fields(prog_j) if f.name not in ("sa", "sb")]
    assert set(fields) <= {f.name for f in dataclasses.fields(prog_t)}
    for f in fields:
        got, want = getattr(prog_t, f).numpy(), np.asarray(getattr(prog_j, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f == "e_diag":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    if engine == "factored":
        # the kernel's factor count: the filled slots, and nothing behind them
        n_fact = prog_t.n_fact.numpy()
        slots = np.arange(prog_t.fcoeff.shape[1])[None, :]
        assert np.all(prog_t.fcoeff.numpy()[slots >= n_fact[:, None]] == 0)
        c = case(name)
        np.testing.assert_array_equal(n_fact[: len(c.terms_t.xy_unique)],
                                      np.bincount(c.terms_t.gxy))
        # the kernel's signs, computed from the word tables, are par_a and par_b
        for words, y, par in ((prog_t.alpha_words, prog_t.ya_words, prog_t.par_a),
                              (prog_t.beta_words, prog_t.yb_words, prog_t.par_b)):
            np.testing.assert_array_equal(
                np_parity_pm1(words.numpy()[None, :] & y.numpy()[:, None]).astype(np.float32),
                par.numpy())
        # the row map's parts, and the image maps transposed into 16-byte rows
        sa, sb = prog_t.sa, prog_t.sb
        ga, gb, pb_idx = prog_t.ga.numpy(), prog_t.gb.numpy(), prog_t.pb_idx.numpy()
        kxy = len(c.terms_t.xy_unique)
        np.testing.assert_array_equal(ga[:kxy, None] * (sb + 1) + pb_idx[gb[:kxy]],
                                      prog_t.row_map.numpy()[:kxy])
        assert not ga[kxy:].any() and not gb[kxy:].any()
        for idx, t, n in ((prog_t.pa_idx, prog_t.pa_t, sa), (prog_t.pb_idx, prog_t.pb_t, sb)):
            k = idx.shape[0]
            assert t.shape == (n, -(-k // 4) * 4)
            np.testing.assert_array_equal(t.numpy()[:, :k], idx.numpy().T)
            assert np.all(t.numpy()[:, k:] == n)
        # the packed slots: mask by mask, the factor lists' words and coefficients
        off, slots = prog_t.slot_off.numpy(), prog_t.slots.numpy()
        np.testing.assert_array_equal(np.diff(off), n_fact)
        fa, fb, fc = prog_t.fa_idx.numpy(), prog_t.fb_idx.numpy(), prog_t.fcoeff.numpy()
        for k in range(len(n_fact)):
            sl = slots[off[k]:off[k + 1]]
            np.testing.assert_array_equal(sl[:, 0], prog_t.ya_words.numpy()[fa[k, :n_fact[k]]])
            np.testing.assert_array_equal(sl[:, 1], prog_t.yb_words.numpy()[fb[k, :n_fact[k]]])
            np.testing.assert_array_equal(sl[:, 2].view(np.float32), fc[k, :n_fact[k]])
            assert np.all(sl[:, 3] == 0)


def test_perm_map_matches_the_dict_walk():
    """The vectorised image map against the JAX package's per-state walk."""
    packed = de_t._colex_ranks(7, 3)
    np.testing.assert_array_equal(packed, de_j._colex_ranks(7, 3))
    for flip in (0, 0b11, 0b1010000, 0b1, 0b1111):
        np.testing.assert_array_equal(de_t._perm_map(packed, flip, invalid=len(packed)),
                                      de_j._perm_map(packed, flip, invalid=len(packed)))


@pytest.mark.parametrize("full", [False, True], ids=["subset", "full_space"])
@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_grid_engine_matches_jax_and_oracle(engine, full):
    """One shared SENTINEL-padded buffer through the port's engine, the JAX
    engine and the float64 host oracle; then a queries= readout."""
    c = case("H2O")
    prog_t, prog_j, spec_t, spec_j = _programs(engine, "H2O")
    _, fn_t, _, _, fn_j = ENGINES[engine]
    m = c.h_t.size if full else 250
    cap = m + 12
    s, la, ph = _buffer(c, m, cap, 7, full)

    re_t, im_t = _port(fn_t, prog_t, spec_t, s, la, ph, m)
    re_j, im_j = fn_j(prog_j, spec_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                      jnp.asarray(ph), jnp.int32(m))
    np.testing.assert_allclose(re_t[:m], np.asarray(re_j)[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], np.asarray(im_j)[:m], rtol=0, atol=ROW_TOL)

    psi = np.exp(la[:m].astype(np.float64) + 1j * ph[:m].astype(np.float64))
    e_np = local_energy_np(c.terms_t, s[:m], psi)
    np.testing.assert_allclose(re_t[:m], e_np.real, rtol=0, atol=ORACLE_TOL)
    np.testing.assert_allclose(im_t[:m], e_np.imag, rtol=0, atol=ORACLE_TOL)
    assert np.abs(re_t[:m] - diagonal_energy_np(c.terms_t, s[:m])).max() > 1e-3

    rows = np.arange(3, m, 7)
    q = tuple(torch.as_tensor(a[rows]) for a in (s, la, ph))
    q_re, q_im = _port(fn_t, prog_t, spec_t, s, la, ph, m, queries=q)
    np.testing.assert_array_equal(q_re, re_t[rows])
    np.testing.assert_array_equal(q_im, im_t[rows])
    qj = tuple(jnp.asarray(a) for a in (to_u64(s[rows]), la[rows], ph[rows]))
    j_re, _ = fn_j(prog_j, spec_j, jnp.asarray(to_u64(s)), jnp.asarray(la), jnp.asarray(ph),
                   jnp.int32(m), queries=qj)
    np.testing.assert_allclose(q_re, np.asarray(j_re), rtol=0, atol=ROW_TOL)


@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_rectangular_sector_matches_jax_and_oracle(engine):
    """Sa != Sb (sector (4, 2) of H2O STO-3G: a 35 x 21 grid), so that no
    exchange of the two spins' sizes or maps goes unseen; with the numpy
    replay of the kernels' index arithmetic on the same grid."""
    import naqs_tpu as nq
    import naqs_tpu_torch as nt

    c = case("H2O")
    sectors = ((4, 2),)
    h_t, h_j = nt.Hilbert(n_qubits=14, sectors=sectors), nq.Hilbert(n_qubits=14,
                                                                   sectors=sectors)
    cls_t, fn_t, wrapper, cls_j, fn_j = ENGINES[engine]
    prog_t, prog_j = cls_t.build(c.terms_t, h_t, device="cpu"), cls_j.build(c.terms_j, h_j)
    assert (prog_t.sa, prog_t.sb) == (prog_j.sa, prog_j.sb) == (35, 21)
    spec_t, spec_j = RankSpec.for_hilbert(h_t), RankSpecJ.for_hilbert(h_j)
    m, cap = 300, 320
    rng = np.random.default_rng(13)
    s, la, ph, _ = padded_batch(np.sort(rng.choice(h_t.basis, size=m, replace=False)), cap,
                                rng)
    re_t, im_t = _port(fn_t, prog_t, spec_t, s, la, ph, m)
    re_j, im_j = fn_j(prog_j, spec_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                      jnp.asarray(ph), jnp.int32(m))
    np.testing.assert_allclose(re_t[:m], np.asarray(re_j)[:m], rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t[:m], np.asarray(im_j)[:m], rtol=0, atol=ROW_TOL)
    psi = np.exp(la[:m].astype(np.float64) + 1j * ph[:m].astype(np.float64))
    e_np = local_energy_np(c.terms_t, s[:m], psi)
    np.testing.assert_allclose(re_t[:m], e_np.real, rtol=0, atol=ORACLE_TOL)
    np.testing.assert_allclose(im_t[:m], e_np.imag, rtol=0, atol=ORACLE_TOL)
    grid, _, idx = de_t.value_grid(spec_t, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m, prog_t.sa, prog_t.sb)
    want = _accumulate(engine, prog_t, grid, idx, m).numpy()
    assert np.abs(want).max() > 1e-3
    if engine == "dense":
        assert want.shape == (21, 35, 2)
        np.testing.assert_allclose(_replay_kernel(prog_t, grid), want, rtol=0, atol=2e-6)
    else:
        assert want.shape == (cap, 2)
        np.testing.assert_allclose(_replay_cells_kernel(prog_t, grid, idx, m), want, rtol=0,
                                   atol=2e-6)


def test_host_oracle_matches_jax_oracle():
    from naqs_tpu.hamiltonian import local_energy_np as local_energy_np_j

    c = case("H2O")
    s, la, ph = _buffer(c, 120, 120, 3)
    psi = np.exp(la.astype(np.float64) + 1j * ph.astype(np.float64))
    psi[5] = 0.0   # a zero-amplitude row has ratio 0 by definition
    np.testing.assert_allclose(local_energy_np(c.terms_t, s, psi),
                               local_energy_np_j(c.terms_j, s.astype(np.uint64), psi),
                               rtol=0, atol=1e-12)


def test_pad_row_and_column_stay_zero():
    """SENTINEL rows, dead rows with stale values and a live row outside the
    sector all leave the grid's pad row and column zero."""
    c = case("H2O")
    spec = RankSpec.for_hilbert(c.h_t)
    sa = sb = 21
    m, cap = 40, 64
    s, la, ph = _buffer(c, m, cap, 11)
    la[m:], ph[m:] = 0.7, 1.3            # stale values behind n_valid
    s[m] = np.setdiff1d(c.h_t.basis, s[:m])[0]   # a dead row that is a real, unsampled state
    s[3] = 0b111                         # a live row outside the sector
    grid, ref, idx = de_t.value_grid(spec, torch.as_tensor(s), torch.as_tensor(la),
                                     torch.as_tensor(ph), m, sa, sb)
    assert grid.shape == (sa + 1, sb + 1, 2) and grid.dtype == torch.float32
    assert not grid[sa].any() and not grid[:, sb].any()
    assert int(idx[3]) == int(idx[-1]) == sa * sb and s[-1] == SENTINEL
    live = np.delete(np.arange(m), 3)
    assert int((grid[..., 0] ** 2 + grid[..., 1] ** 2 > 0).sum()) == len(live)
    assert float(ref) == la[live].max()
    assert float((grid[..., 0] ** 2 + grid[..., 1] ** 2).max()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("name,engine", [("H2", "DenseTerms"), ("H2O", "DenseTerms"),
                                         ("H2O_6-31G", "FactorTerms")])
def test_from_terms_picks_the_engine_jax_picks(name, engine):
    c = case(name)
    dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
    assert type(dt_t.dense).__name__ == type(dt_j.dense).__name__ == engine
    assert dataclasses.replace(dt_t, dense=None).dense is None
    # no grid program without a Hilbert space, nor over several sectors
    assert le_t.DeviceTerms.from_terms(c.terms_t, device="cpu").dense is None
    if name == "H2O":
        import naqs_tpu_torch as nt

        multi = nt.Hilbert(n_qubits=14, sectors=((5, 3), (4, 4), (3, 5)))
        assert le_t.DeviceTerms.from_terms(c.terms_t, hilbert=multi, device="cpu").dense is None


@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_wrappers_check_their_inputs_and_count_no_cpu_launch(engine):
    prog_t, _, spec_t, _ = _programs(engine, "H2O")
    wrapper = ENGINES[engine][2]
    grid = torch.zeros((prog_t.sa + 1, prog_t.sb + 1, 2))
    before = wrapper.launches
    if engine == "dense":
        call = wrapper
        field = "row_map"
        assert wrapper(prog_t, grid).shape == (prog_t.sb, prog_t.sa, 2)
    else:
        idx, n = torch.arange(7, dtype=torch.int64), torch.tensor(5)
        call = lambda prog, g: wrapper(prog, g, idx, n)
        field = "pa_t"
        assert wrapper(prog_t, grid, idx, n).shape == (7, 2)
        for bad in ((idx.int(), n), (idx, n.int()), (idx, torch.tensor([5])),
                    (idx[None], n), (idx, 5)):
            with pytest.raises(ValueError):
                wrapper(prog_t, grid, *bad)
        with pytest.raises(ValueError):
            call(dataclasses.replace(prog_t, slots=prog_t.slots[:, :3]), grid)
    assert wrapper.launches == before
    for bad in (grid.double(), grid[:-1], grid[..., :1]):
        with pytest.raises(ValueError):
            call(prog_t, bad)
    with pytest.raises(ValueError):
        call(dataclasses.replace(prog_t, **{field: getattr(prog_t, field).long()}), grid)
    with pytest.raises(ValueError):
        call(dataclasses.replace(prog_t, **{field: getattr(prog_t, field)[:, :-1]}), grid)


def test_grid_tolerance_bounds_the_sums():
    """The tolerance's magnitude run bounds |sum_k H_k T_k| cell by cell."""
    c = case("H2O")
    for engine in ENGINES:
        prog_t, _, spec_t, _ = _programs(engine, "H2O")
        s, la, ph = _buffer(c, 200, 208, 5)
        grid, _, idx = de_t.value_grid(spec_t, torch.as_tensor(s), torch.as_tensor(la),
                                       torch.as_tensor(ph), 200, prog_t.sa, prog_t.sb)
        n = _accumulate(engine, prog_t, grid, idx, 200)
        tol = _tolerance(engine, prog_t, grid, idx, 200)
        assert tol.shape == n.shape
        assert bool((n.abs() * gk.GRID_RTOL <= tol).all()) and float(n.abs().max()) > 1e-3


def _replay_kernel(prog, grid, n_ranges=None):
    """The dense kernel's index arithmetic (csrc/grid_engine.cu) in numpy: the
    transposed grid, (ka, pb) decoded from row_map, masks skipped on an
    invalid beta image, and the zero pad cell read for an invalid alpha
    image; in float64 over all masks. With n_ranges, the kernel's partition
    instead: range s holds masks [s K // S, (s + 1) K // S), each range is
    summed in float32 in mask order, then the partials in range order."""
    sa, sb = prog.sa, prog.sb
    grid_t = grid.numpy().transpose(1, 0, 2)             # (Sb+1, Sa+1, 2)
    idx = prog.r1_idx.numpy()
    row_map = prog.row_map.numpy()
    n_masks = row_map.shape[0]
    bounds = [0, n_masks] if n_ranges is None else \
        [s * n_masks // n_ranges for s in range(n_ranges + 1)]
    dtype = np.float64 if n_ranges is None else np.float32
    partials = []
    for k_begin, k_end in zip(bounds[:-1], bounds[1:]):
        acc = np.zeros((sb, sa, 2), dtype)
        for k in range(k_begin, k_end):
            ka, pb = row_map[k] // (sb + 1), row_map[k] % (sb + 1)
            h = prog.h_dense.numpy()[k].astype(dtype)
            for rb in np.flatnonzero(pb < sb):
                acc[rb] += h[rb][:, None] * grid_t[pb[rb], idx[ka[rb]]].astype(dtype)
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


def _popcount_sign(words):
    """(-1)^popcount of int32 words, as float32 +-1."""
    bits = np.unpackbits(np.asarray(words, np.int32).reshape(1).view(np.uint8))
    return np.float32(1.0) - np.float32(2.0) * np.float32(bits.sum() % 2)


def _replay_cells_kernel(prog, grid, idx, n_rows):
    """The factored cells kernel's arithmetic (csrc/grid_engine.cu) in numpy,
    in float32: the rows below n_rows whose index is a cell of the sector,
    (ra, rb) decoded from it; the cell's image rows pa_t[ra], pb_t[rb] read at
    each mask's (ga, gb); T loaded only where both images lie in the sector;
    a pair whose T is (0, 0) skipped; H_k summed over the mask's packed slots
    in slot order, each coefficient's sign the parity of (alpha word & ya) ^
    (beta word & yb); found pair p of the row (in mask order) summed by lane
    p % 32, each lane's products added in order, then the lanes in the xor
    tree (16, 8, 4, 2, 1). Every other row 0."""
    sa, sb = prog.sa, prog.sb
    g = grid.numpy()
    idx = idx.numpy()
    pa_t, pb_t = prog.pa_t.numpy(), prog.pb_t.numpy()
    ga, gb = prog.ga.numpy(), prog.gb.numpy()
    off, slots = prog.slot_off.numpy(), prog.slots.numpy()
    coeff = slots[:, 2].view(np.float32)
    aw_all, bw_all = prog.alpha_words.numpy(), prog.beta_words.numpy()
    out = np.zeros((len(idx), 2), np.float32)
    for i in range(min(int(n_rows), len(idx))):
        c = int(idx[i])
        if not 0 <= c < sa * sb:
            continue
        ra, rb = c // sb, c % sb
        ia, ib = pa_t[ra][ga], pb_t[rb][gb]                  # every mask's images
        ok = (ia < sa) & (ib < sb)
        t = np.where(ok[:, None], g[np.minimum(ia, sa), np.minimum(ib, sb)], 0)
        found = np.flatnonzero((t[:, 0] != 0) | (t[:, 1] != 0))
        lanes = np.zeros((32, 2), np.float32)
        for p, k in enumerate(found):
            h = np.float32(0)
            for j in range(off[k], off[k + 1]):
                word = (aw_all[ra] & slots[j, 0]) ^ (bw_all[rb] & slots[j, 1])
                h = np.float32(h + coeff[j] * _popcount_sign(word))
            lanes[p % 32] = (lanes[p % 32].astype(np.float64) + np.float64(h) * t[k]).astype(
                np.float32)
        for d in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ d]
        out[i] = lanes[0]
    return out


@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_kernel_index_arithmetic_replayed_in_numpy(engine):
    c = case("H2O")
    prog_t, _, spec_t, _ = _programs(engine, "H2O")
    s, la, ph = _buffer(c, 200, 208, 9)
    s[17] = 0b111                        # a live row outside the sector
    grid, _, idx = de_t.value_grid(spec_t, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), 200, prog_t.sa, prog_t.sb)
    want = _accumulate(engine, prog_t, grid, idx, 200).numpy()
    got = _replay_kernel(prog_t, grid) if engine == "dense" else \
        _replay_cells_kernel(prog_t, grid, idx, 200)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.abs(want).max() > 1e-3


# the wrapper's choice (one range per 256 masks), ranges that do not divide the
# masks, and more ranges than a term chunk would give
@pytest.mark.parametrize("n_ranges", ["wrapper", 3, 7])
def test_dense_kernel_partition_replayed_in_numpy(n_ranges):
    c = case("H2O")
    prog_t, _, spec_t, _ = _programs("dense", "H2O")
    n_masks = prog_t.row_map.shape[0]
    assert gk.dense_ranges(n_masks) == n_masks // gk.CHUNK_TERMS
    assert gk.dense_ranges(8 * gk.CHUNK_TERMS) == 8 and gk.dense_ranges(1) == 1
    if n_ranges == "wrapper":
        n_ranges = gk.dense_ranges(n_masks)
    else:
        assert n_masks % n_ranges
    s, la, ph = _buffer(c, 200, 208, 10)
    grid, _, _ = de_t.value_grid(spec_t, torch.as_tensor(s), torch.as_tensor(la),
                                 torch.as_tensor(ph), 200, prog_t.sa, prog_t.sb)
    got = _replay_kernel(prog_t, grid, n_ranges)
    assert got.dtype == np.float32
    want = gk.dense_grid_accumulate_ref(prog_t, grid).numpy()
    tol = gk.grid_tolerance(prog_t, grid).numpy()
    assert np.all(np.abs(got - want) <= tol), float((np.abs(got - want) / tol).max())
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("sectors", [None, ((4, 2),)], ids=["square", "rectangular"])
def test_cells_plain_version_equals_the_whole_grid_read_at_the_cells(sectors):
    """factored_cells_accumulate_ref is the whole-grid plain version (the JAX
    package's scan) read at the live rows' cells."""
    import naqs_tpu_torch as nt

    c = case("H2O")
    hil = c.h_t if sectors is None else nt.Hilbert(n_qubits=14, sectors=sectors)
    prog = de_t.FactorTerms.build(c.terms_t, hil, device="cpu")
    spec = RankSpec.for_hilbert(hil)
    rng = np.random.default_rng(21)
    m = min(250, hil.size - 5)
    s, la, ph, _ = padded_batch(np.sort(rng.choice(hil.basis, size=m, replace=False)), m + 9,
                                rng)
    grid, _, idx = de_t.value_grid(spec, torch.as_tensor(s), torch.as_tensor(la),
                                   torch.as_tensor(ph), m, prog.sa, prog.sb)
    rows = gk.factored_cells_accumulate_ref(prog, grid, idx, torch.tensor(m))
    whole = gk.factored_grid_accumulate_ref(prog, grid)
    ra, rb = idx[:m] // prog.sb, idx[:m] % prog.sb
    np.testing.assert_allclose(rows[:m].numpy(), whole[rb, ra].numpy(), rtol=0, atol=2e-6)
    assert float(whole.abs().max()) > 1e-3 and not rows[m:].any()


def test_cells_rows_without_a_cell_read_zero():
    """Rows at or past n_rows, SENTINEL rows and rows outside the sector give
    exactly (0, 0); the others what the same cells give alone."""
    c = case("H2O")
    prog, _, spec, _ = _programs("factored", "H2O")
    m, cap = 120, 140
    s, la, ph = _buffer(c, m, cap, 17)
    grid, _, _ = de_t.value_grid(spec, torch.as_tensor(s), torch.as_tensor(la),
                                 torch.as_tensor(ph), m, prog.sa, prog.sb)
    q = s.copy()
    q[5] = 0b111                                     # outside the sector
    q[9] = SENTINEL
    q[m - 1] = np.setdiff1d(c.h_t.basis, s[:m])[0]   # unsampled, but a cell
    idx = de_t.rank_index(spec, torch.as_tensor(q))
    n_rows = m - 10
    out = gk.factored_cells_accumulate(prog, grid, idx, torch.tensor(n_rows)).numpy()
    dead = np.zeros(cap, bool)
    dead[[5, 9]] = True
    dead[n_rows:] = True
    assert int(idx[5]) == int(idx[9]) == prog.sa * prog.sb
    assert np.all(out[dead] == 0) and np.abs(out[~dead]).max() > 1e-3
    alone = gk.factored_cells_accumulate(prog, grid, idx[~dead],
                                         torch.tensor(int((~dead).sum()))).numpy()
    np.testing.assert_array_equal(out[~dead], alone)
    full = gk.factored_grid_accumulate_ref(prog, grid).numpy()
    live = idx.numpy()[~dead]
    np.testing.assert_allclose(out[~dead], full[live % prog.sb, live // prog.sb], rtol=0,
                               atol=2e-6)


def test_factored_queries_with_duplicate_and_unsampled_states_match_jax():
    """queries= rows that repeat sampled states, that were never sampled, and a
    SENTINEL row, through the port's factored engine and naqs_tpu's."""
    c = case("H2O")
    prog_t, prog_j, spec_t, spec_j = _programs("factored", "H2O")
    m, cap = 200, 216
    s, la, ph = _buffer(c, m, cap, 23)
    rng = np.random.default_rng(24)
    unsampled = rng.choice(np.setdiff1d(c.h_t.basis, s[:m]), size=30, replace=False)
    q_s = np.concatenate([s[[3, 3, 50, 199, 50]], unsampled, [SENTINEL], s[[0, 0]]])
    q_la = np.concatenate([la[[3, 3, 50, 199, 50]], rng.normal(size=30) - 2.0, [0.0],
                           la[[0, 0]]]).astype(np.float32)
    q_ph = np.concatenate([ph[[3, 3, 50, 199, 50]], rng.uniform(-np.pi, np.pi, 30), [0.0],
                           ph[[0, 0]]]).astype(np.float32)
    q_t = tuple(torch.as_tensor(a) for a in (q_s, q_la, q_ph))
    re_t, im_t = _port(de_t.factored_local_energy, prog_t, spec_t, s, la, ph, m, queries=q_t)
    q_j = tuple(jnp.asarray(a) for a in (to_u64(q_s), q_la, q_ph))
    re_j, im_j = de_j.factored_local_energy(prog_j, spec_j, jnp.asarray(to_u64(s)),
                                            jnp.asarray(la), jnp.asarray(ph), jnp.int32(m),
                                            queries=q_j)
    np.testing.assert_allclose(re_t, np.asarray(re_j), rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(im_t, np.asarray(im_j), rtol=0, atol=ROW_TOL)
    assert re_t[0] == re_t[1] and re_t[2] == re_t[4] and re_t[-1] == re_t[-2]
    assert re_t[35] == 0 and im_t[35] == 0          # the SENTINEL row
    assert np.abs(im_t[5:35]).max() > 1e-4          # unsampled rows see sampled neighbours
