"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA card: a CUDA kernel has no CPU mode. Imports nothing
of JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda

`rank_gather2` must equal its plain version bitwise; `rank_ratio_rowsum`
per row within `rowsum_tolerance` (2e-5 Ha + 1e-6 * sum_k |h| |r|: fp32
summation order over K terms and expf/sincosf ulps); the grid kernels
`factored_cells_accumulate` (per listed row), `dense_grid_accumulate` and the
staircase's `xl_grid_accumulate` per cell within `grid_tolerance` (1e-6 +
1e-5 * sum_k sum_r |fcoeff| |T_k|: fp32 order over the masks, fma against
mul + add), and bitwise equal to themselves run twice (the cells kernel's
bits also pinned by sha256 on three grids); the XL
kernel's occupancy bitmaps bit for bit against `xl_occupancy_ref`;
the sampler's `multinomial4_split`, `compact_children` and the two fused in
one launch, `split_and_compact`, bitwise (the split does its plain version's
arithmetic with one rounding per operation, the compaction is an integer
scan), the fused kernel also with its gate on the previous shell's count and
under CUDA-graph replay; the sort engine's `sorted_gather2` bitwise and `sorted_ratio_rowsum`
per row within `rowsum_tolerance`, and `offdiag_h_terms` per entry within
`offdiag_tolerance` (1e-12 + 1e-5 * sum_k |coeff_k| of the flip mask's group:
fp32 add order), each bitwise equal to itself run twice; the one-launch
`sorted_local_energy` per row within `sorted_local_energy_tolerance` of its
plain version (the row sum's, the H entries' and the f64 diagonal's add
order), of `offdiag_h_terms` + `sorted_ratio_rowsum` composed within that
bound without the H entries' term (the same h bits), and bitwise equal to
itself. The same body with the rank lookup, `rank_local_energy`, per row
within `rank_local_energy_tolerance` (up to frozen-core N2 6-31G's 32-qubit
table of 19 M rows), and the one-launch quadratic forms
`rank_quadratic_energy` and `sorted_quadratic_energy` per row (num and w)
within their `*_tolerance` and their quotient within 1e-6 relative; all four
give `offdiag_h_terms`' h bits on a row with one found pair, bitwise; the
dispatch launches each once per call, with a dense A or without. Every
engine's E_loc kernel at a data-parallel step's merged table, where states
drawn on both ranks lie twice, against its plain version (per row within
its tolerance) and against the table without the repeats.

The trainer's extras on the card (N2 STO-3G): clipped steps keep the clip's
ring on the card and move it once per applied update, never on a withheld
one; `run_density` launches `compact_children` once per shell and never
`split_and_compact`; a checkpoint round trip restores every tensor and the
card's generator bitwise, and the next step draws the same batch and gives
its energy within 2e-4 Ha (the engines' bar).

Exact mode on the card (N2 STO-3G): a window of updates over the whole
basis runs under torch.cuda.set_sync_debug_mode("error") and ends within
rtol 1e-5 / atol 1e-7 of the same sequential updates; `run_exact` in both
modes with exact local energies.

The natural-gradient updates on the card (N2 STO-3G): one `sr_update` (with
its KL clip) and one `kfac_update` on a sampled batch's live rows run under
torch.cuda.set_sync_debug_mode("error"), one E_loc launch each.

The CLI on the card (chip_smoke.py phase 13's two runs at a small width,
3 steps): finite energies, the run's files, and each kernel of its path
launched. A LUT model's `sample()` with float32 and float64 conditionals:
every shell's `split_and_compact` (the f64 instantiation for float64)
bitwise equal to its plain version on that shell's inputs, and the sampled
frequencies within 4 sqrt(p(1-p)/n) + 5e-5 of |psi|^2.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.ops.dyn_gather import (QUAD_MISS, rank_gather2, rank_gather2_ref,
                                           rank_local_energy, rank_local_energy_ref,
                                           rank_local_energy_tolerance, rank_quadratic_energy,
                                           rank_quadratic_energy_ref,
                                           rank_quadratic_energy_tolerance, rank_ratio_rowsum,
                                           rank_ratio_rowsum_ref, rowsum_tolerance)
from naqs_tpu_torch.ops import local_energy as le
from naqs_tpu_torch.ops import dense_engine as de
from naqs_tpu_torch.ops.dense_engine import (DenseTerms, FactorTerms, FactorTermsXL, value_grid,
                                             xl_value_grid)
from naqs_tpu_torch.ops.grid_kernels import (dense_grid_accumulate, dense_grid_accumulate_ref,
                                             factored_cells_accumulate,
                                             factored_cells_accumulate_ref, grid_tolerance,
                                             xl_grid_accumulate, xl_grid_accumulate_ref,
                                             xl_occupancy_ref, _xl_launch)
from naqs_tpu_torch.ops.multinomial import (_GAUSS_VAR_MIN, _cascade, multinomial4_split,
                                            multinomial4_split_ref, split_draws)
from naqs_tpu_torch.ops.offdiag_h import offdiag_h_terms, offdiag_h_terms_ref, offdiag_tolerance
from naqs_tpu_torch.ops.rank import RankSpec, build_value_table
from naqs_tpu_torch.ops.sort_lookup import (pack_table, sorted_gather2, sorted_gather2_ref,
                                            sorted_local_energy, sorted_local_energy_ref,
                                            sorted_local_energy_tolerance, sorted_log_amps,
                                            sorted_quadratic_energy, sorted_quadratic_energy_ref,
                                            sorted_quadratic_energy_tolerance,
                                            sorted_ratio_rowsum, sorted_ratio_rowsum_ref)
from naqs_tpu_torch import sampler as sampler_mod
from naqs_tpu_torch.sampler import (_compact_children, _compact_children_ref, _split_and_compact,
                                    _split_and_compact_ref, sample)
from naqs_tpu_torch.utils.bits import parity_pm1

pytestmark = pytest.mark.cuda

SHAPES = [
    (((5, 5),), 14, 400, 256),
    (((5, 3), (4, 4), (3, 5)), 14, 77, 1000),   # ragged shapes, three sectors
    (((5, 5),), 26, 512, 4608),                 # H2O 6-31G table, main-path chunk
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(sectors, n_qubits, n_rows, n_cols, dev, hits=False, buffer=False):
    """(spec, table, s, xy, my_la, my_ph) on the card. With hits=True half of
    the flip masks join two table states, so many coupled states are found;
    with buffer=True also the sorted states, la and ph the table holds."""
    h = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    spec = RankSpec.for_hilbert(h)
    rng = np.random.default_rng(0)
    pool = h.basis if h.size < 10**6 else h.basis[rng.choice(h.size, 200_000, replace=False)]
    states = np.sort(rng.choice(pool, size=min(len(pool), 50_000), replace=False))
    la = -rng.uniform(0, 3, size=len(states)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=len(states)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    table = build_value_table(spec, t(states), t(la), t(ph), len(states))
    xy = rng.integers(0, 2 ** n_qubits, size=n_cols).astype(np.int64)
    if hits:
        pick = lambda: rng.integers(0, min(n_rows, len(states)), size=n_cols // 2)
        xy[: n_cols // 2] = states[pick()] ^ states[pick()]
    out = (spec, table, t(states[:n_rows]), t(xy), t(la[:n_rows]), t(ph[:n_rows]))
    return out + (t(states), t(la), t(ph)) if buffer else out


@pytest.mark.parametrize("sectors,n_qubits,n_rows,n_cols", SHAPES)
def test_rank_gather2_kernel_matches_plain(sectors, n_qubits, n_rows, n_cols):
    dev = _card()
    spec, table, s, xy, _, _ = _inputs(sectors, n_qubits, n_rows, n_cols, dev)
    before = rank_gather2.launches
    got = rank_gather2(spec, s, xy, table)
    torch.cuda.synchronize()
    assert rank_gather2.launches == before + 1
    want = rank_gather2_ref(spec, s, xy, table)
    for g, w in zip(got, want):
        assert g.shape == (n_rows, n_cols) and torch.equal(g, w)


@pytest.mark.parametrize("sectors,n_qubits,n_rows,n_cols", SHAPES + [
    (((9, 7),), 20, 301, 777),                  # open shell; C, K off every tile
])
def test_rank_ratio_rowsum_kernel_matches_plain(sectors, n_qubits, n_rows, n_cols):
    dev = _card()
    spec, table, s, xy, my_la, my_ph = _inputs(sectors, n_qubits, n_rows, n_cols, dev,
                                               hits=True)
    gen = torch.Generator(device="cpu").manual_seed(1)
    h = (0.1 * torch.randn((s.shape[0], n_cols), generator=gen)).to(dev)
    before = rank_ratio_rowsum.launches
    got = rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h)
    torch.cuda.synchronize()
    assert rank_ratio_rowsum.launches == before + 1
    want = rank_ratio_rowsum_ref(spec, s, xy, table, my_la, my_ph, h)
    tol = rowsum_tolerance(rank_gather2_ref(spec, s, xy, table)[0], my_la, h)
    for g, w in zip(got, want):
        assert g.shape == (s.shape[0],) and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())
    assert float(want[0].abs().max()) > 1e-3  # hits: the sums are not all 0
    again = rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h)
    assert all(torch.equal(a, g) for a, g in zip(again, got))  # no atomics


def test_rank_gather2_rejects_bad_inputs():
    dev = _card()
    spec = RankSpec.for_hilbert(nt.Hilbert(n_qubits=14, sectors=((5, 5),)))
    table = torch.zeros((spec.size + 1, 2), device=dev)
    s = torch.zeros(4, dtype=torch.int64, device=dev)
    for bad in (lambda: rank_gather2(spec, s.int(), s, table),
                lambda: rank_gather2(spec, s, s, table[:-1]),
                lambda: rank_gather2(spec, s, s, torch.zeros((spec.size + 1, 4),
                                                             device=dev)[:, :2]),
                lambda: rank_gather2(spec, s, s, torch.zeros(2 * spec.size + 3,
                                                             device=dev)[1:].view(-1, 2)),
                lambda: rank_gather2(spec, s, s.cpu(), table)):
        with pytest.raises(ValueError):
            bad()


def test_rank_ratio_rowsum_rejects_bad_inputs():
    dev = _card()
    spec = RankSpec.for_hilbert(nt.Hilbert(n_qubits=14, sectors=((5, 5),)))
    table = torch.zeros((spec.size + 1, 2), device=dev)
    s = torch.zeros(4, dtype=torch.int64, device=dev)
    v = torch.zeros(4, device=dev)
    h = torch.zeros((4, 4), device=dev)
    strided = torch.zeros((spec.size + 1, 4), device=dev)[:, :2]
    for bad in (lambda: rank_ratio_rowsum(spec, s, s, strided, v, v, h),
                lambda: rank_ratio_rowsum(spec, s, s, table, v, v, h[:, :3]),
                lambda: rank_ratio_rowsum(spec, s, s, table, v, v, h.double()),
                lambda: rank_ratio_rowsum(spec, s, s, table, v, v,
                                          torch.zeros((4, 8), device=dev)[:, ::2]),
                lambda: rank_ratio_rowsum(spec, s, s, table, v, v.cpu(), h),
                lambda: rank_ratio_rowsum(spec, s, s, table, v, v, h.cpu())):
        with pytest.raises(ValueError):
            bad()


GRID_KERNELS = {
    "dense": (DenseTerms, dense_grid_accumulate, dense_grid_accumulate_ref),
    "factored": (FactorTerms, factored_cells_accumulate, factored_cells_accumulate_ref),
}


def _every_cell(prog, dev, tail=5):
    """(idx, n_rows) that list every cell of the grid in order, then `tail`
    SENTINEL rows past n_rows."""
    n = prog.sa * prog.sb
    idx = torch.cat([torch.arange(n), torch.full((tail,), n)]).to(dev)
    return idx, torch.tensor(n, device=dev)


def _full_grid(prog, dev):
    """Every cell of the grid set at random, the pad row and column zero."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2))
    grid[:-1, :-1] = torch.rand((prog.sa, prog.sb, 2), generator=gen) - 0.5
    return grid.to(dev)
_n2_cache = {}


def _n2(sectors=None):
    """(terms, hilbert) of the N2 STO-3G molecule the port ships: its own sector
    (7, 7) with 14,400 states, or another sector of the same 20 qubits."""
    if not _n2_cache:
        mol = nt.load_molecule("N2_STO-3G_gen")
        _n2_cache["v"] = (nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits),
                          nt.Hilbert.for_molecule(mol))
    terms, hil = _n2_cache["v"]
    return terms, hil if sectors is None else nt.Hilbert(n_qubits=20, sectors=sectors)


def _n2_sample(hil, m, cap, dev, seed=0):
    """A sorted SENTINEL-padded buffer of m random basis states on the card."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    rng = np.random.default_rng(seed)
    s = np.full(cap, SENTINEL, np.int64)
    s[:m] = np.sort(rng.choice(hil.basis, size=m, replace=False))
    la = np.zeros(cap, np.float32)
    la[:m] = rng.normal(size=m) - 1.0
    ph = np.zeros(cap, np.float32)
    ph[:m] = rng.uniform(-np.pi, np.pi, size=m)
    return tuple(torch.as_tensor(a, device=dev) for a in (s, la, ph))


# (7, 7), the molecule's own: 120 x 120 cells. Rectangular grids, so that no exchange
# of the spins' sizes goes unseen: (9, 2) with Sa = 10 (under one warp) and Sb = 45,
# (3, 6) with Sa = 120 and Sb = 210, (6, 3) with Sa = 210 (two tiles of ra for the
# dense kernel's 128-thread blocks) and Sb = 120, (2, 9) with Sa = 45 and Sb = 10
@pytest.mark.parametrize("fill,sectors", [("sampled", None), ("full", None),
                                          ("sampled", ((9, 2),)), ("full", ((3, 6),)),
                                          ("sampled", ((6, 3),)), ("full", ((2, 9),))])
@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_grid_kernel_matches_plain(engine, fill, sectors):
    dev = _card()
    terms, hil = _n2(sectors)
    cls, wrapper, ref = GRID_KERNELS[engine]
    prog = cls.build(terms, hil, device=dev)
    if fill == "sampled":
        m = min(3000, hil.size // 2)
        s, la, ph = _n2_sample(hil, m, 4096, dev)
        grid, _, idx = value_grid(RankSpec.for_hilbert(hil), s, la, ph, m, prog.sa, prog.sb)
    else:   # every cell set, the pad row and column zero
        grid = _full_grid(prog, dev)
    rows = ()
    if engine == "factored":   # the buffer's rows, m live, or every cell of the full grid
        rows = (idx, torch.tensor(m, device=dev)) if fill == "sampled" else _every_cell(prog, dev)
    before = wrapper.launches
    got = wrapper(prog, grid, *rows)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = ref(prog, grid, *rows)
    tol = grid_tolerance(prog, grid, *rows)
    shape = (rows[0].shape[0], 2) if rows else (prog.sb, prog.sa, 2)
    assert got.shape == shape and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())
    assert float(want.abs().max()) > 1e-3   # the sums are not all 0
    if rows:   # rows past n_rows, and SENTINEL rows, are exactly 0
        dead = (torch.arange(rows[0].shape[0], device=dev) >= rows[1]) | \
            (rows[0] >= prog.sa * prog.sb)
        assert bool(dead.any()) and not bool(got[dead].any())
    assert torch.equal(wrapper(prog, grid, *rows), got)   # fixed order, no atomics


# sha256 of factored_cells_accumulate's (U, 2) output on N2 STO-3G sectors with
# the full random grid of test_grid_kernel_matches_plain, every cell listed in
# order and 5 SENTINEL rows after them, from the kernel as built from this
# source (NVIDIA H100 80GB HBM3)
FACTORED_CELLS_BITS = {
    (7, 7): "b9a5c563424e44fc3d6cf062ced7adf3b230c8649e90d32b2eee9492156adf7c",
    (3, 6): "089e543b9713fee83ec4e1e356ff1d480b81f4629952b22a8edfb15755a593ad",
    (6, 3): "9459b65e1c47e970722a7bf4e2f5e0b472c7be6a923bc5fc780a38e4331452d1",
}


@pytest.mark.parametrize("sector", list(FACTORED_CELLS_BITS))
def test_factored_cells_kernel_keeps_its_bits(sector):
    import hashlib

    dev = _card()
    terms, hil = _n2((sector,))
    prog = FactorTerms.build(terms, hil, device=dev)
    out = factored_cells_accumulate(prog, _full_grid(prog, dev), *_every_cell(prog, dev))
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    print(f"factored_cells_accumulate {sector}: {digest}")
    assert digest == FACTORED_CELLS_BITS[sector]


def test_factored_cells_kernel_on_image_rows_too_wide_for_eight_warps():
    """Alpha-image rows padded to 4,096 ints (no mask reads the pad): eight
    warps' two stages would take 256 KB, more than a block's shared memory,
    so the launch reads the masks' (ga, gb) through the read-only cache, not
    from shared memory, and runs fewer warps a block. A row's order of
    summation depends on neither, so the bits are the unpadded program's."""
    dev = _card()
    terms, hil = _n2()
    prog = FactorTerms.build(terms, hil, device=dev)
    width = 4096
    pa_idx = torch.full((width, prog.sa), prog.sa, dtype=torch.int32, device=dev)
    pa_idx[:prog.pa_idx.shape[0]] = prog.pa_idx
    wide = dataclasses.replace(prog, pa_idx=pa_idx, pa_t=pa_idx.t().contiguous())
    m = 3000
    s, la, ph = _n2_sample(hil, m, 4096, dev, seed=4)
    grid, _, idx = value_grid(RankSpec.for_hilbert(hil), s, la, ph, m, prog.sa, prog.sb)
    n = torch.tensor(m, device=dev)
    got = factored_cells_accumulate(wide, grid, idx, n)
    assert torch.equal(got, factored_cells_accumulate(prog, grid, idx, n))
    tol = grid_tolerance(prog, grid, idx, n)
    assert bool(((got - factored_cells_accumulate_ref(prog, grid, idx, n)).abs() <= tol).all())
    assert float(got.abs().max()) > 1e-3


def test_dense_grid_kernel_repeatable_and_its_counters_come_back_to_zero():
    """Three launches on one set of arrival counters: the same bits each time
    (partials added in range order, whatever order the blocks finish in), and
    every counter 0 after each."""
    from naqs_tpu_torch.ops import grid_kernels as gk

    dev = _card()
    terms, hil = _n2()
    prog = DenseTerms.build(terms, hil, device=dev)
    assert gk.dense_ranges(prog.row_map.shape[0]) == 8       # N2 STO-3G: 2,048 masks
    s, la, ph = _n2_sample(hil, 3000, 4096, dev, seed=3)
    grid, _, _ = value_grid(RankSpec.for_hilbert(hil), s, la, ph, 3000, prog.sa, prog.sb)
    outs = []
    for _ in range(3):
        outs.append(dense_grid_accumulate(prog, grid))
        torch.cuda.synchronize()
        counters = gk._arrival_counters(grid.device, prog.sb, prog.sa)
        assert not bool(counters.any())
    assert len(gk._arrivals) >= 1
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    tol = grid_tolerance(prog, grid)
    assert bool(((outs[0] - dense_grid_accumulate_ref(prog, grid)).abs() <= tol).all())


@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_grid_engine_matches_rank_engine_on_the_card(engine):
    dev = _card()
    terms, hil = _n2()
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    assert type(dt.dense).__name__ == "DenseTerms"
    if engine == "factored":
        dt = dataclasses.replace(dt, dense=FactorTerms.build(terms, hil, device=dev))
    m = 3000
    s, la, ph = _n2_sample(hil, m, 4096, dev, seed=1)
    e_grid = le.local_energy(dt, s, la, ph, m)
    e_rank = le.local_energy(dataclasses.replace(dt, dense=None), s, la, ph, m)
    for g, r in zip(e_grid, e_rank):
        assert float((g[:m] - r[:m]).abs().max()) < 2e-4
    rows = torch.arange(5, m, 11, device=dev)
    e_q = le.local_energy(dt, s, la, ph, m, queries=(s[rows], la[rows], ph[rows]))
    assert torch.equal(e_q[0], e_grid[0][rows]) and torch.equal(e_q[1], e_grid[1][rows])


@pytest.mark.parametrize("engine", ["dense", "factored"])
def test_grid_kernel_rejects_bad_inputs(engine):
    dev = _card()
    terms, hil = _n2()
    cls, accumulate, _ = GRID_KERNELS[engine]
    prog = cls.build(terms, hil, device=dev)
    grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2), device=dev)
    wide = torch.zeros((prog.sa + 1, prog.sb + 1, 4), device=dev)[..., :2]
    field, maps = ("h_dense", "row_map") if engine == "dense" else ("fcoeff", "pa_t")
    idx, n = torch.zeros(4, dtype=torch.int64, device=dev), torch.tensor(4, device=dev)
    wrapper = accumulate if engine == "dense" else lambda p, g: accumulate(p, g, idx, n)
    bad_rows = [] if engine == "dense" else [
        lambda: accumulate(prog, grid, idx.cpu(), n), lambda: accumulate(prog, grid, idx, n.cpu()),
        lambda: accumulate(prog, grid, idx.int(), n),
        lambda: accumulate(prog, grid, torch.zeros(8, dtype=torch.int64, device=dev)[::2], n),
        lambda: accumulate(prog, grid, idx, n[None])]
    for bad in [lambda: wrapper(prog, grid.double()),
                lambda: wrapper(prog, wide),
                lambda: wrapper(prog, grid.cpu()),
                lambda: wrapper(prog, grid[:-1]),
                lambda: wrapper(dataclasses.replace(prog, **{maps: getattr(prog, maps).long()}),
                                grid),
                lambda: wrapper(dataclasses.replace(prog, **{maps: getattr(prog, maps).cpu()}),
                                grid),
                lambda: wrapper(dataclasses.replace(prog, sa=prog.sa - 1), grid),
                lambda: wrapper(dataclasses.replace(
                    prog, **{field: getattr(prog, field).transpose(0, 1)}), grid)] + bad_rows:
        with pytest.raises(ValueError):
            bad()


def _staircase(name, e, dev):
    """(terms, hilbert, FactorTermsXL on the card) of a shipped molecule
    restricted to at most e excitations (terms with at most e X/Y sites, as
    the CLI's -n_excitations_max gives them)."""
    mol = nt.load_molecule(name)
    hil = nt.Hilbert.for_molecule(mol)
    hil = nt.Hilbert(n_qubits=hil.n_qubits, sectors=hil.sectors, n_exc_max=e)
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits, n_excitations_max=e)
    return terms, hil, FactorTermsXL.build(terms, hil, device=dev)


# N2 STO-3G at 2 and 4 excitations (caps forced: its sector would take the
# dense program), and Li2O STO-3G CISDTQ (644,365 cells), the card's shape;
# sampled grids hold staircase states and states of the rectangle outside it.
# Beside them: an all-zero grid (the sums exactly zero), one set cell, the
# sampled grid with its Hartree-Fock cell set too (a cell that every single
# and double flip of a staircase cell near it reaches, so one cell of the sums
# gets many masks' terms), every staircase cell set (the whole filtered
# basis, as exact E_loc over it sets it) and every cell of the rectangle set
# (on Li2O, every row of the bitmaps in both too full to list: the kernel
# probes every cell and sums set pairs at once)
@pytest.mark.parametrize("fill", ["sampled", "full", "staircase", "zero", "one", "crowded"])
@pytest.mark.parametrize("name,e", [("N2_STO-3G_gen", 2), ("N2_STO-3G_gen", 4),
                                    ("Li2O_STO-3G_gen", 4)])
def test_xl_grid_kernel_matches_plain(name, e, fill, monkeypatch):
    dev = _card()
    monkeypatch.setattr(de, "DENSE_SIZE_MAX", 1)
    monkeypatch.setattr(de, "FACT_SIZE_MAX", 1)
    terms, hil, prog = _staircase(name, e, dev)
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    assert type(dt.dense).__name__ == "FactorTermsXL" and dt.dense.n_cells == prog.n_cells
    if fill in ("sampled", "crowded"):
        from naqs_tpu_torch.utils.bits import SENTINEL

        rng = np.random.default_rng(5)
        pool = hil.basis if hil.size < 300_000 else rng.choice(hil.basis, 300_000, replace=False)
        m = min(20_000, len(pool) // 2)
        # random cells of the rectangle: most lie outside the staircase
        words = lambda w, n: rng.choice(w.cpu().numpy().astype(np.int64), n)
        n_shells = hil.n_qubits // 2
        rect = (de._expand_qubits(words(prog.alpha_words, m // 4), 0, n_shells)
                | de._expand_qubits(words(prog.beta_words, m // 4), 1, n_shells))
        states = np.unique(np.concatenate([rng.choice(pool, m, replace=False), rect]))
        assert not hil.contains(states).all()
        cap = len(states) + 100
        s = np.full(cap, SENTINEL, np.int64)
        s[:len(states)] = states
        la = (rng.normal(size=cap) - 1.0).astype(np.float32)
        ph = rng.uniform(-np.pi, np.pi, size=cap).astype(np.float32)
        t = lambda a: torch.as_tensor(a, device=dev)
        grid, _ = xl_value_grid(prog, RankSpec.for_hilbert(hil), t(s), t(la), t(ph),
                                len(states))
        if fill == "crowded":
            grid[0, 0] = torch.tensor([1.0, 0.25], device=dev)
    elif fill == "full":   # every cell of the rectangle set, the pad row and column zero
        gen = torch.Generator(device="cpu").manual_seed(3)
        grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2))
        grid[:-1, :-1] = torch.rand((prog.sa, prog.sb, 2), generator=gen) - 0.5
        grid = grid.to(dev)
    elif fill == "staircase":
        gen = torch.Generator(device="cpu").manual_seed(3)
        grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2))
        in_stair = torch.arange(prog.sb)[None, :] < prog.width[:-1].cpu()[:, None]
        grid[:-1, :-1][in_stair] = torch.rand((prog.n_cells, 2), generator=gen) - 0.5
        grid = grid.to(dev)
    else:
        grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2), device=dev)
        if fill == "one":
            grid[1, 0] = torch.tensor([0.6, -0.8], device=dev)
    before = xl_grid_accumulate.launches
    got = xl_grid_accumulate(prog, grid)
    torch.cuda.synchronize()
    assert xl_grid_accumulate.launches == before + 1
    want = xl_grid_accumulate_ref(prog, grid)
    tol = grid_tolerance(prog, grid)
    assert got.shape == (prog.n_cells, 2) and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())
    if fill == "zero":
        assert not bool(got.any())
    else:
        assert float(want.abs().max()) > 1e-3
    assert torch.equal(xl_grid_accumulate(prog, grid), got)   # fixed order, no atomics
    # the first phase's bitmaps are the plain build's, bit for bit
    for g, w in zip(_xl_launch(prog, grid)[1:], xl_occupancy_ref(grid)):
        assert torch.equal(g, w)


def test_xl_engine_matches_rank_engine_on_the_card(monkeypatch):
    """N2 STO-3G at 4 excitations through the staircase engine against the
    rank engine on staircase states, and its queries= readout."""
    dev = _card()
    monkeypatch.setattr(de, "DENSE_SIZE_MAX", 1)
    monkeypatch.setattr(de, "FACT_SIZE_MAX", 1)
    terms, hil, _ = _staircase("N2_STO-3G_gen", 4, dev)
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    assert type(dt.dense).__name__ == "FactorTermsXL"
    m = 3000
    s, la, ph = _n2_sample(hil, m, 4096, dev, seed=4)
    e_grid = le.local_energy(dt, s, la, ph, m)
    e_rank = le.local_energy(dataclasses.replace(dt, dense=None), s, la, ph, m)
    for g, r in zip(e_grid, e_rank):
        assert float((g[:m] - r[:m]).abs().max()) < 2e-4
    rows = torch.arange(5, m, 11, device=dev)
    e_q = le.local_energy(dt, s, la, ph, m, queries=(s[rows], la[rows], ph[rows]))
    assert torch.equal(e_q[0], e_grid[0][rows]) and torch.equal(e_q[1], e_grid[1][rows])


def _overlapping_shards(basis, dev, n_per=4096, live=(3000, 2600), shared=1200, seed=6):
    """Two ranks' sorted, SENTINEL-padded shards of n_per rows, `shared` live
    states on both (each distinct state carries one (la, ph) wherever it
    lies), and their merged table: both shards end to end, sorted stably,
    as `parallel/step.merge_shards` gathers and sorts them."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    rng = np.random.default_rng(seed)
    pool = rng.choice(basis, size=live[0] + live[1] - shared, replace=False)
    la = (rng.normal(size=len(pool)) - 1.0).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=len(pool)).astype(np.float32)
    shards = []
    for sel in (np.arange(live[0]), np.arange(live[0] - shared, len(pool))):
        sel = sel[np.argsort(pool[sel])]
        s = np.full(n_per, SENTINEL, np.int64)
        a, p = np.zeros(n_per, np.float32), np.zeros(n_per, np.float32)
        s[:len(sel)], a[:len(sel)], p[:len(sel)] = pool[sel], la[sel], ph[sel]
        shards.append(tuple(torch.as_tensor(x, device=dev) for x in (s, a, p)))
    cat = [torch.cat([sh[i] for sh in shards]) for i in range(3)]
    order = torch.sort(cat[0], stable=True)[1]
    return shards, (cat[0][order], cat[1][order], cat[2][order], live[0] + live[1])


@pytest.mark.parametrize("engine", ["fact", "dense", "rank", "sort", "xl"])
def test_engines_at_a_merged_table_with_repeated_keys(engine, monkeypatch):
    """The E_loc kernel of every engine at a data-parallel step's merged
    table, where 1,200 states drawn on both ranks lie twice, for each rank's
    query rows (N2 STO-3G; the staircase engine at 4 excitations with its
    caps forced): against its plain version on the same card tensors, per
    row within the kernel's own tolerance, and against the same table
    without the repeats (the grid engines' grids equal; the row kernels
    within that tolerance). `tools/shard_drill.repeated_keys` is the check
    that chip_smoke.py phase 16b makes at the paper width."""
    from naqs_tpu_torch.tools.shard_drill import repeated_keys

    dev = _card()
    if engine == "xl":
        monkeypatch.setattr(de, "DENSE_SIZE_MAX", 1)
        monkeypatch.setattr(de, "FACT_SIZE_MAX", 1)
        terms, hil, _ = _staircase("N2_STO-3G_gen", 4, dev)
    else:
        terms, hil = _n2()
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    if engine == "fact":
        dt = dataclasses.replace(dt, dense=FactorTerms.build(terms, hil, device=dev))
    elif engine in ("rank", "sort"):
        dt = dataclasses.replace(dt, dense=None,
                                 rank_spec=dt.rank_spec if engine == "rank" else None)
    want = {"fact": "FactorTerms", "dense": "DenseTerms", "xl": "FactorTermsXL"}.get(engine)
    assert type(dt.dense).__name__ == want if want else dt.dense is None
    shards, table = _overlapping_shards(hil.basis, dev)
    assert int(torch.unique(table[0][:table[3]]).numel()) == table[3] - 1200
    for r, (live, q) in enumerate(zip((3000, 2600), shards)):
        got = repeated_keys({engine: dt}, table, q, live)[engine]
        assert got["within"] and got["dedup_within"], (r, got)


def test_xl_grid_kernel_rejects_bad_inputs():
    dev = _card()
    _, _, prog = _staircase("N2_STO-3G_gen", 4, dev)
    grid = torch.zeros((prog.sa + 1, prog.sb + 1, 2), device=dev)
    wide = torch.zeros((prog.sa + 1, prog.sb + 1, 4), device=dev)[..., :2]
    for bad in (lambda: xl_grid_accumulate(prog, grid.double()),
                lambda: xl_grid_accumulate(prog, wide),
                lambda: xl_grid_accumulate(prog, grid.cpu()),
                lambda: xl_grid_accumulate(prog, grid[:-1]),
                lambda: xl_grid_accumulate(dataclasses.replace(prog, prog=prog.prog.long()),
                                           grid),
                lambda: xl_grid_accumulate(dataclasses.replace(prog, chunks=prog.chunks[:, :3]),
                                           grid),
                lambda: xl_grid_accumulate(dataclasses.replace(prog, chunks=prog.chunks.cpu()),
                                           grid),
                lambda: xl_grid_accumulate(dataclasses.replace(
                    prog, n_col_chunks=prog.chunks.shape[0] + 1), grid),
                lambda: xl_grid_accumulate(dataclasses.replace(prog, tiles=prog.tiles.cpu()),
                                           grid),
                lambda: xl_grid_accumulate(dataclasses.replace(prog, sb=prog.sb - 1), grid),
                lambda: xl_grid_accumulate(dataclasses.replace(
                    prog, pa_idx=prog.pa_idx.transpose(0, 1)), grid)):
        with pytest.raises(ValueError):
            bad()
    # the C entry refuses a tile or chunk size other than the kernel's own: a
    # chunk of more masks than a stage's headers would overrun its stage
    from naqs_tpu_torch.ops import grid_kernels as gk

    _, bits_a, bits_b, any_a, any_b = gk._xl_launch(prog, grid)
    out = torch.empty((prog.n_cells, 2), device=dev)
    grid_t = torch.empty((prog.sb + 1, prog.sa + 1, 2), device=dev)
    tensors = (prog.pa_idx, prog.pb_idx, prog.alpha_words, prog.beta_words, prog.cells_off,
               prog.tiles, prog.prog, prog.chunks, grid, grid_t, bits_a, bits_b, any_a, any_b,
               out)
    for tile_cells, chunk_int4 in ((gk.XL_TILE_CELLS, 2 * gk.XL_CHUNK_INT4),
                                   (gk.XL_TILE_CELLS + 96, gk.XL_CHUNK_INT4)):
        with pytest.raises(RuntimeError):
            gk._call("xl_grid_accumulate", tensors,
                     (prog.tiles.shape[0], prog.chunks.shape[0], prog.n_col_chunks,
                      prog.prog.shape[0], prog.sa, prog.sb, tile_cells, chunk_int4), dev)


def _split_inputs(n, kind, dev, f64=False):
    """(counts, probs, z, u, mask, valid) on the card: 'mixed' rows of both
    branches with corners (p = 0 and 1, n = 0, 1, 1e12), 'cdf' small variances
    only, 'dead' no live row."""
    rng = np.random.default_rng(n)
    if kind == "cdf":
        counts = np.floor(10 ** rng.uniform(np.log10(20), np.log10(5000), n))
        p = 10 ** rng.uniform(-4, np.log10(0.9), (n, 4))
        p[::2] /= counts[::2, None]
    else:
        counts = np.floor(10 ** rng.uniform(0, 12, n))
        counts[::9] = rng.choice([0.0, 1.0, 1e12], len(counts[::9]))
        p = rng.uniform(0, 1, (n, 4)) * (rng.uniform(0, 1, (n, 4)) < 0.8)
        p[::3] *= 10 ** rng.uniform(-8, 0, (len(p[::3]), 4))
    mask = rng.uniform(0, 1, (n, 4)) < 0.8
    valid = rng.uniform(0, 1, n) < (0.0 if kind == "dead" else 0.7)
    t = lambda x: torch.as_tensor(x, device=dev)
    z, u = split_draws(torch.Generator(device=dev).manual_seed(n), n, dev)
    return (t(counts), t(p.astype(np.float64 if f64 else np.float32)), z, u, t(mask), t(valid))


def split_branches(counts, probs, z, u, valid=None):
    """How the plain cascade's binomials of live rows divide: {'gauss', 'cdf':
    binomials by branch, 'cdf_longest': the longest inverse-CDF loop,
    'dead_rows'}."""
    live = counts > 0 if valid is None else (counts > 0) & valid
    tally = {"gauss": 0, "cdf": 0, "cdf_longest": 0, "dead_rows": int((~live).sum())}
    for _, var, small in _cascade(counts, probs, z, u)[1]:
        in_cdf = live & ~(var > _GAUSS_VAR_MIN)
        tally["gauss"] += int((live & (var > _GAUSS_VAR_MIN)).sum())
        tally["cdf"] += int(in_cdf.sum())
        # the kernel compares u with cdf_0 .. cdf_small: small + 1 looks, 127 at most
        looks = torch.clamp(small[in_cdf] + 1, max=127)
        tally["cdf_longest"] = max(tally["cdf_longest"], int(looks.max()) if len(looks) else 0)
    return tally


def test_split_division_is_fdiv_rn_on_every_float():
    """The split's division by k (Markstein's correction from RN(1/k) where the
    dividend is +0 or within 2^-100..2^100, else __fdiv_rn) gives __fdiv_rn's
    bits for every float and every k = 1..128 (a NaN matches any NaN); most
    pairs take the fast division."""
    dev = _card()
    from naqs_tpu_torch.ops.sampler_kernels import launch

    out = torch.zeros(4, dtype=torch.int64, device=dev)
    launch("split_division_mismatches", (out,), dev)
    differ, fast, first, _ = out.tolist()
    assert differ == 0, hex(first)
    assert fast > (1 << 32) * 128 // 2


@pytest.mark.parametrize("n", [1, 31, 257, 100_000])
@pytest.mark.parametrize("kind,f64,masked", [("mixed", False, True), ("mixed", True, False),
                                             ("cdf", False, False), ("dead", False, True)])
def test_multinomial4_split_kernel_matches_plain(n, kind, f64, masked):
    dev = _card()
    counts, probs, z, u, mask, valid = _split_inputs(n, kind, dev, f64)
    more = (mask, valid) if masked else ()
    before = multinomial4_split.launches
    got = multinomial4_split(counts, probs, z, u, *more)
    torch.cuda.synchronize()
    assert multinomial4_split.launches == before + 1
    want = multinomial4_split_ref(counts, probs, z, u, *more)
    stats = split_branches(counts, probs, z, u, *more[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = multinomial4_split(counts, probs, z, u, *more)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    if not masked:
        assert torch.equal(got[0].sum(-1), counts)          # row sums exact
    if kind == "cdf":
        assert stats["gauss"] < stats["cdf"] and stats["cdf_longest"] > (0 if n < 257 else 20)
    if kind == "dead":
        assert stats["dead_rows"] == n and not bool(got[1].any())


@pytest.mark.parametrize("cap", [1, 31, 257, 1027, 4099, 100_000, 1_000_003])
@pytest.mark.parametrize("fill", [0.0, 0.07, 0.3, 1.0])
def test_compact_children_kernel_matches_plain(cap, fill):
    dev = _card()
    rng = np.random.default_rng(cap)
    t = lambda x: torch.as_tensor(x, device=dev)
    a, b = t(rng.integers(0, 1 << 12, cap)), t(rng.integers(0, 1 << 12, cap))
    w = t(rng.uniform(0, 1, (cap, 4)))
    flags = t(rng.uniform(0, 1, (cap, 4)) < fill)
    before = _compact_children.launches
    got = _compact_children(a, b, w, flags, 12, cap)
    torch.cuda.synchronize()
    assert _compact_children.launches == before + 1
    want = _compact_children_ref(a, b, w, flags, 12, cap)
    again = _compact_children(a, b, w, flags, 12, cap)
    for g, x, y in zip(got, want, again):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, x) and torch.equal(g, y)
    if cap > 1000:
        assert (int(got[4]) > cap) == (fill > 0.25)        # 0.3 and 1.0 overflow


@pytest.mark.parametrize("beyond", [False, True])
def test_compact_children_kernel_owns_several_tiles_a_block(beyond):
    """A capacity of 1,000,000 (977 tiles of 1,024 rows), and a smaller one
    that still has more tiles than 1,024-thread blocks fit on the card at
    once (two an SM at most), so that blocks own several tiles; two calls in
    a row with other flags, so that the tile counts of the first cannot leak
    into the second."""
    from naqs_tpu_torch.ops.sampler_kernels import compact_tile_rows

    dev = _card()
    tile = compact_tile_rows()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cap = tile * (2 * sms + 5) + 3 if beyond else 1_000_000
    if beyond:
        assert -(-cap // tile) > 2 * sms
    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.randint(0, 1 << 20, (cap,), generator=gen, device=dev)
    b = torch.randint(0, 1 << 20, (cap,), generator=gen, device=dev)
    w = torch.rand((cap, 4), generator=gen, device=dev, dtype=torch.float64)
    for fill in (0.3, 0.05):
        flags = torch.rand((cap, 4), generator=gen, device=dev) < fill
        got = _compact_children(a, b, w, flags, 20, cap)
        want = _compact_children_ref(a, b, w, flags, 20, cap)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        assert (int(got[4]) > cap) == (fill > 0.25)


def _shell_step_inputs(cap, fill, dev):
    """(a, b, counts, valid, probs, z, u, mask) of one shell step on the card:
    the 'mixed' split rows of `_split_inputs` (both branches, corners), a
    share `fill` of them valid, prefix bits below 2^20."""
    counts, probs, z, u, mask, _ = _split_inputs(cap, "mixed", dev)
    gen = torch.Generator(device=dev).manual_seed(cap + 1)
    valid = torch.rand(cap, generator=gen, device=dev) < fill
    a = torch.randint(0, 1 << 20, (cap,), generator=gen, device=dev)
    b = torch.randint(0, 1 << 20, (cap,), generator=gen, device=dev)
    return a, b, counts, valid, probs, z, u, mask


# 1,000,003 rows are 3,907 tiles, more than the card holds blocks at once: later
# tiles start only as earlier ones finish, and look back at them
@pytest.mark.parametrize("cap", [1, 31, 257, 1027, 4099, 100_000, 1_000_003])
@pytest.mark.parametrize("fill", [0.0, 0.07, 0.3, 1.0])
def test_split_and_compact_kernel_matches_plain(cap, fill):
    from naqs_tpu_torch.ops.sampler_kernels import split_tile_rows

    dev = _card()
    args = _shell_step_inputs(cap, fill, dev)
    before = _split_and_compact.launches
    got = _split_and_compact(*args, 20, cap)
    torch.cuda.synchronize()
    assert _split_and_compact.launches == before + 1
    want = _split_and_compact_ref(*args, 20, cap)
    again = _split_and_compact(*args, 20, cap)
    for g, x, y in zip(got, want, again):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, x) and torch.equal(g, y)
    if fill == 0.0:
        assert int(got[4]) == 0
    if cap > 1000 and fill == 1.0:
        assert int(got[4]) > cap                                   # overflows
    if cap == 1_000_003:   # more tiles than blocks of 2,048 threads an SM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert -(-cap // split_tile_rows()) > 2048 // split_tile_rows() * sms


@pytest.mark.parametrize("cap", [257, 100_000, 1_000_003])
@pytest.mark.parametrize("f64", [False, True])
def test_split_and_compact_kernel_gates_on_the_previous_count(cap, f64):
    """n_live as a () int64 on the card (the previous shell's n_children) and
    as an int: 0, 1, a third of cap, cap and past cap, f32 and f64 probs,
    bitwise against the plain version with the same gate; two calls with
    other gates in a row, so that the first's cleared outputs and look-back
    words cannot leak into the second."""
    dev = _card()
    a, b, counts, valid, probs, z, u, mask = _shell_step_inputs(cap, 0.9, dev)
    if f64:
        probs = probs.double()
    for gate in (0, 1, cap // 3, cap, 4 * cap):
        for n_live in (torch.tensor(gate, device=dev), gate):
            args = (a, b, counts, valid, probs, z, u, mask, 9, cap, n_live)
            got = _split_and_compact(*args)
            want = _split_and_compact_ref(*args)
            assert all(torch.equal(g, x) for g, x in zip(got, want)), (gate, n_live)
        assert int(got[4]) <= 4 * min(gate, cap)
        if gate == 0:
            assert int(got[4]) == 0 and not bool(got[3].any())


def test_split_and_compact_under_cuda_graph_replay():
    """A shell step captured in a torch.cuda.CUDAGraph (the clear, then the
    kernel) and replayed on the same inputs, its outputs overwritten with
    other values before each replay: bitwise equal to an eager call every
    time. No cooperative launch, so nothing stands in the way of a graph."""
    dev = _card()
    cap = 100_000
    args = (*_shell_step_inputs(cap, 0.5, dev), 11, cap,
            torch.tensor(3 * cap // 4, device=dev))
    eager = _split_and_compact(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _split_and_compact(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _split_and_compact.launches
    with torch.cuda.graph(graph):
        captured = _split_and_compact(*args)
    assert _split_and_compact.launches == before + 1
    for fill in (0, 7, 1):
        for t in captured:
            t.fill_(fill)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(c, e) for c, e in zip(captured, eager)), fill
    assert int(eager[4]) > 0


@torch.no_grad()
def _two_kernel_sample(model, gen, n_samples, cap, beta):
    """sample()'s shell loop with the split and the compaction as two launches
    (multinomial4_split, then compact_children) on the same draws."""
    from naqs_tpu_torch.models.nade import amp_conditional_shell

    dev = next(model.parameters()).device
    a, b, counts, valid, overflow = sampler_mod._root(cap, float(n_samples), dev)
    shells = torch.arange(model.cfg.n_shells, device=dev)
    for j in range(model.cfg.n_shells):
        log_amp4, mask, probs = amp_conditional_shell(
            model, j, *sampler_mod._prefix_bits(a, b, shells))
        if beta != 1.0:
            probs = sampler_mod._temper(log_amp4, probs, beta)
        z, u = split_draws(gen, cap, dev)
        child_counts, child_valid = multinomial4_split(counts, probs, z, u, mask, valid)
        a, b, counts, valid, n_children = _compact_children(a, b, child_counts, child_valid, j,
                                                            cap)
        overflow = overflow | (n_children > cap)
    return sampler_mod._batch(model.cfg, a, b, counts, valid, overflow, shells)


@pytest.mark.parametrize("beta,cap", [(1.0, 512), (0.5, 512), (1.0, 64)])
def test_sample_on_the_card_equals_the_two_kernel_loop(beta, cap):
    """sample() through split_and_compact gives the batch, bit for bit, that the
    split and the compaction as two launches give from the same generator
    state; capacity 64 overflows."""
    from naqs_tpu_torch.models.nade import NADE

    dev = _card()
    cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), amp_hidden=(16,), phase_hidden=(8,))
    model = NADE(cfg, torch.Generator().manual_seed(3)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    state = gen.get_state()
    counts = (_split_and_compact.launches, multinomial4_split.launches,
              _compact_children.launches)
    got = sample(model, gen, 1e6, cap, beta=beta)
    assert (_split_and_compact.launches - counts[0], multinomial4_split.launches - counts[1],
            _compact_children.launches - counts[2]) == (cfg.n_shells, 0, 0)
    gen.set_state(state)
    want = _two_kernel_sample(model, gen, 1e6, cap, beta)
    for f in ("states", "counts", "n_unique", "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.overflow) == (cap == 64) and int(got.n_unique) > 0


def test_sample_on_the_card_conserves_and_sorts():
    dev = _card()
    cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), amp_hidden=(16,), phase_hidden=(8,),
                        masking="full")
    from naqs_tpu_torch.models.nade import NADE

    model = NADE(cfg, torch.Generator().manual_seed(0)).to(dev)
    hil = nt.Hilbert(n_qubits=14, sectors=((5, 5),))
    counts = (_split_and_compact.launches, multinomial4_split.launches,
              _compact_children.launches)
    batch = sample(model, torch.Generator(device=dev).manual_seed(1), 1e6, 512)
    assert (_split_and_compact.launches - counts[0], multinomial4_split.launches - counts[1],
            _compact_children.launches - counts[2]) == (cfg.n_shells, 0, 0)
    nu = int(batch.n_unique)
    states = batch.states.cpu().numpy()
    assert not bool(batch.overflow) and 0 < nu <= hil.size
    assert np.all(np.diff(states[:nu]) > 0) and np.all(hil.contains(states[:nu]))
    assert batch.counts.sum().item() == 1e6                  # full masking: nothing lost
    assert bool((batch.counts[nu:] == 0).all())
    dense = nt.sample_density(model, 1e-4, 512)
    assert 0 < int(dense.n_unique) <= nu + 512 and bool((dense.counts[:int(dense.n_unique)]
                                                         >= 1e-4).all())


def test_sampler_kernels_reject_bad_inputs():
    dev = _card()
    n = 8
    counts, probs, z, u, mask, valid = _split_inputs(n, "mixed", dev)
    a = torch.zeros(n, dtype=torch.int64, device=dev)
    w = torch.ones((n, 4), dtype=torch.float64, device=dev)
    wide = torch.ones((n, 8), device=dev)[:, :4]
    for bad in (lambda: multinomial4_split(counts.float(), probs, z, u),
                lambda: multinomial4_split(counts, wide, z, u),
                lambda: multinomial4_split(counts, probs.cpu(), z, u),
                lambda: multinomial4_split(counts, probs, z[:2], u),
                lambda: multinomial4_split(counts, probs, z, u, mask.int()),
                lambda: multinomial4_split(counts, probs, z, u, mask, valid[:-1]),
                lambda: multinomial4_split(torch.ones(n + 1, dtype=torch.float64,
                                                      device=dev)[1:], probs, z, u),
                lambda: _compact_children(a.int(), a, w, mask, 0, n),
                lambda: _compact_children(a, a, w.t().contiguous().t(), mask, 0, n),
                lambda: _compact_children(a, a, w, mask.cpu(), 0, n),
                lambda: _compact_children(a, a, w, mask, 0, n - 1),
                lambda: _split_and_compact(a, a, counts, valid, probs.half(), z, u, mask, 0,
                                           n),
                lambda: _split_and_compact(a, a, counts, valid, wide, z, u, mask, 0, n),
                lambda: _split_and_compact(a, a, counts, valid.cpu(), probs, z, u, mask, 0, n),
                lambda: _split_and_compact(a, a.int(), counts, valid, probs, z, u, mask, 0, n),
                lambda: _split_and_compact(a, a, counts, valid, probs, z, u, mask, 0, n,
                                           torch.tensor(1, device=dev).int()),
                lambda: _split_and_compact(a, a, counts, valid, probs, z, u, mask, 0, n,
                                           torch.tensor(1))):
        with pytest.raises(ValueError):
            bad()
    # the library refuses a tile-count scratch shorter than the capacity's tiles
    from naqs_tpu_torch.ops.sampler_kernels import compact_tile_rows, launch, split_tile_rows

    cap = compact_tile_rows() + 1
    ab = torch.zeros(cap, dtype=torch.int64, device=dev)
    args = (ab, ab, torch.zeros((cap, 4), dtype=torch.float64, device=dev),
            torch.zeros((cap, 4), dtype=torch.bool, device=dev), torch.empty_like(ab),
            torch.empty_like(ab), torch.empty(cap, dtype=torch.float64, device=dev),
            torch.empty(cap, dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int64, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev), 1, cap, 0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch("compact_children", args, dev)
    f32 = torch.zeros((cap, 4), device=dev)
    draws = torch.zeros((3, cap), device=dev)
    tiles = torch.zeros(-(-cap // split_tile_rows()), dtype=torch.int64, device=dev)  # no ticket
    fused = (ab, ab, args[6], args[7], f32, draws, draws, args[3], None, cap, *args[4:9], tiles,
             tiles.numel(), tiles, tiles.numel() * 8, cap, 0, 0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch("split_and_compact", fused, dev)


# (table rows U, live n_valid, chunk rows C, flip masks K, qubits): small and
# ragged shapes, n_valid 0, 1 and U (no padding), and the N2 6-31G chunk of
# the main path (C = 128, Kxy = 27,392, capacity 100,000, 36 qubits)
SORT_SHAPES = [(1, 1, 3, 5, 12), (300, 0, 17, 33, 20), (300, 1, 17, 33, 20),
               (4096, 3000, 77, 1000, 40), (5000, 5000, 64, 513, 36),
               (100_000, 81_234, 128, 27_392, 36)]


def _sort_inputs(u, n_valid, n_rows, n_cols, n_qubits, dev):
    """(states, la, ph, n_valid, s, xy, my_la, my_ph, live) on the card: a
    sorted buffer of n_valid random states padded with SENTINEL to u; chunk
    rows from the buffer and two SENTINEL rows; a third of the flip masks join
    two buffer states (hits), a tenth are 0 (padding), the rest random."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    rng = np.random.default_rng(n_rows + n_cols)
    states = np.full(u, SENTINEL, np.int64)
    pool = np.unique(rng.integers(0, 1 << n_qubits, size=2 * n_valid + 8, dtype=np.int64))
    states[:n_valid] = np.sort(rng.choice(pool, size=n_valid, replace=False))
    la = (-rng.uniform(0, 3, size=u)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=u).astype(np.float32)
    s = states[rng.integers(0, max(n_valid, 1), size=n_rows)]
    s[-min(2, n_rows):] = SENTINEL
    xy = rng.integers(1, 1 << n_qubits, size=n_cols, dtype=np.int64)
    if n_valid > 1:
        third = n_cols // 3
        xy[:third] = s[rng.integers(0, n_rows, size=third)] ^ states[
            rng.integers(0, n_valid, size=third)]
        xy[:third] = np.where(xy[:third] < 0, 1, xy[:third])   # a SENTINEL row's
    xy[rng.random(n_cols) < 0.1] = 0
    my_la = (-rng.uniform(0, 3, size=n_rows)).astype(np.float32)
    my_ph = rng.uniform(-np.pi, np.pi, size=n_rows).astype(np.float32)
    live = rng.random(n_rows) < 0.8
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(states), t(la), t(ph), torch.tensor(n_valid, device=dev), t(s), t(xy),
            t(my_la), t(my_ph), t(live))


@pytest.mark.parametrize("u,n_valid,n_rows,n_cols,n_qubits", SORT_SHAPES)
def test_sorted_ratio_rowsum_kernel_matches_plain(u, n_valid, n_rows, n_cols, n_qubits):
    dev = _card()
    states, la, ph, nv, s, xy, my_la, my_ph, _ = _sort_inputs(u, n_valid, n_rows, n_cols,
                                                              n_qubits, dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    h = (0.1 * torch.randn((n_rows, n_cols), generator=gen)).to(dev)
    args = (states, la, ph, nv, s, xy, my_la, my_ph, h)
    before = sorted_ratio_rowsum.launches
    got = sorted_ratio_rowsum(*args)
    torch.cuda.synchronize()
    assert sorted_ratio_rowsum.launches == before + 1
    want = sorted_ratio_rowsum_ref(*args)
    tol = rowsum_tolerance(sorted_log_amps(states, la, nv, s, xy), my_la, h)
    for g, w in zip(got, want):
        assert g.shape == (n_rows,) and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())
    if n_valid > 1:
        assert float(want[0].abs().max()) > 1e-3   # hits: the sums are not all 0
    again = sorted_ratio_rowsum(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got))   # no atomics


@pytest.mark.parametrize("u,n_valid,n_rows,n_cols,n_qubits", SORT_SHAPES)
def test_sorted_gather2_kernel_matches_plain(u, n_valid, n_rows, n_cols, n_qubits):
    dev = _card()
    states, la, ph, nv, s, xy, _, _, live = _sort_inputs(u, n_valid, n_rows, n_cols,
                                                         n_qubits, dev)
    args = (states, la, ph, nv, s, xy, live)
    before = sorted_gather2.launches
    got = sorted_gather2(*args)
    torch.cuda.synchronize()
    assert sorted_gather2.launches == before + 1
    want = sorted_gather2_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == (n_rows, n_cols) and torch.equal(g, w)
    if n_valid > 1:
        assert int((want[0] > -200).sum()) > n_rows   # found beyond the rows themselves


def test_sort_kernels_agree_with_the_rank_kernels():
    """On a space that has a RankSpec the sort kernels find what the rank
    kernels find: sorted_gather2 equals rank_gather2's gather bitwise where
    found, and sorted_ratio_rowsum gives rank_ratio_rowsum's bits (the same
    loop and reduction on the same hits)."""
    dev = _card()
    spec, table, s, xy, my_la, my_ph, states, la, ph = _inputs(((5, 5),), 26, 512, 4608, dev,
                                                              hits=True, buffer=True)
    h = torch.full((s.shape[0], xy.shape[0]), 0.01, device=dev)
    nv = torch.tensor(states.shape[0], device=dev)
    r = rank_ratio_rowsum(spec, s, xy, table, my_la, my_ph, h)
    q = sorted_ratio_rowsum(states, la, ph, nv, s, xy, my_la, my_ph, h)
    assert all(torch.equal(a, b) for a, b in zip(r, q))
    live = torch.ones(s.shape[0], dtype=torch.bool, device=dev)
    g_la, g_ph = rank_gather2(spec, s, xy, table)
    q_la, q_ph = sorted_gather2(states, la, ph, nv, s, xy, live)
    hit = g_la > -1e29
    assert torch.equal(hit, q_la > -200) and int(hit.sum()) > 0
    assert torch.equal(g_la[hit], q_la[hit]) and torch.equal(g_ph[hit], q_ph[hit])


def _grouped(terms, dev):
    """(yz_unique, xy_ptr, term_yz, term_coeff) of the terms, as DeviceTerms
    holds them on the card."""
    dt = le.DeviceTerms.from_terms(terms, dense_a=False, device=dev)
    return dt.yz_unique, dt.xy_ptr, dt.term_yz, dt.term_coeff


@pytest.mark.parametrize("name,n_rows", [("N2_STO-3G_gen", 1), ("N2_STO-3G_gen", 37),
                                         ("N2_STO-3G_gen", 2048), ("H2O_6-31G_gen", 512)])
def test_offdiag_h_terms_kernel_matches_plain(name, n_rows):
    """The H row of real terms (groups of 1 to 50 terms, padded empty groups)
    on random sector states and a SENTINEL row, against the plain segment sum."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    dev = _card()
    mol = nt.load_molecule(name)
    terms = nt.compile_pauli_terms(mol.qubit_hamiltonian, mol.n_qubits)
    hil = nt.Hilbert.for_molecule(mol)
    rng = np.random.default_rng(n_rows)
    s = hil.basis[rng.integers(0, hil.size, size=n_rows)]
    if n_rows > 1:   # (every qubit occupied: the off-diagonal terms cancel there)
        s[-1] = SENTINEL
    args = (torch.as_tensor(s, device=dev), *_grouped(terms, dev))
    before = offdiag_h_terms.launches
    got = offdiag_h_terms(*args)
    torch.cuda.synchronize()
    assert offdiag_h_terms.launches == before + 1
    want = offdiag_h_terms_ref(*args)
    tol = offdiag_tolerance(args[2], args[4])
    assert got.shape == want.shape == (n_rows, args[2].shape[0] - 1)
    assert bool(((got - want).abs() <= tol[None, :]).all()), float((got - want).abs().max())
    assert float(want.abs().max()) > 1e-2
    assert torch.equal(offdiag_h_terms(*args), got)


def test_sort_engine_matches_rank_engine_on_the_card():
    """local_energy and quadratic_energy through the sort engine (rank_spec
    and dense set to None) against the rank engine on N2 STO-3G: with the
    dense A and without, one sorted_local_energy launch and one
    sorted_quadratic_energy launch, the two bitwise equal; the rank engine
    one rank_local_energy launch, bitwise equal with the dense A and without
    (it does not read A); the chunk loop the engines ran with the dense A
    before (P @ A and sorted_ratio_rowsum per chunk of 2,048) within 2e-4 Ha
    per live row of the rank engine."""
    dev = _card()
    terms, hil = _n2()
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    dt_rank = dataclasses.replace(dt, dense=None)
    dt_sort = dataclasses.replace(dt, rank_spec=None, dense=None)
    dt_seg = dataclasses.replace(dt_sort, a_mat=None)
    m = 3000
    s, la, ph = _n2_sample(hil, m, 4096, dev, seed=2)
    before = rank_local_energy.launches
    e_rank = le.local_energy(dt_rank, s, la, ph, m)
    e_rank_noa = le.local_energy(dataclasses.replace(dt_rank, a_mat=None), s, la, ph, m)
    assert rank_local_energy.launches == before + 2
    counts = (sorted_ratio_rowsum.launches, offdiag_h_terms.launches,
              sorted_local_energy.launches)
    e_sort = le.local_energy(dt_sort, s, la, ph, m)
    e_seg = le.local_energy(dt_seg, s, la, ph, m)
    assert (sorted_ratio_rowsum.launches, offdiag_h_terms.launches,
            sorted_local_energy.launches) == (counts[0], counts[1], counts[2] + 2)
    table, nv = pack_table(s, la, ph), torch.tensor(m, device=dev)
    loop = []
    for i in range(0, 4096, 2048):
        sc = s[i:i + 2048]
        h = parity_pm1(sc[:, None] & dt.yz_unique[None, :]).float() @ dt.a_mat   # P @ A
        r, im = sorted_ratio_rowsum(*table, nv, sc, dt.xy_unique, la[i:i + 2048].float(),
                                    ph[i:i + 2048].float(), h)
        loop.append((le.diagonal_energy(dt, sc) + r.double(), im.double()))
    assert sorted_ratio_rowsum.launches == counts[0] + 2
    e_loop = tuple(torch.cat([part[k] for part in loop]) for k in (0, 1))
    for r, r0, a, b, c in zip(e_rank, e_rank_noa, e_sort, e_seg, e_loop):
        assert torch.equal(r, r0) and torch.equal(a, b)
        assert float((a[:m] - r[:m]).abs().max()) < 2e-4
        assert float((c[:m] - r[:m]).abs().max()) < 2e-4
    q_rank = float(le.quadratic_energy(dt_rank, s, la, ph, m))
    before = (sorted_gather2.launches, sorted_quadratic_energy.launches)
    q_sort = float(le.quadratic_energy(dt_sort, s, la, ph, m))
    assert (sorted_gather2.launches, sorted_quadratic_energy.launches) == (before[0],
                                                                           before[1] + 1)
    assert abs(q_sort - q_rank) <= 1e-6 * abs(q_rank)


def test_sort_kernels_reject_bad_inputs():
    dev = _card()
    states, la, ph, nv, s, xy, my_la, my_ph, live = _sort_inputs(300, 200, 8, 16, 20, dev)
    h = torch.zeros((8, 16), device=dev)
    for bad in (lambda: sorted_ratio_rowsum(states, la, ph, 200, s, xy, my_la, my_ph, h),
                lambda: sorted_ratio_rowsum(states, la, ph, nv.int(), s, xy, my_la, my_ph, h),
                lambda: sorted_ratio_rowsum(states, la, ph, nv.cpu(), s, xy, my_la, my_ph, h),
                lambda: sorted_ratio_rowsum(states, la.double(), ph, nv, s, xy, my_la, my_ph, h),
                lambda: sorted_ratio_rowsum(states, la, ph, nv, s, xy, my_la, my_ph, h[:, :8]),
                lambda: sorted_ratio_rowsum(states, la, ph, nv, s, xy, my_la, my_ph,
                                            torch.zeros((8, 32), device=dev)[:, ::2]),
                lambda: sorted_gather2(states, la, ph, nv, s, xy, live.int()),
                lambda: sorted_gather2(states[:-1], la, ph, nv, s, xy, live),
                lambda: sorted_gather2(states, la, ph, nv, s.cpu(), xy, live)):
        with pytest.raises(ValueError):
            bad()
    terms, _ = _n2()
    yz_u, ptr, yz, co = _grouped(terms, dev)
    for bad in (lambda: offdiag_h_terms(s, yz_u, ptr.long(), yz, co),
                lambda: offdiag_h_terms(s, yz_u, ptr, yz, co.double()),
                lambda: offdiag_h_terms(s, yz_u, ptr, yz[:-1], co),
                lambda: offdiag_h_terms(s.cpu(), yz_u, ptr, yz, co)):
        with pytest.raises(ValueError):
            bad()


# (table rows U, live n_valid, query rows (None: the table itself), flip masks K,
# qubits): n_valid 0, 1 and around one 16-key window of the shared top (31, 32,
# 33); 100,000 live keys (a top of every 32nd); 600,000 (every 256th); and a
# 36-qubit buffer at capacity 100,000 with 20,000 live rows queried whole at
# N2 6-31G's flip-mask count, as local_energy queries it
ENERGY_SHAPES = [(1, 1, 3, 5, 12), (300, 0, 17, 33, 20), (300, 1, 17, 33, 20),
                 (300, 31, 40, 64, 20), (300, 32, 40, 64, 20), (300, 33, 40, 64, 20),
                 (4096, 3000, 77, 1000, 40), (100_000, 100_000, 300, 2048, 36),
                 (600_000, 600_000, 64, 512, 40), (100_000, 20_000, None, 27_392, 36)]


def _energy_inputs(u, n_valid, n_rows, n_cols, n_qubits, dev, pool=None):
    """sorted_local_energy's arguments on the card: a sorted buffer of n_valid
    random states (from `pool` if given) padded with SENTINEL to u; n_rows
    query rows drawn from its live states, every fifth SENTINEL (None: the
    buffer itself); n_cols flip masks below 2^n_qubits, a third joining a live
    query row to a live state, the last tenth 0 with no terms (padding);
    groups of 1-6 random terms; 257 random diagonal terms."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    rng = np.random.default_rng(n_cols + n_valid)
    states = np.full(u, SENTINEL, np.int64)
    if pool is None:
        pool = np.unique(rng.integers(0, 1 << n_qubits, size=2 * n_valid + 8, dtype=np.int64))
    states[:n_valid] = np.sort(rng.choice(pool, size=n_valid, replace=False))
    la = (-rng.uniform(0, 3, size=u)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=u).astype(np.float32)
    if n_rows is None:
        q, q_la, q_ph = states, la, ph
    else:
        q = (states[rng.integers(0, n_valid, size=n_rows)] if n_valid
             else rng.choice(pool, size=n_rows))
        q[::5] = SENTINEL
        q_la = (-rng.uniform(0, 3, size=n_rows)).astype(np.float32)
        q_ph = rng.uniform(-np.pi, np.pi, size=n_rows).astype(np.float32)
    live_q = q[q != SENTINEL]
    n_pad = n_cols // 10
    xy = rng.integers(1, 1 << n_qubits, size=n_cols, dtype=np.int64)
    if n_valid > 1 and len(live_q):
        third = n_cols // 3
        xy[:third] = live_q[rng.integers(0, len(live_q), size=third)] ^ states[
            rng.integers(0, n_valid, size=third)]
        xy[:third] = np.where(xy[:third] == 0, 1, xy[:third])
    xy[:n_cols - n_pad] = np.sort(xy[:n_cols - n_pad])
    xy[n_cols - n_pad:] = 0
    sizes = rng.integers(1, 7, size=n_cols)
    sizes[n_cols - n_pad:] = 0
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n_terms, n_yz = int(ptr[-1]), max(int(ptr[-1]) // 2, 1)
    yz_unique = np.sort(rng.integers(0, 1 << n_qubits, size=n_yz, dtype=np.int64))
    term_yz = rng.integers(0, n_yz, size=n_terms).astype(np.int32)
    term_coeff = (0.1 * rng.normal(size=n_terms)).astype(np.float32)
    diag_yz = rng.integers(0, 1 << n_qubits, size=257, dtype=np.int64)
    diag_coeff = rng.normal(size=257)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(states), t(la), t(ph), torch.tensor(n_valid, device=dev), t(q), t(q_la),
            t(q_ph), t(xy), t(ptr), t(term_yz), t(yz_unique), t(term_coeff), t(diag_yz),
            t(diag_coeff))


def _tolerance(args, chunk, h_exact=False):
    (states, la, _, nv, q, q_la, _, xy, ptr, term_yz, yz_unique, term_coeff, _,
     diag_coeff) = args
    return sorted_local_energy_tolerance(states, la, nv, q, q_la, xy, ptr, term_yz, yz_unique,
                                         term_coeff, diag_coeff, chunk_rows=chunk,
                                         h_exact=h_exact)


@pytest.mark.parametrize("u,n_valid,n_rows,n_cols,n_qubits", ENERGY_SHAPES)
def test_sorted_local_energy_kernel_matches_plain(u, n_valid, n_rows, n_cols, n_qubits):
    """Per row within the stated tolerance of the plain version and of this
    tree's two kernels composed chunk by chunk (the same h bits); padding rows
    their diagonal and 0; twice bitwise."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    dev = _card()
    args = _energy_inputs(u, n_valid, n_rows, n_cols, n_qubits, dev)
    before = sorted_local_energy.launches
    got = sorted_local_energy(*args)
    torch.cuda.synchronize()
    assert sorted_local_energy.launches == before + 1
    rows = args[4].shape[0]
    chunk = max(1, min(rows, (1 << 24) // n_cols))
    want = sorted_local_energy_ref(*args, chunk_rows=chunk)
    tol = _tolerance(args, chunk)
    for g, w in zip(got, want):
        assert g.shape == (rows,) and g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())
    pad = args[4] == SENTINEL
    assert bool((got[1][pad] == 0).all())
    if bool(pad.any()):
        assert bool((got[0][pad] == got[0][pad][0]).all())
    if n_valid > 1:
        assert float(want[1].abs().max()) > 1e-3   # hits: the sums are not all 0
    # this tree's two kernels, chunk by chunk: the same h bits
    (states, la, ph, nv, q, q_la, q_ph, xy, ptr, term_yz, yz_unique, term_coeff, diag_yz,
     diag_coeff) = args
    comp = []
    for i in range(0, rows, chunk):
        s = q[i:i + chunk]
        h = offdiag_h_terms(s, yz_unique, ptr, term_yz, term_coeff)
        comp.append(sorted_ratio_rowsum(states, la, ph, nv, s, xy, q_la[i:i + chunk],
                                        q_ph[i:i + chunk], h))
    diag = _diag(q, diag_yz, diag_coeff)
    exact = _tolerance(args, chunk, h_exact=True)
    for g, w in zip(got, (diag + torch.cat([c[0] for c in comp]).double(),
                          torch.cat([c[1] for c in comp]).double())):
        assert bool(((g - w).abs() <= exact).all()), float((g - w).abs().max())
    again = sorted_local_energy(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got))   # no atomics


def test_sorted_local_energy_rejects_bad_inputs():
    dev = _card()
    args = list(_energy_inputs(300, 200, 8, 16, 20, dev))

    def bad(i, value):
        return lambda: sorted_local_energy(*args[:i], value, *args[i + 1:])

    for call in (bad(3, 200), bad(3, args[3].int()), bad(3, args[3].cpu()),
                 bad(1, args[1].double()), bad(5, args[5][:-1]), bad(6, args[6].cpu()),
                 bad(8, args[8].long()), bad(11, args[11][:-1]), bad(13, args[13].float()),
                 bad(4, args[4].cpu()), bad(4, torch.zeros(16, dtype=torch.int64,
                                                            device=dev)[::2]),
                 bad(7, args[7][:-1])):
        with pytest.raises(ValueError):
            call()


def _diag(s, diag_yz, diag_coeff):
    """The f64 diagonal of states s, as diagonal_energy folds it."""
    from naqs_tpu_torch.utils.bits import parity_pm1

    return torch.sum(torch.where(parity_pm1(s[:, None] & diag_yz[None, :]) < 0, -diag_coeff,
                                 diag_coeff), dim=-1)


def _sector_pool(sectors, n_qubits, n, seed=0):
    """At least n distinct states of the space (all of it when it is small),
    drawn without listing a large basis."""
    h = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    if h.size <= 4 * n:
        return h.basis
    rng = np.random.default_rng(seed)
    shells = n_qubits // 2
    out = np.zeros(0, np.int64)
    while out.size < n:
        na, nb = sectors[rng.integers(0, len(sectors))]
        pos = np.argsort(rng.random((2 * n, 2, shells)), axis=-1)
        bits = np.zeros(2 * n, np.int64)
        for spin, k in ((0, na), (1, nb)):
            for j in range(k):
                bits |= np.int64(1) << (2 * pos[:, spin, j] + spin)
        out = np.unique(np.concatenate([out, bits]))
    return out


def _rank_energy_inputs(sectors, n_qubits, u, n_valid, n_rows, n_cols, dev):
    """(spec, rank value table, _energy_inputs(...)) with the buffer's states
    in the space's sectors."""
    spec = RankSpec.for_hilbert(nt.Hilbert(n_qubits=n_qubits, sectors=sectors))
    pool = _sector_pool(sectors, n_qubits, max(n_valid, n_rows or 0, 64))
    args = _energy_inputs(u, n_valid, n_rows, n_cols, n_qubits, dev, pool=pool)
    table = build_value_table(spec, args[0], args[1], args[2], args[3])
    return spec, table, args


def _chunk(rows, n_cols):
    return max(1, min(rows, (1 << 24) // n_cols))


# (sectors, qubits, buffer rows U, live n_valid, query rows (None: the buffer),
# flip masks K): no live state (every lookup a miss), one, three sectors, every
# state of a space live, H2O 6-31G's table at a main-path buffer, and frozen-core
# N2 6-31G's 32-qubit table (19,079,425 rows, 153 MB: out of L2) at its padded
# flip-mask count
RANK_ENERGY_SHAPES = [(((2, 2),), 8, 36, 0, 17, 33), (((3, 2),), 10, 100, 1, 17, 33),
                      (((5, 3), (4, 4), (3, 5)), 14, 4096, 2000, 77, 1000),
                      (((5, 5),), 14, 441, 441, None, 513),
                      (((5, 5),), 26, 100_000, 26_000, None, 4_608),
                      (((5, 5),), 32, 100_000, 20_000, None, 17_152)]


@pytest.mark.parametrize("sectors,n_qubits,u,n_valid,n_rows,n_cols", RANK_ENERGY_SHAPES)
def test_rank_local_energy_kernel_matches_plain(sectors, n_qubits, u, n_valid, n_rows, n_cols):
    """Per row within the stated tolerance of the plain version, and on the
    live rows of this tree's offdiag_h_terms + rank_ratio_rowsum composed chunk
    by chunk (the same h bits); padding rows their diagonal and 0; twice
    bitwise."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    dev = _card()
    spec, table, args = _rank_energy_inputs(sectors, n_qubits, u, n_valid, n_rows, n_cols,
                                            dev)
    (_, _, _, _, q, q_la, q_ph, xy, ptr, term_yz, yz_unique, term_coeff, diag_yz,
     diag_coeff) = args
    call = (spec, table, q, q_la, q_ph, xy, ptr, term_yz, yz_unique, term_coeff, diag_yz,
            diag_coeff)
    before = rank_local_energy.launches
    got = rank_local_energy(*call)
    torch.cuda.synchronize()
    assert rank_local_energy.launches == before + 1
    rows = q.shape[0]
    chunk = _chunk(rows, n_cols)
    want = rank_local_energy_ref(*call, chunk_rows=chunk)
    tol = rank_local_energy_tolerance(spec, table, q, q_la, xy, ptr, term_yz, yz_unique,
                                      term_coeff, diag_coeff, chunk_rows=chunk)
    for g, w in zip(got, want):
        assert g.shape == (rows,) and g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())
    pad = q == SENTINEL
    assert bool((got[1][pad] == 0).all())
    if bool(pad.any()):
        assert bool((got[0][pad] == got[0][pad][0]).all())
    if n_valid > 1:
        assert float(want[1].abs().max()) > 1e-3   # hits: the sums are not all 0
    exact = rank_local_energy_tolerance(spec, table, q, q_la, xy, ptr, term_yz, yz_unique,
                                        term_coeff, diag_coeff, chunk_rows=chunk, h_exact=True)
    for i in range(0, rows, chunk):   # the composition gives a SENTINEL row no meaning
        sl = slice(i, i + chunk)
        s, lv = q[sl], ~pad[sl]
        h = offdiag_h_terms(s, yz_unique, ptr, term_yz, term_coeff)
        r, im = rank_ratio_rowsum(spec, s, xy, table, q_la[sl], q_ph[sl], h)
        diag = _diag(s, diag_yz, diag_coeff)
        assert bool(((got[0][sl] - diag - r.double()).abs() <= exact[sl])[lv].all())
        assert bool(((got[1][sl] - im.double()).abs() <= exact[sl])[lv].all())
    again = rank_local_energy(*call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))   # no atomics


QUAD_SHAPES = [(((2, 2),), 8, 36, 0, 33), (((3, 2),), 10, 100, 1, 33),
               (((5, 3), (4, 4), (3, 5)), 14, 4096, 2000, 1000),
               (((5, 5),), 14, 441, 441, 513), (((5, 5),), 26, 100_000, 26_000, 4_608)]


@pytest.mark.parametrize("sectors,n_qubits,u,n_valid,n_cols", QUAD_SHAPES)
@pytest.mark.parametrize("lookup", ["rank", "sort"])
def test_quadratic_energy_kernel_matches_plain(lookup, sectors, n_qubits, u, n_valid, n_cols):
    """The one-launch quadratic form (n_valid a device tensor) per row within
    the stated tolerance of its plain version, rows at or past n_valid (0, 0),
    the quotient within 1e-6 relative, twice bitwise."""
    dev = _card()
    spec, _, args = _rank_energy_inputs(sectors, n_qubits, u, n_valid, None, n_cols, dev)
    states, la, ph, nv = args[:4]
    terms = args[7:]
    live = torch.arange(u, device=dev) < nv
    shift = la[:n_valid].max() if n_valid else 0.0
    la_q = torch.where(live, la - shift, QUAD_MISS).float()
    chunk = _chunk(u, n_cols)
    if lookup == "rank":
        table = build_value_table(spec, states, la_q, ph, nv, miss_log_amp=QUAD_MISS)
        call = (spec, table, nv, states, la_q, ph, *terms)
        fn, ref = rank_quadratic_energy, rank_quadratic_energy_ref
        tol = rank_quadratic_energy_tolerance(spec, table, nv, states, la_q, *terms[:5],
                                              terms[6], chunk_rows=chunk)
    else:
        call = (states, la_q, ph, nv, *terms)
        fn, ref = sorted_quadratic_energy, sorted_quadratic_energy_ref
        tol = sorted_quadratic_energy_tolerance(states, la_q, ph, nv, *terms[:5], terms[6],
                                                chunk_rows=chunk)
    before = fn.launches
    got = fn(*call)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(*call, chunk_rows=chunk)
    for g, w, t in zip(got, want, tol):
        assert g.shape == (u,) and g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= t).all()), float((g - w).abs().max())
        assert bool((g[n_valid:] == 0).all())
    if n_valid > 1:
        q_got, q_want = float(got[0].sum() / got[1].sum()), float(want[0].sum() / want[1].sum())
        assert abs(q_got - q_want) <= 1e-6 * abs(q_want)
        off = want[0] - want[1] * _diag(states, terms[5], terms[6])
        assert float(off[:n_valid].abs().max()) > 1e-6   # hits: found pairs add to num
    again = fn(*call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))   # no atomics


@pytest.mark.parametrize("kernel", ["rank_local_energy", "sorted_local_energy",
                                    "rank_quadratic_energy", "sorted_quadratic_energy"])
def test_one_launch_kernels_keep_offdiag_h_terms_bits(kernel):
    """On rows that find exactly one coupled state, with every log-amp and
    phase 0 and the diagonal's coefficients 0, each one-launch kernel's row
    sum is that pair's h: equal bit for bit to offdiag_h_terms' entry (the
    term walk adds a group's terms in index order, as that kernel does). N2
    STO-3G's terms, groups of 1 to 46 terms."""
    from naqs_tpu_torch.utils.bits import SENTINEL

    dev = _card()
    terms, hil = _n2()
    dt = le.DeviceTerms.from_terms(terms, dense_a=False, hilbert=hil, device=dev)
    rng = np.random.default_rng(5)
    xy = dt.xy_unique.cpu().numpy()
    real = np.flatnonzero(np.diff(dt.xy_ptr.cpu().numpy()) > 0)
    rows = rng.choice(hil.basis, size=16, replace=False)
    partners = []
    for s in rows:   # one in-sector coupled state of each row
        cand = s ^ xy[real]
        partners.append(rng.choice(cand[hil.contains(cand)]))
    buf = np.unique(np.concatenate([rows, partners]))
    n = len(buf)
    states = torch.as_tensor(np.concatenate([buf, np.full(8, SENTINEL)]), device=dev)
    zeros = torch.zeros(n + 8, device=dev)
    nv = torch.tensor(n, device=dev)
    q = states[:n, None] ^ dt.xy_unique[None, real]
    hit = torch.isin(q, states[:n])
    one = torch.nonzero(hit.sum(1) == 1).flatten()
    assert one.numel() >= 4
    k = torch.as_tensor(real, device=dev)[hit[one].int().argmax(1)]
    want = offdiag_h_terms(states[one], dt.yz_unique, dt.xy_ptr, dt.term_yz,
                           dt.term_coeff)[torch.arange(one.numel(), device=dev), k].double()
    assert float(want.abs().min()) > 0
    terms_args = (dt.xy_unique, dt.xy_ptr, dt.term_yz, dt.yz_unique, dt.term_coeff, dt.diag_yz,
                  torch.zeros_like(dt.diag_coeff))
    if kernel == "rank_local_energy":
        table = build_value_table(dt.rank_spec, states, zeros, zeros, nv)
        out = rank_local_energy(dt.rank_spec, table, states, zeros, zeros, *terms_args)
    elif kernel == "sorted_local_energy":
        out = sorted_local_energy(states, zeros, zeros, nv, states, zeros, zeros, *terms_args)
    elif kernel == "rank_quadratic_energy":
        table = build_value_table(dt.rank_spec, states, zeros, zeros, nv,
                                  miss_log_amp=QUAD_MISS)
        out = rank_quadratic_energy(dt.rank_spec, table, nv, states, zeros, zeros, *terms_args)
    else:
        out = sorted_quadratic_energy(states, zeros, zeros, nv, *terms_args)
    assert torch.equal(out[0][one], want)


def test_one_launch_dispatch_on_the_card():
    """Launch counts on each dispatch branch (N2 STO-3G, 4,096 rows):
    local_energy and quadratic_energy are one launch each of rank_* (a
    RankSpec) or sorted_* (none), with a dense A or without, and never
    offdiag_h_terms or a chunk kernel. Each within 2e-4 Ha per live row of
    the rank engine with a dense A, and quadratic_energy within 1e-6
    relative."""
    dev = _card()
    terms, hil = _n2()
    dt = le.DeviceTerms.from_terms(terms, hilbert=hil, device=dev)
    m = 3000
    s, la, ph = _n2_sample(hil, m, 4096, dev, seed=3)
    wrappers = (rank_local_energy, rank_quadratic_energy, sorted_local_energy,
                sorted_quadratic_energy, rank_ratio_rowsum, rank_gather2, sorted_ratio_rowsum,
                sorted_gather2, offdiag_h_terms)
    engines = {
        "rank": (dataclasses.replace(dt, dense=None), {"rank_local_energy": 1},
                 {"rank_quadratic_energy": 1}),
        "rank, no A": (dataclasses.replace(dt, dense=None, a_mat=None),
                       {"rank_local_energy": 1}, {"rank_quadratic_energy": 1}),
        "sort": (dataclasses.replace(dt, dense=None, rank_spec=None),
                 {"sorted_local_energy": 1}, {"sorted_quadratic_energy": 1}),
        "sort, no A": (dataclasses.replace(dt, dense=None, rank_spec=None, a_mat=None),
                       {"sorted_local_energy": 1}, {"sorted_quadratic_energy": 1}),
    }
    out = {}
    for label, (dt_e, want_le, want_q) in engines.items():
        before = {w.__name__: w.launches for w in wrappers}
        e = le.local_energy(dt_e, s, la, ph, m)
        mid = {w.__name__: w.launches for w in wrappers}
        qe = float(le.quadratic_energy(dt_e, s, la, ph, torch.tensor(m, device=dev)))
        after = {w.__name__: w.launches for w in wrappers}
        assert {k: v - before[k] for k, v in mid.items() if v != before[k]} == want_le, label
        assert {k: v - mid[k] for k, v in after.items() if v != mid[k]} == want_q, label
        out[label] = (e, qe)
    for label in ("rank, no A", "sort", "sort, no A"):
        for a, b in zip(out[label][0], out["rank"][0]):
            assert float((a[:m] - b[:m]).abs().max()) < 2e-4, label
        assert abs(out[label][1] - out["rank"][1]) <= 1e-6 * abs(out["rank"][1]), label


def test_one_launch_kernels_reject_bad_inputs():
    dev = _card()
    spec, table, args = _rank_energy_inputs(((3, 2),), 10, 100, 60, 8, 16, dev)
    (states, la, ph, nv, q, q_la, q_ph, *terms) = args
    good = (spec, table, q, q_la, q_ph, *terms)

    def bad(i, value, call=good, fn=rank_local_energy):
        return lambda: fn(*call[:i], value, *call[i + 1:])

    quad = (spec, table, nv, states, la, ph, *terms)
    sq = (states, la, ph, nv, *terms)
    for call in (bad(1, table[:-1]), bad(1, table.double()), bad(1, table.cpu()),
                 bad(2, q.cpu()), bad(3, q_la.double()), bad(6, terms[1].long()),
                 bad(11, terms[6].float()),
                 bad(2, nv.int(), quad, rank_quadratic_energy),
                 bad(2, 60, quad, rank_quadratic_energy),
                 bad(4, la[:-1], quad, rank_quadratic_energy),
                 bad(3, nv.cpu(), sq, sorted_quadratic_energy),
                 bad(1, la.double(), sq, sorted_quadratic_energy),
                 bad(5, terms[1][:-1], sq, sorted_quadratic_energy)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        rank_local_energy(spec, torch.zeros(2 * (spec.size + 1) + 1, device=dev)[1:].view(-1, 2),
                          *good[2:])


# ------------------------------------------------------------ the trainer's extras

def _n2_trainer(dev, save_loc=None, **tc):
    terms, hil = _n2()
    cfg = nt.NAQSConfig(n_qubits=20, sectors=hil.sectors, amp_hidden=(32,), phase_hidden=(64,))
    kw = dict(n_samples=1e5, n_unq_samples_min=100, n_unq_samples_max=4096, seed=5)
    return nt.VMCTrainer(cfg, terms, hil, nt.TrainConfig(**dict(kw, **tc)), device=dev,
                         save_loc=save_loc)


def test_clipped_steps_on_the_card_keep_the_ring_on_the_card():
    """Clipped training steps on N2 STO-3G: the ring and its count live on the
    card, move once per applied update, and a withheld (overflowing) update
    leaves them as they were."""
    dev = _card()
    tr = _n2_trainer(dev, grad_clip_factor=1.2)
    assert tr.clip.norms.device.type == "cuda" and tr.clip.count.device.type == "cuda"
    for i in range(4):
        out = tr.step()
        assert np.isfinite(out["e_loc"]) and 0 < out["clip_scale"] <= 1.0
        assert int(tr.clip.count) == i + 1
    assert bool((tr.clip.norms[:4] > 0).all())
    ring = tr.clip.state_dict()
    batch = tr._sample()
    bad = dataclasses.replace(batch, overflow=torch.tensor(True, device=dev))
    m = nt.trainer.vmc_update(tr.model, tr.optimizer, tr.scheduler, tr.dt, bad, clip=tr.clip)
    assert not m["applied"]
    assert torch.equal(tr.clip.norms, ring["norms"]) and int(tr.clip.count) == 4


def test_run_density_on_the_card_runs_compact_children():
    dev = _card()
    tr = _n2_trainer(dev)
    before = (_compact_children.launches, _split_and_compact.launches)
    tr.run_density(1, d_p=1e-5)
    assert _split_and_compact.launches == before[1]
    assert (_compact_children.launches - before[0]) % tr.cfg.n_shells == 0
    assert _compact_children.launches > before[0]
    assert tr.n_steps == 1 and tr.sampled_counter and np.isfinite(tr.log["E_LOC"][-1][1])


@pytest.mark.parametrize("engine", ["dense", "rank", "sort"])
def test_exact_window_on_the_card_has_no_host_sync(engine):
    """Exact-sampling windows on N2 STO-3G's whole basis (clipped, n_train 4:
    the LR switches inside the window): after one window that warms the
    caches, a window of 3 steps under torch.cuda.set_sync_debug_mode("error")
    (any synchronizing call raises) ends within rtol 1e-5 / atol 1e-7 of 3
    vmc_update calls from the same state, with the same Adam step counts,
    LR position and clip count."""
    dev = _card()
    a, b = (_n2_trainer(dev, grad_clip_factor=2.0, n_train=4) for _ in range(2))
    if engine != "dense":
        off = dict(dense=None) if engine == "rank" else dict(rank_spec=None, dense=None)
        a.dt = b.dt = dataclasses.replace(a.dt, **off)
    full = a._basis_batch(a.hilbert.basis)
    for tr in (a, b):
        nt.trainer.vmc_update_scan(tr.model, tr.optimizer, tr.scheduler, tr.dt, full, 1,
                                   length=1, clip=tr.clip)
    window = nt.trainer.UpdateWindow(a.model, a.optimizer, a.scheduler, 3, a.clip)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            window.step(a.dt, full)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ms, applied = window.close()
    rows = [nt.trainer.vmc_update(b.model, b.optimizer, b.scheduler, b.dt, full, True,
                                  clip=b.clip) for _ in range(3)]
    assert applied.all() and np.isfinite(ms).all()
    np.testing.assert_allclose(ms[:, 0], [m["e_loc"] for m in rows], rtol=1e-6)
    for (k, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7, msg=k)
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert float(sa["step"]) == float(sb["step"]) == 4
        torch.testing.assert_close(sa["exp_avg"], sb["exp_avg"], rtol=1e-5, atol=1e-7)
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == 4
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    assert int(a.clip.count) == int(b.clip.count) == 4


def test_run_exact_on_the_card():
    """run_exact on N2 STO-3G with exact local energies: 3 full-basis steps
    (one window, one dense_grid_accumulate launch a step) and 2 minibatch
    steps of 2,000 states against the sector table; finite energies."""
    dev = _card()
    tr = _n2_trainer(dev, exact_eloc=True, eloc_fwd_chunk=4096)
    assert tr._table[0].shape[0] == 16_384 and int(tr._table[1]) == 14_400
    before = dense_grid_accumulate.launches
    tr.run_exact(3)
    assert dense_grid_accumulate.launches - before == 3
    tr.run_exact(2, batch_size=2000)
    assert dense_grid_accumulate.launches - before == 5
    assert [s for s, _ in tr.log["E_LOC"]] == [1, 2, 3, 4, 5]
    assert np.isfinite([v for _, v in tr.log["E_LOC"]]).all()


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """save / load restores the model, Adam, the clip ring and the card's
    generator bitwise; the next step draws the same batch and gives the same
    energy within the engines' 2e-4 Ha (bitwise where every kernel of the
    step repeats its bits)."""
    dev = _card()
    tr = _n2_trainer(dev, save_loc=str(tmp_path), grad_clip_factor=2.0)
    for _ in range(6):
        tr.step()
    tr.save()
    back = _n2_trainer(dev, save_loc=str(tmp_path), grad_clip_factor=2.0, seed=9).load()
    for (k, a), (_, b) in zip(tr.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(tr.clip.norms, back.clip.norms)
    assert torch.equal(tr.gen.get_state(), back.gen.get_state())
    assert back.sampled_counter == tr.sampled_counter and back.n_steps == tr.n_steps
    state = tr.gen.get_state()
    b1 = tr._sample()
    tr.gen.set_state(state)
    b2 = back._sample()
    assert torch.equal(b1.states, b2.states) and torch.equal(b1.counts, b2.counts)
    tr.gen.set_state(state)
    back.gen.set_state(state)
    a, b = tr.step(), back.step()
    assert a["n_unique"] == b["n_unique"] and abs(a["e_loc"] - b["e_loc"]) <= 2e-4


# ------------------------------------------------------------ the CLI and the NADE variants

_CLI_RUNS = {
    # chip_smoke.py phase 13's run A at a small width: H2O 6-31G, FactorTerms,
    # four LUT shells, the H + 0.5 S^2 training operator, exact energies
    "A": (["-m", "H2O_6-31G_gen", "-n_hid", "8", "-single_phase", "-n_hid_phase", "16",
           "-n_layer_phase", "2", "-n_lut", "4", "-lr_lut", "1e-2", "-s2_penalty", "0.5",
           "-pretrain_hf", "2", "-presolveH", "-n_train", "3", "-output_freq", "5",
           "-n_unq_samps_max", "100000", "-s", "7"],
          ("split_and_compact", "factored_cells_accumulate", "rank_quadratic_energy")),
    # run B's: N2 STO-3G, DenseTerms, combined trunk, integer inputs, a trace
    "B": (["-m", "N2_STO-3G_gen", "-n_hid", "8", "-comb_amp_phase", "-input_encoding",
           "integer", "-n_lut", "3", "-presolveH", "-n_train", "3", "-output_freq", "5",
           "-profile", "-s", "7"],
          ("split_and_compact", "dense_grid_accumulate", "rank_quadratic_energy")),
}


@pytest.mark.parametrize("run", sorted(_CLI_RUNS))
def test_cli_runs_on_the_card(run, tmp_path, monkeypatch):
    """`naqs_tpu_torch.cli.run` with no -platform (the card), in process: each
    step's energy finite, the run's files written, and each kernel of its
    path launched."""
    _card()
    from naqs_tpu_torch import cli

    argv, kernels = _CLI_RUNS[run]
    monkeypatch.chdir(tmp_path)
    wrappers = {"split_and_compact": _split_and_compact,
                "factored_cells_accumulate": factored_cells_accumulate,
                "dense_grid_accumulate": dense_grid_accumulate,
                "rank_quadratic_energy": rank_quadratic_energy}
    for w in wrappers.values():
        w.launches = 0
    summary = cli.run(argv + ["-o", "out"])["run_0"]
    launched = {k: w.launches for k, w in wrappers.items()}
    assert all(launched[k] > 0 for k in kernels), launched
    lines = [json.loads(x) for x in open("out/log.jsonl")]
    e_loc = [x["value"] for x in lines if x["key"] == "E_LOC"]
    assert len(e_loc) == 3 and np.isfinite(e_loc).all()
    for name in ("summary.json", "args.json", "checkpoint.pt"):
        assert (tmp_path / "out" / name).exists(), name
    assert ("e_exact_final" in summary) == (run == "B")
    if run == "B":
        assert (tmp_path / "out" / "profile" / "trace.json").exists()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lut_sampler_on_the_card_matches_the_plain_path(dtype):
    """A LUT model's `sample()` on the card: every shell's split_and_compact
    (the f64 instantiation for float64 conditionals) bitwise equal to its plain
    version on the shell's inputs, and the sampled frequencies within
    4 sqrt(p(1-p)/n) + 5e-5 of |psi|^2 over N2 STO-3G's 14,400 states."""
    dev = _card()
    _, hil = _n2()
    cfg = nt.NAQSConfig(n_qubits=20, sectors=hil.sectors, amp_hidden=(16,), phase_hidden=(8,),
                        masking="full", num_lut=3, param_dtype=dtype)
    model = nade_t.NADE(cfg, torch.Generator().manual_seed(5)).to(dev)
    n, cap = 2e6, 16384
    calls = []
    kernel = sampler_mod._split_and_compact

    def spy(*args):
        calls.append(args)
        return kernel(*args)

    spy.launches = 0  # the wrapper counts its launches under its module name
    sampler_mod._split_and_compact = spy
    try:
        batch = sample(model, torch.Generator(device=dev).manual_seed(9), n, cap)
    finally:
        sampler_mod._split_and_compact = kernel
    assert len(calls) == cfg.n_shells and not bool(batch.overflow)
    want_dtype = torch.float64 if dtype == "float64" else torch.float32
    for args in calls:
        assert args[4].dtype == want_dtype
        got = kernel(*args)
        ref = _split_and_compact_ref(*args)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    nu = int(batch.n_unique)
    basis = torch.as_tensor(hil.basis, device=dev)
    with torch.no_grad():
        la = nade_t.log_psi(model, basis)[0].double()
    p = torch.exp(2 * la)
    p = (p / p.sum()).cpu().numpy()
    idx = hil.state_to_index(batch.states[:nu].cpu().numpy())
    freqs = batch.counts[:nu].cpu().numpy() / n
    tol = 4.0 * np.sqrt(p[idx] * (1 - p[idx]) / n) + 5e-5
    assert np.all(np.abs(freqs - p[idx]) < tol)
    assert freqs.sum() > 0.999


@pytest.mark.parametrize("optimizer", ["sr", "kfac"])
def test_natural_gradient_update_on_the_card_has_no_host_sync(optimizer):
    """On N2 STO-3G (DenseTerms): after two trainer steps, one sr_update (with
    kl_clip) or kfac_update on a sampled batch cut to its live rows runs
    under torch.cuda.set_sync_debug_mode("error") (any synchronizing call
    raises), launches dense_grid_accumulate once, and gives finite metrics;
    a K-FAC update advances the factors' step on the card."""
    from naqs_tpu_torch import kfac as kfac_mod
    from naqs_tpu_torch import sr as sr_mod
    from naqs_tpu_torch.sampler import SampleBatch

    dev = _card()
    tr = _n2_trainer(dev, **({"use_sr": True, "sr_cg_iters": 10} if optimizer == "sr"
                             else {"use_kfac": True}))
    for _ in range(2):
        assert np.isfinite(tr.step()["e_loc"])
    batch, n = tr._get_samples()
    live = SampleBatch(batch.states[:n], batch.counts[:n], batch.n_unique, batch.overflow)
    before = dense_grid_accumulate.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if optimizer == "sr":
            m = sr_mod.sr_update(tr.model, tr.dt, live, tr._current_lr(), tr.tc.sr_damping,
                                 cg_iters=10, kl_clip=1e-3)
        else:
            ks, m = kfac_mod.kfac_update(tr.model, tr.kfac_state, tr.dt, live, tr._current_lr())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dense_grid_accumulate.launches == before + 1
    assert all(np.isfinite(float(v)) for v in m.values())
    if optimizer == "kfac":
        assert ks["step"].device.type == "cuda" and int(ks["step"]) == 3
    else:
        assert int(m["cg_iters"]) == 10
