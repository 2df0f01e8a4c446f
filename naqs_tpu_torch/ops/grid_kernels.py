"""The grid E_loc engines' accumulation: sum_k H_k * T_k over sector-grid cells.

For a grid program `fn` (`ops/dense_engine.py::FactorTerms`) or `dn`
(`DenseTerms`) and the (Sa+1, Sb+1, 2) f32 value grid of the sampled set
(psi / max|psi| per cell, zero pad row and column):

* `factored_cells_accumulate(fn, grid, idx, n_rows)` -> (U, 2) f32, one row
  per entry of the (U,) int64 rank indices idx: for i < n_rows (a 0-d int64
  tensor on the grid's device) and a cell idx[i] = ra * Sb + rb of the
  sector, n_i = sum_k H_k(rb, ra) grid[pa_idx[ga_k, ra], pb_idx[gb_k, rb]]
  with H_k built on the fly from the mask's rank-1 parity factors; (0, 0)
  for every other row (at or past n_rows, SENTINEL or outside the sector);
* `dense_grid_accumulate(dn, grid)` -> (Sb, Sa, 2) f32 over the whole grid,
  n[rb, ra] = sum_k H_k(rb, ra) T_k(rb, ra) with H_k read from
  `h_dense[k, rb, ra]` and T_k(rb, ra) = grid[r1_idx[ka, ra], pb],
  row_map[k, rb] = ka (Sb+1) + pb;
* `xl_grid_accumulate(fn, grid)` for the staircase program `FactorTermsXL`
  and the (Sa*+1, Sb*+1, 2) grid of the restricted rectangle -> (n_cells, 2)
  f32, the numerator on the staircase cells in packed order (cell
  cells_off[ra] + rb): n = sum_k H_k(ra, rb) grid[pa_idx[ga_k, ra],
  pb_idx[gb_k, rb]], H_k from the mask's rank-1 factors.

They stand for the alpha gather, the transpose and the term-chunk scan of
`naqs_tpu/ops/dense_engine.py::factored_local_energy` (read at the cells its
readout reads) / `dense_local_energy` and the two stages per alpha-flip group
of `factored_xl_local_energy`, which the JAX package left to XLA. On a CUDA
tensor each wrapper launches its hand-written kernel in `csrc/grid_engine.cu`
(built by nvcc at first use) or raises; on a CPU tensor it runs the plain
PyTorch version (`*_ref`), which keeps the JAX order of steps: gather the
images, build H (per chunk of masks) and contract. There is no fallback from
one to the other. `<wrapper>.launches` counts kernel launches.
`factored_grid_accumulate_ref` is the factored program's plain version over
the whole grid, the tests' independent oracle of the cells version.

The factored cells kernel gives each live row to one warp, which stages the
cell's alpha-image and beta-image rows (`FactorTerms.pa_t`, `.pb_t`) in
shared memory, reads T only where both images lie in the sector and runs a
mask's factor loop only where T is not zero; the sign of a factor is
(-1)^popcount(alpha_word & ya ^ beta_word & yb) from the packed slots
(`FactorTerms.slots`), with no par_a or par_b. The dense kernel reads T
straight from the grid, transposed by the wrapper so that a block's reads
for one mask fall into one row. The XL kernel reads the grid as it is: its
first phase packs the set cells into two occupancy bitmaps
(`xl_occupancy_ref` is their plain version), and it runs a pair's T load and
factor loop only where the pair's grid cell is set (a clear cell adds
exactly zero), walking `FactorTermsXL.prog`, a static program of sign words
and coefficients, in an order of its own. The kernels sum with fused
multiply-adds in orders of their own and build H factor by factor, where the
plain versions build H by a batched product, so the two agree per cell
within GRID_ATOL + GRID_RTOL * sum_k sum_r |fcoeff| |T_k| (`grid_tolerance`),
not bitwise; the kernels themselves give the same bits in every run.

The dense kernel cuts the masks into `dense_ranges(K)` contiguous ranges,
range s holding masks [s K // S, (s + 1) K // S): each range's sums go to a
scratch (S, Sb, Sa, 2) tensor, and the last block of a cell tile to arrive
adds them in range order. It finds that it is last by an arrival counter
per (rb, tile of ra), which it sets back to 0: the counters
(`_arrival_counters`, one set per device and stream) are cleared once, when
they are made.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

# the builds pad the term axis to these multiples, as the JAX package's do;
# FACT_CHUNK_PAIRS masks also share one batched H build in the plain version
CHUNK_TERMS = 256
FACT_CHUNK_PAIRS = 16

GRID_ATOL = 1e-6   # of psi / max|psi| = 1: fp32 sums of up to Kxy terms near 0
GRID_RTOL = 1e-5   # of sum_k |H_k| |T_k|: fp32 order, fma against mul + add
# staircase cells one tile of the XL kernel covers: its 7 consumer warps of 32
# lanes with 3 cells each (csrc/grid_engine.cu's kXlWarps, kXlTileCells);
# FactorTermsXL.build cuts its tiles to it
XL_TILE_CELLS = 672
# int4s one chunk of the XL kernel's static program holds at most (a stage of
# its rings holds a chunk's headers: csrc/grid_engine.cu's kChunkInt4, which
# its C entry holds this value to)
XL_CHUNK_INT4 = 64
# set cells of a bitmap row that the XL kernel lists (and maps back through a
# mask's flip) rather than probing every cell of the tile (its kEnumMax)
XL_LIST_MAX = 128

# full-fp32 products in the plain version: TF32 passes cost ~1e-3 Ha on E_loc
torch.backends.cuda.matmul.allow_tf32 = False

_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def _r1t(grid, idx, sa):
    """(Ka * (Sb+1), Sa, 2): the alpha-permuted grid, transposed."""
    return grid[idx.long()].transpose(1, 2).reshape(-1, sa, 2)


def _contract(n, h, r1t, rows):
    """n += sum_k h[k] * r1t[rows[k]], mask by mask: no (KC, Sb, Sa, 2) copy."""
    for k in range(rows.shape[0]):
        n.addcmul_(h[k].unsqueeze(-1), r1t[rows[k]])


def factored_grid_accumulate_ref(fn, grid):
    """The factored program's plain version over the whole grid, (Sb, Sa, 2):
    R1t, then per chunk gather / build H / contract (the JAX package's scan)."""
    r1t = _r1t(grid, fn.pa_idx, fn.sa)
    n = torch.zeros((fn.sb, fn.sa, 2), dtype=torch.float32, device=grid.device)
    for c in range(0, fn.row_map.shape[0], FACT_CHUNK_PAIRS):
        sl = slice(c, c + FACT_CHUNK_PAIRS)
        pa = fn.par_a[fn.fa_idx[sl].long()]                  # (KC, R, Sa)
        pb = fn.par_b[fn.fb_idx[sl].long()] * fn.fcoeff[sl, :, None]  # (KC, R, Sb)
        _contract(n, torch.einsum("krb,kra->kba", pb, pa), r1t, fn.row_map[sl].long())
    return n


def _live_cells(idx, n_rows, sa, sb):
    """Rows i < n_rows whose rank index is a cell of the (Sa, Sb) sector, and
    their (ra, rb)."""
    live = (torch.arange(idx.shape[0], device=idx.device) < n_rows) & (idx >= 0) & \
        (idx < sa * sb)
    rows = torch.nonzero(live).squeeze(1)
    cell = idx[rows]
    return rows, cell // sb, cell % sb


def factored_cells_accumulate_ref(fn, grid, idx, n_rows):
    """Plain PyTorch version over the listed cells only: per chunk of masks,
    gather their T at each live cell, build H there by a batched product of
    the parity factors and contract; (0, 0) on every other row."""
    rows, ra, rb = _live_cells(idx, n_rows, fn.sa, fn.sb)
    pa_c, pb_c = fn.par_a[:, ra], fn.par_b[:, rb]                     # (Kya, V), (Kyb, V)
    ia, ib = fn.pa_idx[:, ra].long(), fn.pb_idx[:, rb].long()         # (Ka, V), (Kb, V)
    r = max(1, int(fn.n_fact.max()))
    n = torch.zeros((rows.shape[0], 2), dtype=torch.float32, device=grid.device)
    for c in range(0, fn.ga.shape[0], FACT_CHUNK_PAIRS):
        sl = slice(c, c + FACT_CHUNK_PAIRS)
        h = torch.einsum("krv,krv->kv", pa_c[fn.fa_idx[sl, :r].long()],
                         pb_c[fn.fb_idx[sl, :r].long()] * fn.fcoeff[sl, :r, None])  # (KC, V)
        t = grid[ia[fn.ga[sl].long()], ib[fn.gb[sl].long()]]          # (KC, V, 2)
        n += torch.einsum("kv,kvc->vc", h, t)
    out = torch.zeros((idx.shape[0], 2), dtype=torch.float32, device=grid.device)
    out[rows] = n
    return out


def dense_grid_accumulate_ref(dn, grid):
    """Plain PyTorch version: R1t, then the row gather and contraction."""
    r1t = _r1t(grid, dn.r1_idx, dn.sa)
    n = torch.zeros((dn.sb, dn.sa, 2), dtype=torch.float32, device=grid.device)
    _contract(n, dn.h_dense, r1t, dn.row_map.long())
    return n


def xl_grid_accumulate_ref(fn, grid):
    """Plain PyTorch version in the JAX package's order of steps: per bucket
    of chunks and per chunk (one alpha flip, up to 64 masks), per alpha block,
    stage 1 gathers the block's alpha-permuted rows of the grid sliced to the
    bucket's beta prefix `b_pneed` plus an explicit zero row (beta images past
    the prefix, or outside the rectangle, read it), stage 2 gathers the beta
    images and contracts them with H built by a batched product."""
    f32 = dict(dtype=torch.float32, device=grid.device)
    n_blocks = [torch.zeros((pw, cnt, 2), **f32) for _, cnt, pw in fn.blocks]
    sliced = {p: grid[:, :p] for p in {p for pn in fn.b_pneed for p in pn}}
    for pa_row, pb_row, fa, fb, fc, pneed in zip(fn.b_pa_row, fn.b_pb_row, fn.b_fa, fn.b_fb,
                                                 fn.b_fc, fn.b_pneed):
        for c in range(pa_row.shape[0]):
            pa_full = fn.pa_idx[pa_row[c].long()].long()           # (Sa*,)
            pbsel = fn.pb_idx[pb_row[c].long()]                    # (g, Sb*)
            par_a = fn.par_a[fa[c].long()]                         # (g, R, Sa*)
            par_b = fn.par_b[fb[c].long()] * fc[c][:, :, None]     # (g, R, Sb*)
            for k, (a_off, a_cnt, pw) in enumerate(fn.blocks):
                gk = sliced[pneed[k]][pa_full[a_off:a_off + a_cnt]]   # (a_cnt, pneed, 2)
                r1t = torch.cat([gk.transpose(0, 1), torch.zeros((1, a_cnt, 2), **f32)])
                t = r1t[torch.clamp(pbsel[:, :pw], max=pneed[k]).long()]  # (g, pw, a_cnt, 2)
                h = torch.einsum("grp,gra->gpa", par_b[:, :, :pw],
                                 par_a[:, :, a_off:a_off + a_cnt])
                n_blocks[k] += torch.stack([torch.einsum("gpa,gpa->pa", h, t[..., 0]),
                                            torch.einsum("gpa,gpa->pa", h, t[..., 1])], dim=-1)
    return torch.cat([blk.transpose(0, 1).reshape(-1, 2) for blk in n_blocks])


def _xl_row_words(n_bits):
    """int32 words of a bitmap row of n_bits: whole 16-byte pieces, for the
    XL kernel's bulk copies (csrc/grid_engine.cu's xl_row_words)."""
    return -(-n_bits // 128) * 4


def _bit_words(occ):
    """(R, C) bool -> (R, W) int32 bitmap rows, bit c of word w = column
    32 w + c, W = _xl_row_words(C)."""
    rows, cols = occ.shape
    words = _xl_row_words(cols)
    bits = torch.nn.functional.pad(occ, (0, words * 32 - cols)).view(rows, words, 32)
    w = (bits.to(torch.int64) << torch.arange(32, device=occ.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def xl_occupancy_ref(grid):
    """Plain version of the XL kernel's first phase: the set cells of the
    (Sa*+1, Sb*+1, 2) grid (either part nonzero) as (bits_a, bits_b, any_a,
    any_b): bits_a (Sa*+1, Wb) int32, bit c of word w of row a' the cell
    (a', 32 w + c); bits_b (Sb*+1, Wa) its transpose, bit i of word w of row b'
    the cell (32 w + i, b'); any_a, any_b int32 1 where a row of either is not
    all clear."""
    occ = (grid != 0).any(-1)
    return (_bit_words(occ), _bit_words(occ.t()), occ.any(1).to(torch.int32),
            occ.any(0).to(torch.int32))


def grid_tolerance(prog, grid, idx=None, n_rows=None):
    """Per-cell bound on |kernel - plain version|: (Sb, Sa, 2) for the dense
    program, (n_cells, 2) for the staircase, and for the factored program
    (U, 2), one per row of the cells call (idx, n_rows): the plain version
    run on absolute values (|fcoeff| with parities of 1, or |h_dense|, and
    |grid|), which bounds sum_k |H_k| |T_k| from above."""
    if hasattr(prog, "b_fc"):
        mag = xl_grid_accumulate_ref(
            dataclasses.replace(prog, b_fc=tuple(fc.abs() for fc in prog.b_fc),
                                par_a=torch.ones_like(prog.par_a),
                                par_b=torch.ones_like(prog.par_b)), grid.abs())
    elif hasattr(prog, "h_dense"):
        mag = dense_grid_accumulate_ref(
            dataclasses.replace(prog, h_dense=prog.h_dense.abs()), grid.abs())
    else:
        mag = factored_cells_accumulate_ref(
            dataclasses.replace(prog, fcoeff=prog.fcoeff.abs(),
                                par_a=torch.ones_like(prog.par_a),
                                par_b=torch.ones_like(prog.par_b)), grid.abs(), idx, n_rows)
    return GRID_ATOL + GRID_RTOL * mag


@lru_cache(maxsize=1)
def _lib():
    from naqs_tpu_torch.ops import _build

    lib = _build.load("grid_engine")
    lib.factored_cells_accumulate.argtypes = [_PTR] * 12 + [_INT] * 6 + [_PTR]
    lib.dense_grid_accumulate.argtypes = [_PTR] * 7 + [_INT] * 4 + [_PTR]
    lib.xl_grid_accumulate.argtypes = [_PTR] * 15 + [_INT] * 8 + [_PTR]
    lib.factored_cells_accumulate.restype = lib.dense_grid_accumulate.restype = _INT
    lib.xl_grid_accumulate.restype = _INT
    return lib


def _check(name, grid, sa, sb, want):
    """Raise on anything the kernels do not take: device, dtype, shape and, on
    the card, layout and index widths. `want` maps a field's name to (tensor,
    dtype, shape); the plain versions take strided CPU tensors."""
    dev = grid.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    want = dict(want, grid=(grid, torch.float32, (sa + 1, sb + 1, 2)))
    for key, (t, dtype, shape) in want.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name}: {key} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, grid on {dev}")
        dense = t.is_contiguous() or dev.type == "cpu"
        if t.dtype != dtype or tuple(t.shape) != shape or not dense:
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    if max(t.numel() for t, _, _ in want.values()) >= 1 << 31:
        raise ValueError(f"{name}: every tensor must hold fewer than 2^31 elements")


def dense_ranges(n_masks: int) -> int:
    """How many mask ranges the dense kernel sums apart: the JAX package's term
    chunks of CHUNK_TERMS masks, at least one."""
    return max(1, n_masks // CHUNK_TERMS)


_arrivals: dict = {}


def _arrival_counters(device, sb, sa):
    """The dense kernel's int32 arrival counters for an (Sb, Sa) grid on the
    device's current stream: one per (rb, tile of ra), at most one tile per
    warp. Zero between launches; made zero once, and again only to grow."""
    from naqs_tpu_torch.ops import _build

    return _build.zeroed_counters(_arrivals, device, sb * -(-sa // 32))


def _call(name, tensors, ints, device):
    """Call kernel `name`'s C entry of csrc/grid_engine.cu with the tensors'
    pointers and the ints, on the device's current stream; raise if the launch
    failed."""
    lib = _lib()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*(t.data_ptr() for t in tensors), *ints,
                                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def _launch(name, tensors, ints, grid, scratch=()):
    """Launch kernel `name` of csrc/grid_engine.cu on grid's current stream, on
    the transposed grid, with the scratch tensors after the output; returns
    the (Sb, Sa, 2) sums. Checks and counts nothing: the public wrappers do
    both."""
    sa, sb = ints[-2:]
    grid_t = grid.transpose(0, 1).contiguous()   # (Sb+1, Sa+1, 2): one row per beta image
    out = torch.empty((sb, sa, 2), dtype=torch.float32, device=grid.device)
    _call(name, (*tensors, grid_t, out, *scratch), ints, grid.device)
    return out


def factored_cells_accumulate(fn, grid: torch.Tensor, idx: torch.Tensor,
                              n_rows: torch.Tensor) -> torch.Tensor:
    """(U, 2) f32 numerator of the factored program `fn` at the cells of the
    first n_rows rank indices idx (U,) int64; (0, 0) for every other row.
    n_rows is a 0-d int64 tensor on the grid's device, read by the kernel."""
    sa, sb = fn.sa, fn.sb
    k, r = fn.fcoeff.shape
    ka, kb = fn.pa_idx.shape[0], fn.pb_idx.shape[0]
    i32, f32 = torch.int32, torch.float32
    _check("factored_cells_accumulate", grid, sa, sb, {
        "idx": (idx, torch.int64, (idx.shape[0],)), "n_rows": (n_rows, torch.int64, ()),
        "pa_idx": (fn.pa_idx, i32, (ka, sa)), "pb_idx": (fn.pb_idx, i32, (kb, sb)),
        "pa_t": (fn.pa_t, i32, (sa, -(-ka // 4) * 4)),
        "pb_t": (fn.pb_t, i32, (sb, -(-kb // 4) * 4)),
        "ga": (fn.ga, i32, (k,)), "gb": (fn.gb, i32, (k,)),
        "par_a": (fn.par_a, f32, (fn.par_a.shape[0], sa)),
        "par_b": (fn.par_b, f32, (fn.par_b.shape[0], sb)),
        "fa_idx": (fn.fa_idx, i32, (k, r)), "fb_idx": (fn.fb_idx, i32, (k, r)),
        "fcoeff": (fn.fcoeff, f32, (k, r)), "n_fact": (fn.n_fact, i32, (k,)),
        "alpha_words": (fn.alpha_words, i32, (sa,)), "beta_words": (fn.beta_words, i32, (sb,)),
        "slot_off": (fn.slot_off, i32, (k + 1,)),
        "slots": (fn.slots, i32, (fn.slots.shape[0], 4))})
    if grid.device.type == "cpu":
        return factored_cells_accumulate_ref(fn, grid, idx, n_rows)
    out = torch.empty((idx.shape[0], 2), dtype=f32, device=grid.device)
    if idx.shape[0]:
        _call("factored_cells_accumulate",
              (fn.pa_t, fn.pb_t, fn.ga, fn.gb, fn.alpha_words, fn.beta_words, fn.slot_off,
               fn.slots, grid, idx, n_rows, out),
              (k, idx.shape[0], sa, sb, fn.pa_t.shape[1], fn.pb_t.shape[1]), grid.device)
        factored_cells_accumulate.launches += 1
    return out


def dense_grid_accumulate(dn, grid: torch.Tensor) -> torch.Tensor:
    """(Sb, Sa, 2) f32 numerator grid of the dense program `dn`."""
    sa, sb = dn.sa, dn.sb
    k = dn.row_map.shape[0]
    _check("dense_grid_accumulate", grid, sa, sb, {
        "r1_idx": (dn.r1_idx, torch.int32, (dn.r1_idx.shape[0], sa)),
        "row_map": (dn.row_map, torch.int32, (k, sb)),
        "h_dense": (dn.h_dense, torch.float32, (k, sb, sa))})
    if grid.device.type == "cpu":
        return dense_grid_accumulate_ref(dn, grid)
    n_ranges = dense_ranges(k)
    partial = torch.empty((n_ranges, sb, sa, 2), dtype=torch.float32, device=grid.device)
    out = _launch("dense_grid_accumulate", (dn.r1_idx, dn.row_map, dn.h_dense),
                  (k, n_ranges, sa, sb), grid,
                  (partial, _arrival_counters(grid.device, sb, sa)))
    dense_grid_accumulate.launches += 1
    return out


def _xl_launch(fn, grid):
    """Launch the XL kernel on grid's current stream: (out, bits_a, bits_b,
    any_a, any_b), the packed sums and the first phase's bitmaps as
    `xl_occupancy_ref` gives them. Checks and counts nothing."""
    sa, sb, dev = fn.sa, fn.sb, grid.device
    bits_a = torch.empty((sa + 1, _xl_row_words(sb + 1)), dtype=torch.int32, device=dev)
    bits_b = torch.empty((sb + 1, _xl_row_words(sa + 1)), dtype=torch.int32, device=dev)
    anys = torch.zeros(sa + sb + 2, dtype=torch.int32, device=dev)
    out = torch.empty((fn.n_cells, 2), dtype=torch.float32, device=dev)
    grid_t = torch.empty((sb + 1, sa + 1, 2), dtype=torch.float32, device=dev)   # set cells only
    any_a, any_b = anys[:sa + 1], anys[sa + 1:]
    _call("xl_grid_accumulate",
          (fn.pa_idx, fn.pb_idx, fn.alpha_words, fn.beta_words, fn.cells_off, fn.tiles, fn.prog,
           fn.chunks, grid, grid_t, bits_a, bits_b, any_a, any_b, out),
          (fn.tiles.shape[0], fn.chunks.shape[0], fn.n_col_chunks, fn.prog.shape[0], sa, sb,
           XL_TILE_CELLS, XL_CHUNK_INT4), dev)
    return out, bits_a, bits_b, any_a, any_b


def xl_grid_accumulate(fn, grid: torch.Tensor) -> torch.Tensor:
    """(n_cells, 2) f32 numerator of the staircase program `fn` (FactorTermsXL)
    on the packed staircase cells."""
    sa, sb = fn.sa, fn.sb
    i32 = torch.int32
    n_chunks = fn.chunks.shape[0]
    want = {
        "pa_idx": (fn.pa_idx, i32, (fn.pa_idx.shape[0], sa)),
        "pb_idx": (fn.pb_idx, i32, (fn.pb_idx.shape[0], sb)),
        "alpha_words": (fn.alpha_words, i32, (sa,)), "beta_words": (fn.beta_words, i32, (sb,)),
        "cells_off": (fn.cells_off, i32, (sa + 1,)),
        "tiles": (fn.tiles, i32, (fn.tiles.shape[0], 4)),
        "prog": (fn.prog, i32, (fn.prog.shape[0], 4)), "chunks": (fn.chunks, i32, (n_chunks, 4))}
    _check("xl_grid_accumulate", grid, sa, sb, want)
    if not 0 <= fn.n_col_chunks <= n_chunks:
        raise ValueError(f"xl_grid_accumulate: n_col_chunks {fn.n_col_chunks} is not in "
                         f"[0, {n_chunks}]")
    if grid.device.type == "cpu":
        return xl_grid_accumulate_ref(fn, grid)
    out = _xl_launch(fn, grid)[0]
    xl_grid_accumulate.launches += 1
    return out


factored_cells_accumulate.launches = 0
dense_grid_accumulate.launches = 0
xl_grid_accumulate.launches = 0
