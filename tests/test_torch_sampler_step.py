"""The sampler's shell step of the port against naqs_tpu, on the same inputs.

On the CPU the port's wrappers run their plain versions
(`multinomial4_split_ref`, `_compact_children_ref`); the CUDA kernels of
`csrc/sampler_step.cu` are held against those on the card
(tests/test_torch_cuda.py). Here:

* the split against `naqs_tpu.ops.multinomial.multinomial4` on the same
  normal and uniform numbers, handed to the JAX function by patching
  `jax.random`: child counts equal exactly;
* the compaction against `naqs_tpu.sampler._compact_children`: all five
  outputs equal;
* the fused shell step's plain version `_split_and_compact_ref` against the
  JAX scan body (`multinomial4`, `* mask`, `& valid`, `_compact_children`) on
  the same draws: all five outputs equal;
* the tempered conditionals `sample(beta=...)` hands the shell step: float32
  and bit-equal to the JAX expression on the same log_amp4;
* `sample_density` against the JAX function on H2O STO-3G with converted
  parameters: states, n_unique and overflow equal, masses within 1e-6
  relative (the models' f32 conditionals differ by ulps between XLA and torch);
* a numpy replay of the compaction kernel's index arithmetic (tile counts, a
  grid-wide barrier, tile offsets, warp scans, zero fill, blocks that own
  several tiles) and of the fused kernel's single pass (tickets, each tile's
  look-back word seen empty, as an aggregate or inclusive by a successor in
  an interleaving drawn from a seed, the gate on the previous count, the
  cleared tail) against the plain versions;
* a numpy replay of the split kernel's inverse-CDF loop (blocks of four looks
  computed ahead of their tests, then the block's tests at once) against the
  plain loop's count, and the inputs of the decomposition of the split's
  time (`tools/split_timing.py`);
* the wrappers' input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naqs_tpu import sampler as sampler_j
from naqs_tpu.ops import multinomial as multinomial_j
from naqs_tpu_torch import sample_density
from naqs_tpu_torch import sampler as sampler_t
from naqs_tpu_torch.ops.multinomial import (_binomial_from_draws, multinomial4,
                                            multinomial4_split, multinomial4_split_ref,
                                            split_draws)
from naqs_tpu_torch.sampler import (_compact_children, _compact_children_ref,
                                    _split_and_compact, _split_and_compact_ref, sample)
from test_torch_cuda import split_branches
from test_torch_sampler import _setup
from test_torch_support import to_u64


def _jax_split(monkeypatch, counts, probs, z, u):
    """naqs_tpu's multinomial4, un-jitted, on the draws z, u (3, U): its calls
    of jax.random hand back the given arrays in the order it makes them
    (binomial i = 3, 2, 1: normal, then uniform)."""
    normals, uniforms = list(z), list(u)
    monkeypatch.setattr(jax.random, "split", lambda key, num=2: [None] * num)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(normals.pop(0), dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(uniforms.pop(0), dtype))
    out = multinomial_j.multinomial4(None, jnp.asarray(counts), jnp.asarray(probs))
    assert not normals and not uniforms
    return np.asarray(out)


def _split_case(name, rng, n):
    """(counts, probs) of n rows. 'cdf': small variances, so the inverse CDF
    (n = 20..5,000, p from 1e-4 to 0.9, so the flip too); 'gauss': large
    counts; 'corners': zero and unit probabilities, zero rows, n = 0, 1e12."""
    if name == "cdf":
        counts = np.floor(10 ** rng.uniform(np.log10(20), np.log10(5000), n))
        p = 10 ** rng.uniform(-4, np.log10(0.9), (n, 4))
        p[::2] /= counts[::2, None]                      # variance under 25
        p[::5, 3] = 0.9                                   # the flip at i = 3
        return counts, p.astype(np.float32)
    if name == "gauss":
        counts = np.floor(10 ** rng.uniform(3, 12, n))
        return counts, rng.uniform(0.01, 1.0, (n, 4)).astype(np.float32)
    counts = rng.choice([0.0, 1.0, 17.0, 1e6, 1e12], n)
    p = rng.uniform(0, 1, (n, 4)) * rng.integers(0, 2, (n, 4))   # q = 0 and 1 in the cascade
    p[::7] = 0.0                                                  # all-zero rows
    return counts, p.astype(np.float32)


@pytest.mark.parametrize("name", ["cdf", "gauss", "corners"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_split_matches_jax_on_the_same_draws(monkeypatch, name, dtype):
    rng = np.random.default_rng(["cdf", "gauss", "corners"].index(name))
    n = 4096
    counts, probs = _split_case(name, rng, n)
    probs = probs.astype(dtype)
    z = rng.standard_normal((3, n)).astype(np.float32)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    tensors = tuple(map(torch.as_tensor, (counts, probs, z, u)))
    got, got_valid = multinomial4_split_ref(*tensors)
    stats = split_branches(*tensors)
    want = _jax_split(monkeypatch, counts, probs, z, u)
    np.testing.assert_array_equal(got.numpy(), want)          # every count, exactly
    np.testing.assert_array_equal(got.numpy().sum(-1), counts)
    np.testing.assert_array_equal(got_valid.numpy(), want > 0)
    if name == "cdf":
        assert stats["cdf"] > n and stats["cdf_longest"] > 20
    if name == "gauss":
        assert stats["gauss"] > 2 * n
    if name == "corners":
        assert stats["dead_rows"] == int((counts == 0).sum()) > 0
        zero = ~probs.any(-1)
        np.testing.assert_array_equal(got.numpy()[zero, 0], counts[zero])


def test_split_applies_mask_and_valid():
    rng = np.random.default_rng(3)
    n = 512
    counts, probs = _split_case("cdf", rng, n)
    z, u = split_draws(torch.Generator().manual_seed(0), n, "cpu")
    mask = torch.as_tensor(rng.integers(0, 2, (n, 4)).astype(bool))
    valid = torch.as_tensor(rng.integers(0, 2, n).astype(bool))
    counts, probs = torch.as_tensor(counts), torch.as_tensor(probs)
    free, _ = multinomial4_split(counts, probs, z, u)
    got, got_valid = multinomial4_split(counts, probs, z, u, mask, valid)
    want = free * mask * valid[:, None]
    assert torch.equal(got, want) and torch.equal(got_valid, want > 0)
    assert multinomial4_split.launches == 0                       # a CPU tensor: no kernel
    only = multinomial4(torch.Generator().manual_seed(0), counts, probs)
    assert torch.equal(only, free)                                # the same draws inside


def _compact_case(rng, cap, fill):
    a = rng.integers(0, 1 << 12, cap)
    b = rng.integers(0, 1 << 12, cap)
    w = rng.uniform(0, 1, (cap, 4))
    valid = rng.uniform(0, 1, (cap, 4)) < fill
    return a, b, w, valid


@pytest.mark.parametrize("cap,fill,j", [(64, 0.1, 0), (64, 0.6, 12), (1000, 0.2, 5),
                                        (37, 1.0, 3), (16, 0.0, 0)])
def test_compact_children_ref_matches_jax(cap, fill, j):
    a, b, w, valid = _compact_case(np.random.default_rng(cap + j), cap, fill)
    got = _compact_children(*map(torch.as_tensor, (a, b, w, valid)), j, cap)
    want = sampler_j._compact_children(
        jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32), jnp.asarray(w),
        jnp.asarray(valid), jnp.int32(j), cap)
    assert (int(got[4]) > cap) == (fill > 0.5)                    # the overflowing cases
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert _compact_children.launches == 0


def _shell_case(name, fill, n, seed):
    """(a, b, counts, valid, probs, z, u, mask) of one shell step as numpy: the
    rows of `_split_case`, a share `fill` of them valid, 80% of the children
    allowed, prefix bits below 2^12."""
    rng = np.random.default_rng(seed)
    counts, probs = _split_case(name, rng, n)
    z = rng.standard_normal((3, n)).astype(np.float32)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    mask = rng.uniform(0, 1, (n, 4)) < 0.8
    valid = rng.uniform(0, 1, n) < fill
    a, b = rng.integers(0, 1 << 12, n), rng.integers(0, 1 << 12, n)
    return a, b, counts, valid, probs, z, u, mask


@pytest.mark.parametrize("name,fill", [("cdf", 0.2), ("gauss", 0.2), ("corners", 0.2),
                                       ("gauss", 1.0)])
def test_split_and_compact_ref_matches_jax_scan_body(monkeypatch, name, fill):
    """naqs_tpu/sampler.py:128-134 on the same draws: multinomial4, * mask,
    & valid, _compact_children; ("gauss", 1.0) overflows."""
    n, j = 1024, 12
    a, b, counts, valid, probs, z, u, mask = _shell_case(name, fill, n, 8)
    got = _split_and_compact_ref(*map(torch.as_tensor, (a, b, counts, valid, probs, z, u, mask)),
                                 j, n)
    child = jnp.asarray(_jax_split(monkeypatch, counts, probs, z, u)) * jnp.asarray(mask)
    child_valid = (child > 0) & jnp.asarray(valid)[:, None]
    want = sampler_j._compact_children(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32),
                                       child, child_valid, jnp.int32(j), n)
    assert (int(got[4]) > n) == (fill == 1.0) and int(got[4]) > 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert _split_and_compact.launches == 0


@pytest.mark.parametrize("beta", [0.25, 0.5, 0.8])
def test_tempered_probabilities_are_the_references(monkeypatch, beta):
    """The probabilities sample(beta=...) hands the shell step, caught at the
    split's wrapper, against naqs_tpu/sampler.py:125-127 on the same log_amp4:
    float32 and bit-equal."""
    _, _, _, model = _setup()
    seen = []
    shell, step = sampler_t.amp_conditional_shell, sampler_t._split_and_compact

    def caught_shell(*args):
        out = shell(*args)
        seen.append([out[0]])
        return out

    def caught_step(a, b, counts, valid, probs, *rest):
        seen[-1].append(probs)
        return step(a, b, counts, valid, probs, *rest)

    monkeypatch.setattr(sampler_t, "amp_conditional_shell", caught_shell)
    monkeypatch.setattr(sampler_t, "_split_and_compact", caught_step)
    batch = sample(model, torch.Generator().manual_seed(0), 1e5, 256, beta=beta)
    assert len(seen) == model.cfg.n_shells and int(batch.n_unique) > 0
    for log_amp4, probs in seen:
        pt = jnp.exp(2.0 * beta * jnp.asarray(log_amp4.numpy()).astype(jnp.float64))
        want = (pt / jnp.maximum(jnp.sum(pt, axis=-1, keepdims=True), 1e-300)).astype(
            jnp.float32)
        assert probs.dtype == torch.float32
        np.testing.assert_array_equal(probs.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_p,capacity", [(1e-3, 512), (1e-5, 512), (1e-5, 64)])
def test_sample_density_matches_jax(d_p, capacity):
    _, cfg_j, params, model = _setup()
    got = sample_density(model, d_p, capacity)
    want = sampler_j.sample_density(cfg_j, params, jnp.float64(d_p), capacity)
    assert int(got.n_unique) == int(want.n_unique) > 0
    assert bool(got.overflow) == bool(want.overflow) == (capacity == 64)
    np.testing.assert_array_equal(to_u64(got.states.numpy()), np.asarray(want.states))
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts), rtol=1e-6, atol=0)
    nu = int(got.n_unique)
    assert np.all(got.counts.numpy()[:nu] >= d_p) and np.all(got.counts.numpy()[nu:] == 0)


def _warp_scan(x):
    """Inclusive scan over each run of 32 lanes by the kernel's shuffle steps."""
    x = x.copy().reshape(-1, 32)
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(x)
        up[:, d:] = x[:, :-d]
        x = x + up
    return x


def _block_exclusive_scan(x):
    """The kernel's exclusive scan of one block's per-thread counts: warp
    scans, then a warp scan of the warps' sums."""
    block = len(x)
    incl = _warp_scan(x)
    warps = _warp_scan(np.resize(incl[:, 31], 32) * (np.arange(32) < block // 32))[0]
    below = np.concatenate([[0], warps[:block // 32 - 1]])
    return (below[:, None] + incl - x.reshape(-1, 32)).ravel()


def _tiled_replay(row_of, j, cap, block=1024, n_blocks=3, seed=0):
    """compact_children_kernel of csrc/sampler_step.cu (count_tiles, the grid
    barrier, scatter_tiles) in numpy: a cooperative grid of min(tiles,
    n_blocks) blocks of `block` threads, tiles of one row a thread, block i
    owning tiles i, i + n_blocks, ... row_of(rows) gives the rows' (flags
    (len, 4) bool, a, b, weights (len, 4)). Phase 1 gets the rows of each tile
    and counts its children into its scratch word, the blocks in a shuffled
    order, and each block keeps the rows of its first tile; after the barrier
    each block, again in a shuffled order, takes n_children and its first
    tile's offset from the tile counts, adds the counts since its previous
    tile for each later one (whose rows it gets again), scans the threads'
    counts, scatters the children and writes its tiles' own slots. Returns the
    five outputs and how often each tile's rows were got."""
    rng = np.random.default_rng(seed)
    n_tiles = -(-cap // block)
    grid = min(n_tiles, n_blocks)
    owned = [range(i, n_tiles, grid) for i in range(grid)]
    made = np.zeros(n_tiles, np.int64)

    def tile_rows(tile):
        """each thread's row, flags (none past cap), a, b and weights"""
        made[tile] += 1
        rows = tile * block + np.arange(block)
        pad = int((rows >= cap).sum())
        flags, ra, rb, rw = row_of(rows[rows < cap])
        return (rows, np.pad(np.asarray(flags, np.int64), ((0, pad), (0, 0))),
                np.pad(ra, (0, pad)), np.pad(rb, (0, pad)), np.pad(rw, ((0, pad), (0, 0))))

    kept = {}
    tile_counts = np.full(n_tiles, -7, np.int64)   # last launch's words: overwritten
    for i in rng.permutation(grid):
        for tile in owned[i]:
            got = tile_rows(tile)
            if tile == i:
                kept[i] = got
            tile_counts[tile] = got[1].sum()
    a_new, b_new = np.full(cap, -1, np.int64), np.full(cap, -1, np.int64)
    w_new, valid_new = np.full(cap, np.nan), np.zeros(cap, bool)
    n_children = None
    for i in rng.permutation(grid):
        total = int(tile_counts.sum())
        before = int(tile_counts[:i].sum())
        if i == 0:
            n_children = total
        for tile in owned[i]:
            if tile != i:
                before += int(tile_counts[tile - grid:tile].sum())
            rows, flags, ra, rb, rw = kept[i] if tile == i else tile_rows(tile)
            count = flags.sum(-1)
            dest = before + _block_exclusive_scan(count)
            for t in np.flatnonzero(count):
                d = dest[t]
                for occ in np.flatnonzero(flags[t]):
                    if d < cap:
                        assert a_new[d] == -1                        # one writer per slot
                        a_new[d] = ra[t] | ((occ & 1) << j)
                        b_new[d] = rb[t] | ((occ >> 1) << j)
                        w_new[d] = rw[t, occ]
                    d += 1
            own = rows[rows < cap]
            valid_new[own] = own < total
            dead = own[own >= total]
            assert np.all(a_new[dead] == -1)
            a_new[dead], b_new[dead], w_new[dead] = 0, 0, 0.0
    return (a_new, b_new, w_new, valid_new, n_children), made


def _compact_replay(a, b, w, valid, j, cap, block=1024, n_blocks=3, seed=0):
    """compact_children_kernel: `_tiled_replay` on the given flags and weights."""
    flags = valid.reshape(cap, 4)
    return _tiled_replay(lambda rows: (flags[rows], a[rows], b[rows], w[rows]), j, cap, block,
                         n_blocks, seed)[0]


# block: threads a block (tiles of `block` rows), over a grid of at most 3
# blocks: (203, 0.15, 64), (4096, 0.0, 1024) and the last five cases have more
# tiles than blocks (one of them overflows)
@pytest.mark.parametrize("cap,fill,block", [(2500, 0.2, 1024), (2500, 0.3, 1024),
                                            (1027, 0.05, 1024), (5, 0.5, 1024),
                                            (203, 0.15, 64), (4096, 0.0, 1024),
                                            (2500, 0.2, 64), (2500, 0.3, 64),
                                            (1027, 0.05, 32), (4099, 0.1, 128),
                                            (1030, 0.0, 32)])
def test_compaction_kernel_index_arithmetic(cap, fill, block):
    a, b, w, valid = _compact_case(np.random.default_rng(cap), cap, fill)
    got = _compact_replay(a, b, w, valid, 7, cap, block, n_blocks=3, seed=cap)
    want = _compact_children_ref(*map(torch.as_tensor, (a, b, w, valid)), 7, cap)
    assert (got[4] > cap) == (fill > 0.25)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())


def _lookback_replay(row_of, j, cap, block=256, gate=None, resident=4, seed=0):
    """split_and_compact_kernel of csrc/sampler_step.cu in numpy: one block of
    `block` threads per tile of as many rows, a single pass with decoupled
    look-back, on outputs and look-back words the library cleared first.

    Blocks start in a shuffled order, at most `resident` at a time (the card
    holds a few), and the running ones advance one step at a time in an order
    drawn from `seed`. A block whose tile lies at or past the gate (min(gate,
    cap), the rows that may be live) returns at once; the others take a ticket
    (their tile), get their rows below the gate from row_of(rows) ((flags
    (len, 4) bool, a, b, weights (len, 4)), as `_tiled_replay`), scan the
    threads' counts, publish the tile's count (tile 0: its inclusive prefix),
    look back 32 tiles a window as warp 0 does (waiting while any word of the
    window is empty and then reading again only those, summing down to the
    nearest inclusive word), publish the inclusive prefix, and scatter the
    children (one writer a slot). The last tile below the gate writes
    n_children. Returns the five outputs, how often each tile's rows were got
    and how many times a look-back read an empty, an aggregate and an
    inclusive word."""
    rng = np.random.default_rng(seed)
    gate = cap if gate is None else min(gate, cap)
    n_tiles = -(-cap // block)
    live_tiles = -(-gate // block)
    a_new, b_new = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    w_new, valid_new = np.zeros(cap), np.zeros(cap, bool)
    written = np.zeros(cap, bool)
    status, value = np.zeros(n_tiles, np.int64), np.zeros(n_tiles, np.int64)
    out = {"n_children": 0, "ticket": 0}
    made = np.zeros(n_tiles, np.int64)
    seen = np.zeros(3, np.int64)

    def run(block_idx):
        if block_idx >= live_tiles:
            return
        tile = out["ticket"]
        out["ticket"] += 1
        yield
        made[tile] += 1
        rows = tile * block + np.arange(block)
        live = rows < gate
        flags = np.zeros((block, 4), np.int64)
        ra, rb, rw = (np.zeros(block, np.int64), np.zeros(block, np.int64),
                      np.zeros((block, 4)))
        if live.any():
            f, x, y, w = row_of(rows[live])
            flags[live], ra[live], rb[live], rw[live] = np.asarray(f, np.int64), x, y, w
        mine = flags.sum(-1)
        offset = _block_exclusive_scan(mine)
        count = int(mine.sum())
        status[tile], value[tile] = (2, count) if tile == 0 else (1, count)
        yield
        before = 0
        p = tile - 1
        while tile > 0:
            t = p - np.arange(32)
            st = np.where(t >= 0, status[np.maximum(t, 0)], 2)
            val = np.where(t >= 0, value[np.maximum(t, 0)], 0)
            while (st == 0).any():
                seen[0] += int((st == 0).sum())
                yield
                again = st == 0
                st[again] = status[t[again]]
                val[again] = value[t[again]]
            seen[1] += int((st == 1).sum())
            seen[2] += int((st == 2).any())
            inclusive = np.flatnonzero(st == 2)
            last = inclusive[0] if len(inclusive) else 31
            before += int(val[:last + 1].sum())
            if len(inclusive):
                break
            p -= 32
            yield
        if tile > 0:
            status[tile], value[tile] = 2, before + count
        if tile == live_tiles - 1:
            out["n_children"] = before + count
        yield
        dest = before + offset
        for t in np.flatnonzero(mine):
            d = dest[t]
            for occ in np.flatnonzero(flags[t]):
                if d < cap:
                    assert not written[d]                         # one writer per slot
                    written[d] = True
                    a_new[d] = ra[t] | ((occ & 1) << j)
                    b_new[d] = rb[t] | ((occ >> 1) << j)
                    w_new[d] = rw[t, occ]
                    valid_new[d] = True
                d += 1

    pending = list(rng.permutation(n_tiles))
    running = []
    for _ in range(100 * n_tiles * (cap + 64)):
        while pending and len(running) < resident:
            running.append(run(pending.pop()))
        if not running:
            break
        i = rng.integers(len(running))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    assert not running and not pending and out["ticket"] == live_tiles
    return (a_new, b_new, w_new, valid_new, out["n_children"]), made, seen


# the single-pass kernel's index arithmetic, with the split inside, in its tiles
# of 256 rows and in others: (2500, 0.5, 64) overflows; the last four cases gate
# the rows: one live row, a gate inside a tile that overflows cap, a gate past
# cap and a gate of 0
@pytest.mark.parametrize("cap,fill,block,gate", [
    (2500, 0.2, 256, None), (1027, 0.1, 256, None), (5, 0.4, 256, None),
    (203, 0.15, 64, None), (2500, 0.2, 64, None), (2500, 0.5, 64, None),
    (4099, 0.1, 128, None), (5000, 0.25, 1024, None), (1030, 0.0, 32, None),
    (2500, 1.0, 256, 1), (2500, 1.0, 64, 1700), (4099, 0.3, 128, 5000), (1030, 1.0, 32, 0)])
def test_split_and_compact_kernel_index_arithmetic(cap, fill, block, gate):
    """split_and_compact_kernel: every live tile's rows split once, the
    look-back in interleavings drawn from a seed (a successor sees empty,
    aggregate and inclusive words) on a card that holds 4 blocks at a time,
    the gate, and the cleared tail, bitwise against the plain version."""
    a, b, counts, valid, probs, z, u, mask = _shell_case("cdf", fill, cap, cap)
    if gate == 1:
        valid[0] = True
    inputs = tuple(map(torch.as_tensor, (counts, probs, z, u, mask, valid)))

    def split_rows(rows):
        c, p, zz, uu, m, v = inputs
        child, flags = multinomial4_split_ref(c[rows], p[rows], zz[:, rows], uu[:, rows],
                                              m[rows], v[rows])
        return flags.numpy(), a[rows], b[rows], child.numpy()

    got, made, seen = _lookback_replay(split_rows, 7, cap, block, gate, resident=4, seed=cap)
    want = _split_and_compact_ref(*map(torch.as_tensor, (a, b, counts, valid, probs, z, u,
                                                         mask)), 7, cap, gate)
    live_tiles = -(-min(cap if gate is None else gate, cap) // block)
    assert np.all(made[:live_tiles] == 1) and np.all(made[live_tiles:] == 0)
    assert (got[4] > cap) == (fill == 0.5 or gate == 1700)
    if live_tiles > 8:
        assert seen[0] > 0 and seen[1] > 0 and seen[2] > 0
    if gate == 1:
        assert 0 < got[4] <= 4
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    assert _split_and_compact.launches == 0


def test_split_and_compact_gate_is_the_live_rows():
    """n_live as an int, as a () tensor and as None: rows at or past it count
    as not valid; in sample() every row below the previous n_children is valid,
    so the gate changes nothing there."""
    n = 600
    a, b, counts, valid, probs, z, u, mask = map(torch.as_tensor,
                                                 _shell_case("gauss", 1.0, n, 5))
    args = (a, b, counts, valid, probs, z, u, mask, 3, n)
    cut = valid & (torch.arange(n) < 250)
    want = _split_and_compact_ref(a, b, counts, cut, probs, z, u, mask, 3, n)
    for gate in (250, torch.tensor(250)):
        got = _split_and_compact(*args, gate)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    whole = _split_and_compact_ref(a, b, counts, valid, probs, z, u, mask, 3, n)
    for gate in (None, n, 10 * n, torch.tensor(10 * n)):
        got = _split_and_compact(*args, gate)
        assert all(torch.equal(g, w) for g, w in zip(got, whole))


def test_wrappers_reject_bad_inputs():
    n = 8
    counts = torch.ones(n, dtype=torch.float64)
    probs = torch.ones((n, 4))
    z, u = split_draws(torch.Generator().manual_seed(0), n, "cpu")
    a = torch.zeros(n, dtype=torch.int64)
    w = torch.ones((n, 4), dtype=torch.float64)
    flags = torch.ones((n, 4), dtype=torch.bool)
    meta = torch.ones(n, dtype=torch.float64, device="meta")
    for bad in (lambda: multinomial4_split(counts.float(), probs, z, u),
                lambda: multinomial4_split(counts, probs.half(), z, u),
                lambda: multinomial4_split(counts, probs[:, :3], z, u),
                lambda: multinomial4_split(counts, probs, z[:2], u),
                lambda: multinomial4_split(counts, probs, z, u.double()),
                lambda: multinomial4_split(counts, probs, z, u, mask=flags.int()),
                lambda: multinomial4_split(counts, probs, z, u, valid=flags),
                lambda: multinomial4_split(meta, probs, z, u),
                lambda: multinomial4_split(counts, probs.to("meta"), z, u),
                lambda: _compact_children(a.int(), a, w, flags, 0, n),
                lambda: _compact_children(a, a, w.float(), flags, 0, n),
                lambda: _compact_children(a, a, w, flags.to(torch.uint8), 0, n),
                lambda: _compact_children(a, a, w, flags, 0, n + 1),
                lambda: _compact_children(a, a, w, flags, 63, n),
                lambda: _compact_children(a, a.to("meta"), w, flags, 0, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs.half(), z, u,
                                           flags, 0, n),
                lambda: _split_and_compact(a, a, counts.float(), flags[:, 0], probs, z, u, flags,
                                           0, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0].int(), probs, z, u, flags,
                                           0, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z[:2], u, flags, 0,
                                           n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags[:, :3],
                                           0, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags, 63, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags, 0,
                                           n + 1),
                lambda: _split_and_compact(a.to("meta"), a, counts, flags[:, 0], probs, z, u,
                                           flags, 0, n),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags, 0, n,
                                           torch.tensor(1.0)),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags, 0, n,
                                           torch.tensor([1])),
                lambda: _split_and_compact(a, a, counts, flags[:, 0], probs, z, u, flags, 0, n,
                                           1.0)):
        with pytest.raises(ValueError):
            bad()


def _cdf_replay(n, p, u, block=4):
    """The split kernel's inverse-CDF count (csrc/sampler_step.cu::cdf_looks)
    replayed in numpy f32 for binomials (n, p, u), pmf_0 and the odds as the
    plain version forms them: `block` looks at a time, the block's pmf and cdf
    first, then all of its tests at once, counted (the CDF never falls, so the
    looks that pass are the first ones); the run ends at the first block with
    a look that fails or that holds k = 128. The quotient is the correctly
    rounded one (the kernel's division, which the card proves bitwise equal
    to it)."""
    p64 = torch.clamp(p, 0.0, 1.0)
    q = torch.where(p64 > 0.5, 1.0 - p64, p64)
    pmf = torch.exp((n * torch.log1p(-torch.clamp(q, max=1.0 - 1e-15))).float()).numpy()
    qf = q.float()
    odds = (qf / torch.clamp(1.0 - qf, min=1e-30)).numpy()
    nf, u = n.float().numpy(), u.numpy()
    small = np.zeros(len(nf), np.int64)
    cdf, live = pmf.copy(), np.ones(len(nf), bool)
    for i in range(1, 128, block):
        p_b, c_b = pmf, cdf
        passes = (u > cdf).astype(np.int64)
        for t in range(block):
            left = np.maximum(nf - np.float32(i + t) + np.float32(1), np.float32(0))
            p_b = p_b * left / np.float32(i + t) * odds
            c_b = c_b + p_b
            if t + 1 < block:
                passes += (u > c_b) & (i + t + 1 < 128)
        small += np.where(live, passes, 0)
        live &= passes == block
        pmf, cdf = np.where(live, p_b, pmf), np.where(live, c_b, cdf)
    assert not live.any()
    return small


def test_cdf_block_replay_matches_the_plain_loop():
    """The kernel's inverse-CDF loop, replayed, counts what the plain loop
    counts on every binomial: runs that end in each of a block's four looks,
    that reach k = 127, that go past k = n + 1, counts that are not integers
    or of 2^24 and more, q = 0."""
    rng = np.random.default_rng(11)
    m = 60_000
    n = np.floor(10 ** rng.uniform(0, 3.7, m))
    p = 10 ** rng.uniform(-4, np.log10(0.5), m)
    p[::3] = rng.uniform(0, 1, m)[::3] * 25.0 / np.maximum(n[::3], 1.0)
    n[::11] = rng.uniform(0, 100, m)[::11]                    # not integers
    n[::13] = np.floor(10 ** rng.uniform(7.3, 12, m))[::13]   # 2^24 and more
    p[::13] = 10.0 / n[::13]
    n[::17] = rng.integers(0, 4, m)[::17]                     # counts 0..3
    p[::19] = 0.0
    u = rng.uniform(0, 1, m).astype(np.float32)
    u[::7] = np.float32(0.99999994)                           # runs to k = 127
    n_t, p_t, u_t = torch.as_tensor(n), torch.as_tensor(p), torch.as_tensor(u)
    want = _binomial_from_draws(n_t, p_t, torch.zeros_like(u_t), u_t)[2].numpy()
    got = _cdf_replay(n_t, p_t, u_t)
    np.testing.assert_array_equal(got, want)
    assert all((want % 4 == e).any() for e in range(4)) and (want == 127).sum() > 100
    assert ((want > n + 1) & (n < 4)).any()


def test_split_timing_inputs_isolate_each_part():
    """The decomposition's inputs (tools/split_timing.py) ask what their names
    say of the split: no live row; every binomial of a live row Gaussian; the
    real shell's branches; the inverse CDF on every binomial of the synthetic
    split but its corner rows. The tally's warp chain is at least the longest
    loop."""
    from naqs_tpu_torch.tools import split_timing

    gen = torch.Generator().manual_seed(4)
    cap = 4096
    counts = torch.where(torch.rand(cap, generator=gen) < 0.7,
                         torch.floor(torch.rand(cap, generator=gen) * 60) + 1, 0.0).double()
    valid = counts > 0
    probs = torch.rand((cap, 4), generator=gen)
    z, u = split_draws(gen, cap, "cpu")
    mask = torch.ones((cap, 4), dtype=torch.bool)
    step = (torch.zeros(cap, dtype=torch.int64), torch.zeros(cap, dtype=torch.int64), counts,
            valid, probs, z, u, mask, 3, cap, cap)
    inputs = split_timing.decomposition_inputs(step, split_timing.synthetic_split(cap, "cpu"))
    assert list(inputs) == ["every row dead", "every live row Gaussian", "real shell",
                            "synthetic all-CDF"]
    tally = {k: split_timing.split_tally(a[0], a[1], a[2], a[3], a[5]) for k, a in inputs.items()}
    live = int(valid.sum())
    assert tally["every row dead"]["live_rows"] == 0
    assert float(multinomial4_split(*inputs["every row dead"])[0].abs().sum()) == 0.0
    gauss = tally["every live row Gaussian"]
    assert gauss["live_rows"] == live and gauss["gauss"] == 3 * live and gauss["cdf"] == 0
    real = tally["real shell"]
    assert real["live_rows"] == live and real["gauss"] + real["cdf"] == 3 * live
    syn = tally["synthetic all-CDF"]   # all but its 64 corner rows
    assert syn["cdf"] >= 3 * (cap - 64) and syn["gauss"] <= 3 * 64 and syn["longest"] >= 40
    for t in (real, syn):
        assert t["longest"] <= t["warp_chain"] <= 3 * t["longest"] and t["looks"] >= t["cdf"]

