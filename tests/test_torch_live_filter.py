"""The row kernels' filter of the sampled states (`ops/live_filter.py`, the
plain version of the filter in `csrc/row_energy.cuh`).

No JAX: the filter has no counterpart in the JAX package. Checks that it
passes every live key (no false negatives) at n = 0, 1, a few, N2 6-31G's
live count, a table of its capacity (262,144 rows, 2 bits a key) and one row
above it (where the kernels build no filter and every pair passes), with the
rank lookup's key mask too; that its hash
bits equal an independent numpy formula in unsigned 64-bit arithmetic; that
its constants are the kernel source's; and that the share of states outside
the set it passes at N2 6-31G's 20,850 and frozen-core N2 6-31G's 25,586 live
keys is the design's figure: for a blocked filter of W = 16,384 words with
two bits a key, a non-member's two bits both set with probability
sum_j Poisson(j; n / W) P(both set | j keys in its word), 0.99% and 1.34%.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import pytest
import torch

from naqs_tpu_torch.ops import live_filter as lf
from naqs_tpu_torch.utils.bits import SENTINEL

_ROW_ENERGY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "naqs_tpu_torch", "csrc", "row_energy.cuh")


def _sector_states(n, n_shells, n_alpha, n_beta, rng):
    """At least n distinct states of one (n_alpha, n_beta) sector, packed with
    alpha on the even bits and beta on the odd ones, sorted."""
    out = np.zeros(0, np.int64)
    while out.size < n:
        m = 2 * (n - out.size) + 64
        bits = np.zeros(m, np.int64)
        for spin, k in ((0, n_alpha), (1, n_beta)):
            pos = np.argsort(rng.random((m, n_shells)), axis=1)[:, :k]
            for j in range(k):
                bits |= np.int64(1) << (2 * pos[:, j] + spin)
        out = np.unique(np.concatenate([out, bits]))
    return out


def _buffer(n, cap, seed, n_shells=18, sector=(7, 7)):
    """A sorted buffer of n live sector states, SENTINEL-padded to cap."""
    rng = np.random.default_rng(seed)
    live = rng.permutation(_sector_states(n, n_shells, *sector, rng))[:n] if n else []
    states = np.full(cap, SENTINEL, np.int64)
    states[:n] = np.sort(live)
    return torch.as_tensor(states)


def _expected_rate(n):
    """P(a non-member passes) for n keys: the load of its word is Poisson,
    each key sets two bits drawn with replacement, the query probes two."""
    lam, p, rate = n / lf.WORDS, math.exp(-n / lf.WORDS), 0.0
    for j in range(200):
        if j:
            p *= lam / j
        one, two = (31 / 32) ** (2 * j), (30 / 32) ** (2 * j)
        rate += p * (31 / 32 * (1 - 2 * one + two) + 1 / 32 * (1 - one))
    return rate


@pytest.mark.parametrize("n", [0, 1, 3, 1000, 20_850, lf.CAPACITY, lf.CAPACITY + 1])
def test_every_live_key_passes(n):
    cap = n + 97 if n + 97 <= lf.CAPACITY else n
    states = _buffer(n, cap, seed=n)
    assert lf.screened(n, cap) == (0 < n <= lf.CAPACITY)
    got = lf.passes(states, n, states[:n])
    assert got.shape == (n,) and bool(got.all())
    # where no filter is built, every query passes, live or not
    other = torch.as_tensor(np.random.default_rng(1).integers(0, 1 << 36, 5000))
    if not lf.screened(n, cap):
        assert bool(lf.passes(states, n, other).all())
    else:
        assert not bool(lf.passes(states, n, other).all())
        words = lf.build(states[:n])
        assert words.shape == (lf.WORDS,) and int(words.min()) >= 0
        assert int(words.max()) < 1 << 32
        # two bits at most a key
        assert int(sum(bin(int(w)).count("1") for w in words)) <= 2 * n


def test_rank_keys_pass_under_their_mask():
    """The rank lookup's keys are a state's low 2S bits: a query with the
    same low bits passes, whatever lies above them."""
    n_qubits = 32
    mask = lf.key_mask(n_qubits)
    states = _buffer(25_586, 100_000, seed=7, n_shells=16, sector=(5, 5))
    live = states[:25_586]
    assert bool(lf.passes(states, 25_586, live, mask).all())
    high = live | (np.int64(1) << 40)
    assert bool(lf.passes(states, 25_586, high, mask).all())
    assert not bool(lf.passes(states, 25_586, high).all())


def test_hash_bits_equal_numpy_formula():
    rng = np.random.default_rng(11)
    keys = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 10_000, dtype=np.int64),
                           np.array([0, 1, -1, SENTINEL, 1 << 35, (1 << 36) - 1], np.int64)])
    with np.errstate(over="ignore"):
        h = keys.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    hi = (h >> np.uint64(32)).astype(np.int64)
    want = (hi >> 18, (hi >> 13) & 31, (hi >> 8) & 31)
    got = lf.filter_bits(torch.as_tensor(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # and in Python integers, for a few keys
    for k in keys[:50]:
        hi = ((int(k) % (1 << 64)) * lf.MULTIPLIER % (1 << 64)) >> 32
        assert (hi >> 18, (hi >> 13) & 31, (hi >> 8) & 31) == tuple(
            int(t) for t in lf.filter_bits(torch.tensor([int(k)])))


def test_constants_are_the_kernel_sources():
    src = open(_ROW_ENERGY).read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(const("kFilterLog2Words")) == lf.LOG2_WORDS
    assert int(const("kFilterMul").rstrip("ull"), 16) == lf.MULTIPLIER
    assert "int64_t{kFilterWords} * 32 / 2" in const("kFilterKeys")
    assert "kFilterKeys" in const("kFilterTableMax")
    assert lf.CAPACITY == lf.WORDS * 32 // 2 == 262_144


@pytest.mark.parametrize("n,n_shells,sector,figure", [
    (20_850, 18, (7, 7), 0.0099),    # N2 6-31G: 36 qubits
    (25_586, 16, (5, 5), 0.0134),    # frozen-core N2 6-31G: 32 qubits
])
def test_false_hit_rate_is_the_design_figure(n, n_shells, sector, figure):
    rng = np.random.default_rng(n)
    pool = _sector_states(n + 400_000, n_shells, *sector, rng)
    pool = rng.permutation(pool)
    keys = torch.as_tensor(np.sort(pool[:n]))
    others = torch.as_tensor(pool[n:n + 400_000])
    rate = float(lf.contains(lf.build(keys), others).double().mean())
    expected = _expected_rate(n)
    assert abs(expected - figure) < 5e-5
    # 400,000 non-members: one standard error is 1.6% of the rate at ~1%
    assert abs(rate - expected) <= 0.1 * expected, (rate, expected)
