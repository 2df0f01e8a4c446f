"""The row kernels' filter of the sampled states, as plain PyTorch.

`csrc/row_energy.cuh` (the body of `sorted_local_energy`,
`sorted_quadratic_energy`, `rank_local_energy` and `rank_quadratic_energy`)
has each block hash the table's n live keys into a bitmap of WORDS 32-bit
words in shared memory, and drops a coupled state whose two bits are not both
set before any search or table read. This module is that filter's plain
version, with the same constants: what the tests hold its hash to, and what
`chip_smoke.py` counts the kernels' work with. No engine calls it: on the CPU
the plain versions of the kernels look every pair up, which gives the same
sums (the filter passes every live key).

A key is a state (the sort lookup), or its low 2S bits (the rank lookup, whose
table row depends on those alone: `key_mask`). With h = key * MULTIPLIER mod
2^64 and hi its top 32 bits, the key's word is the top LOG2_WORDS bits of hi
and its two bits the 5-bit fields below them:

    word = hi >> (32 - LOG2_WORDS)
    bit1 = (hi >> (27 - LOG2_WORDS)) & 31
    bit2 = (hi >> (22 - LOG2_WORDS)) & 31   (bit2 may equal bit1)

The kernels build the filter where the table has at most CAPACITY rows (so
at least 2 bits a key: a table of a sampled batch) and n > 0; a larger table
(exact mode's sector tables) takes the unfiltered kernel, and there, as for
n = 0, every pair goes to the lookup (`screened`, `passes`).
"""

from __future__ import annotations

import torch

LOG2_WORDS = 14
WORDS = 1 << LOG2_WORDS                 # 16,384 words: 64 KB
CAPACITY = WORDS * 32 // 2              # 262,144 table rows: at least 2 bits a key
MULTIPLIER = 0x9E3779B97F4A7C15         # odd
_MUL_I64 = MULTIPLIER - (1 << 64)       # the same bits as an int64


def screened(n: int, rows: int) -> bool:
    """Whether the kernels build the filter for n live keys of a table of
    `rows` rows (n <= rows)."""
    return 0 < n and rows <= CAPACITY


def key_mask(n_qubits: int) -> int:
    """The rank lookup's key mask: the low n_qubits bits."""
    return (1 << n_qubits) - 1


def filter_bits(keys: torch.Tensor):
    """(word, bit1, bit2), each int64 of keys' shape, for int64 keys."""
    h = keys.to(torch.int64) * _MUL_I64           # wraps mod 2^64
    hi = (h >> 32) & 0xFFFFFFFF
    return (hi >> (32 - LOG2_WORDS), (hi >> (27 - LOG2_WORDS)) & 31,
            (hi >> (22 - LOG2_WORDS)) & 31)


def build(keys: torch.Tensor) -> torch.Tensor:
    """The filter of `keys` (1-D int64): (WORDS,) int64 holding 32 bits each,
    bit b of word w set where some key's word is w and one of its bits b."""
    word, b1, b2 = filter_bits(keys)
    bits = torch.zeros(WORDS * 32, dtype=torch.bool, device=keys.device)
    bits[word * 32 + b1] = True
    bits[word * 32 + b2] = True
    shifts = torch.arange(32, device=keys.device, dtype=torch.int64)
    return torch.sum(bits.view(WORDS, 32).to(torch.int64) << shifts, dim=1)


def contains(words: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Whether both bits of each query (int64, any shape) are set in `words`."""
    word, b1, b2 = filter_bits(queries)
    w = words[word]
    return (((w >> b1) & 1) & ((w >> b2) & 1)).to(torch.bool)


def passes(states: torch.Tensor, n: int, queries: torch.Tensor, mask: int | None = None):
    """What the kernels send on to the lookup: for the first n of `states` as
    the table's keys, the queries whose bits are set (keys and queries taken
    `& mask` where given), or every query where the filter is not built."""
    if not screened(n, states.shape[0]):
        return torch.ones(queries.shape, dtype=torch.bool, device=queries.device)
    keys = states[:n]
    if mask is not None:
        keys, queries = keys & mask, queries & mask
    return contains(build(keys), queries)
