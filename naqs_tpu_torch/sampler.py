"""Exact autoregressive ancestral sampling over unique states.

Port of `naqs_tpu/sampler.py`: samples are counted over UNIQUE
configurations, so cost scales with support size, not sample count. The
frontier is a fixed-capacity buffer; at each shell every frontier state's
count is split over its 4 child occupations (`multinomial4_split`) and the
valid children are compacted, in order, into a fresh buffer
(`_compact_children`); `_split_and_compact` does both at once. Exceeding
capacity sets an overflow flag, which the trainer's controller answers by
shrinking the sample count. The shell loop is a Python loop; sampling is
gradient-free. `sample_density` walks the same shells deterministically and
keeps every child whose probability mass reaches a threshold.

Each shell's conditional is `amp_conditional_shell` on the frontier's packed
prefix ints (on the card the kernels `shell_features` and `shell_epilogue` of
`ops/nade_glue.py` around the MLP's two products), and the shell step is one
hand-written kernel of `csrc/sampler_step.cu`, `split_and_compact`
(`_split_and_compact` here: one ordinary launch a shell, a single pass with
no grid barrier: tiles of 256
rows taken by an atomic ticket split their rows and publish their counts of
children, and each learns the children before it by a decoupled look-back;
only the rows below the previous shell's `n_children`, read on the device,
load anything), and reads nothing back to the host. `sample_density`
launches the compaction alone, `compact_children` (`_compact_children`: one
cooperative launch with a grid-wide barrier), and the split alone is
`multinomial4_split` (`ops/multinomial.py`). On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version (`_compact_children_ref`, a cumsum-scatter as in the JAX
package; `_split_and_compact_ref`, the plain split followed by it). There is
no fallback from one to the other; the split's arithmetic and the integer
scan make the two equal bit for bit. Each wrapper's `.launches` counts its
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from naqs_tpu_torch.models.nade import NADE, _index, amp_conditional_shell
from naqs_tpu_torch.ops.multinomial import multinomial4_split_ref, split_draws
from naqs_tpu_torch.ops._build import check_tensors
from naqs_tpu_torch.ops.sampler_kernels import (compact_tile_rows, launch, launch_flat,
                                                split_tile_rows)
from naqs_tpu_torch.utils.bits import SENTINEL


@dataclass(frozen=True)
class SampleBatch:
    """Fixed-capacity unique-sample buffer (sorted by packed state)."""

    states: torch.Tensor    # (cap,) int64, SENTINEL-padded, ascending
    counts: torch.Tensor    # (cap,) f64 multiplicities (0 on padding)
    n_unique: torch.Tensor  # () int64
    overflow: torch.Tensor  # () bool: frontier exceeded capacity


def _compact_children_ref(a, b, child_weights, child_valid, j: int, cap: int):
    """Plain PyTorch version of `_compact_children`: a cumsum-scatter. Children
    beyond capacity land on a dummy slot and are dropped."""
    dev = a.device
    flat_w = child_weights.reshape(-1)
    flat_valid = child_valid.reshape(-1)
    n_children = flat_valid.sum()
    dest = torch.cumsum(flat_valid.to(torch.int64), dim=0) - 1
    dest = torch.where(flat_valid, torch.clamp(dest, max=cap), cap)

    parent = torch.arange(cap, device=dev).repeat_interleave(4)
    occ = torch.arange(4, device=dev).repeat(cap)
    a_vals = a[parent] | ((occ & 1) << j)
    b_vals = b[parent] | ((occ >> 1) << j)

    def scatter(vals):
        out = torch.zeros((cap + 1,), dtype=vals.dtype, device=dev)
        return out.index_copy_(0, dest, vals)[:cap]

    valid_new = torch.arange(cap, device=dev) < torch.clamp(n_children, max=cap)
    return scatter(a_vals), scatter(b_vals), scatter(flat_w), valid_new, n_children


def _check_shell(name, j: int, cap: int):
    if not 0 <= j < 63:
        raise ValueError(f"{name}: shell {j} does not fit an int64 word")
    if not 0 < 4 * cap < 1 << 31:
        raise ValueError(f"{name}: 4 * cap must be positive and below 2^31")


def _fresh_frontier(cap: int, dev):
    """The outputs of `compact_children`, (a_new, b_new, w_new, valid_new,
    n_children), and its scratch of one int32 a tile of `compact_tile_rows()`
    rows."""
    i64 = torch.int64
    return (torch.empty((cap,), dtype=i64, device=dev),
            torch.empty((cap,), dtype=i64, device=dev),
            torch.empty((cap,), dtype=torch.float64, device=dev),
            torch.empty((cap,), dtype=torch.bool, device=dev),
            torch.empty((), dtype=i64, device=dev),
            torch.empty((-(-cap // compact_tile_rows()),), dtype=torch.int32, device=dev))


def _split_frontier(cap: int, dev):
    """The outputs of `split_and_compact`, carved from one (4, row) int64
    allocation with few host calls: rows 0-2 are a_new, b_new and w_new; row 3
    holds valid_new (cap bytes in whole 16-byte words), n_children and the
    look-back scratch (one int64 word a tile of `split_tile_rows()` rows, and
    one for the ticket). `row` is even, so every row starts at a multiple of
    16 bytes. Returns (buf, (a_new, b_new, w_new, valid_new, n_children),
    the scratch's offset in row 3 and its length in words); the library
    clears buf up to the scratch's end."""
    tiles = -(-cap // split_tile_rows()) + 1
    head = -(-cap // 16) * 2
    row = max(cap + (cap & 1), head + 2 + tiles + (tiles & 1))
    buf = torch.empty((4, row), dtype=torch.int64, device=dev)
    a_new, b_new, w_new, rest = buf.unbind(0)
    if row != cap:
        a_new, b_new, w_new = a_new[:cap], b_new[:cap], w_new[:cap]
    return (buf, (a_new, b_new, w_new.view(torch.float64), rest.view(torch.bool)[:cap],
                  rest[head]), head + 2, tiles)


def _compact_children(a, b, child_weights, child_valid, j: int, cap: int):
    """Scatter the valid (parent, occupation) children of a (cap, 4) frontier
    expansion into a fresh cap-sized buffer, preserving row-major order.

    a, b: (cap,) int64 prefix occupation bits; child_weights: (cap, 4) f64;
    child_valid: (cap, 4) bool. Child (parent, occ) lands on the slot that
    counts the valid children before it and carries a[parent] | (occ & 1) << j,
    b[parent] | (occ >> 1) << j and its weight. Returns (a_new, b_new, w_new,
    valid_new, n_children): slots from n_children on hold zeros, children at
    slots >= cap are dropped, and n_children, a () int64 on the device, is
    the true count (callers flag overflow from it without a readback).
    """
    i64, f64 = (torch.int64,), (torch.float64,)
    check_tensors("compact_children", a, {
        "a": (a, i64, (cap,)), "b": (b, i64, (cap,)),
        "child_weights": (child_weights, f64, (cap, 4)),
        "child_valid": (child_valid, (torch.bool,), (cap, 4))}, align=16)
    _check_shell("compact_children", j, cap)
    if a.device.type == "cpu":
        return _compact_children_ref(a, b, child_weights, child_valid, j, cap)
    out = _fresh_frontier(cap, a.device)
    tiles = out[-1]
    launch("compact_children", (a, b, child_weights, child_valid, *out, tiles.numel(), cap, j),
           a.device)
    _compact_children.launches += 1
    return out[:5]


_compact_children.launches = 0


def _split_and_compact_ref(a, b, counts, valid, probs, z, u, mask, j: int, cap: int,
                           n_live=None):
    """Plain PyTorch version of `_split_and_compact`: `multinomial4_split_ref`
    followed by `_compact_children_ref`, on the rows below n_live."""
    if n_live is not None:
        valid = valid & (torch.arange(cap, device=a.device) < n_live)
    child_counts, child_valid = multinomial4_split_ref(counts, probs, z, u, mask, valid)
    return _compact_children_ref(a, b, child_counts, child_valid, j, cap)


def _split_and_compact(a, b, counts, valid, probs, z, u, mask, j: int, cap: int, n_live=None):
    """One shell step of `sample`: split every frontier row's count over its
    four children as `multinomial4_split(counts, probs, z, u, mask, valid)`
    does, then compact the children with a count as `_compact_children(a, b,
    child_counts, child_valid, j, cap)` does, in one launch on the card.

    a, b: (cap,) int64; counts: (cap,) f64; valid: (cap,) bool; probs: (cap, 4)
    f32, or f64 (a float64 model's conditionals: the kernel's f64
    instantiation); z, u: (3, cap) f32 from `split_draws`; mask: (cap, 4)
    bool. n_live: only rows below it may have children (rows at or past it
    count as not valid, and the kernel loads nothing for them): the previous
    shell's n_children, a () int64 on the device that is never read back, or
    an int (the root's 1); None: every row. Returns `_compact_children`'s
    (a_new, b_new, w_new, valid_new, n_children), which share one fresh
    allocation.
    """
    i64, f32, bl = (torch.int64,), (torch.float32,), (torch.bool,)
    want = {"a": (a, i64, (cap,)), "b": (b, i64, (cap,)),
            "counts": (counts, (torch.float64,), (cap,)), "valid": (valid, bl, (cap,)),
            "probs": (probs, (torch.float32, torch.float64), (cap, 4)),
            "z": (z, f32, (3, cap)), "u": (u, f32, (3, cap)), "mask": (mask, bl, (cap, 4))}
    live = torch.is_tensor(n_live)
    if live:
        want["n_live"] = (n_live, i64, ())
    elif n_live is not None and not isinstance(n_live, int):
        raise ValueError(f"split_and_compact: n_live must be a tensor, an int or None, "
                         f"got {type(n_live).__name__}")
    check_tensors("split_and_compact", a, want, align=16)
    _check_shell("split_and_compact", j, cap)
    if a.device.type == "cpu":
        return _split_and_compact_ref(a, b, counts, valid, probs, z, u, mask, j, cap, n_live)
    live_rows = cap if live or n_live is None else min(max(n_live, 0), cap)
    buf, out, at, words = _split_frontier(cap, a.device)
    base, row = buf.data_ptr(), buf.shape[1]
    rest = base + 24 * row
    launch_flat("split_and_compact", [
        a.data_ptr(), b.data_ptr(), counts.data_ptr(), valid.data_ptr(), probs.data_ptr(),
        z.data_ptr(), u.data_ptr(), mask.data_ptr(), n_live.data_ptr() if live else None,
        live_rows, base, base + 8 * row, base + 16 * row, rest, rest + 8 * (at - 2),
        rest + 8 * at, words, base, 8 * (3 * row + at + words), cap, j,
        int(probs.dtype == torch.float64)], a.device)
    _split_and_compact.launches += 1
    return out


_split_and_compact.launches = 0


def _root(cap: int, weight: float, dev):
    """The frontier before shell 0: one live state carrying `weight`."""
    a = torch.zeros((cap,), dtype=torch.int64, device=dev)
    w = torch.zeros((cap,), dtype=torch.float64, device=dev)
    w[0] = weight
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    valid[0] = True
    return a, torch.zeros_like(a), w, valid, torch.zeros((), dtype=torch.bool, device=dev)


def _batch(cfg, a, b, weights, valid, overflow) -> SampleBatch:
    """Pack model-order spin bits into state-order int64 bitstrings and sort.
    The shells and their weights are device constants made once per device
    (`_index`): nothing is copied to the card."""
    shells = _index(tuple(range(cfg.n_shells)), a.device)
    wa = _index(tuple(1 << (2 * o) for o in cfg.shell_order), a.device)
    alpha, beta_bits = (a[:, None] >> shells) & 1, (b[:, None] >> shells) & 1
    states = torch.sum(alpha * wa + beta_bits * (wa << 1), dim=-1)
    states = torch.where(valid, states, SENTINEL)

    states, perm = torch.sort(states)
    weights = torch.where(valid[perm], weights[perm], 0.0)
    return SampleBatch(states=states, counts=weights, n_unique=valid.sum(),
                       overflow=overflow)


def _temper(log_amp4, probs, beta: float):
    """A shell's conditionals tempered to p^beta and renormalized, in probs'
    dtype as in naqs_tpu/sampler.py:122-127. In log space: masked options
    carry log_amp -> -inf-ish, so exp gives exact zeros and the sum runs over
    the valid options."""
    pt = torch.exp(2.0 * beta * log_amp4.to(torch.float64))
    return (pt / torch.clamp(pt.sum(dim=-1, keepdim=True), min=1e-300)).to(probs.dtype)


@torch.no_grad()
def sample(
    model: NADE,
    gen: torch.Generator,
    n_samples: float,
    capacity: int,
    beta: float = 1.0,
) -> SampleBatch:
    """Draw `n_samples` ancestral samples; up to `capacity` unique states.

    Under partial/none masking, unphysical samples are discarded (counts
    drop). `beta` tempers the per-shell conditionals to p_j^beta
    (renormalized): counts are then multiplicities under the tempered
    distribution, and consumers must weight by |psi|^2 (reweight_by_psi).
    """
    cfg = model.cfg
    s = cfg.n_shells
    cap = capacity
    dev = next(model.parameters()).device
    a, b, counts, valid, overflow = _root(cap, float(n_samples), dev)
    n_children = 1   # the root's one live row; then each shell's count, on the device

    for j in range(s):
        log_amp4, mask, probs = amp_conditional_shell(model, j, a, b)
        if beta != 1.0:
            probs = _temper(log_amp4, probs, beta)
        z, u = split_draws(gen, cap, dev)
        # the mask drops unphysical children; valid = (count > 0) on live rows,
        # which are the first n_children slots of the frontier
        a, b, counts, valid, n_children = _split_and_compact(
            a, b, counts, valid, probs, z, u, mask, j, cap, n_children)
        overflow = overflow | (n_children > cap)
    return _batch(cfg, a, b, counts, valid, overflow)


@torch.no_grad()
def sample_density(model: NADE, d_p: float, capacity: int) -> SampleBatch:
    """Deterministic density sampling: enumerate every configuration whose
    probability mass reaches `d_p` (beam search over shells). Port of
    `naqs_tpu/sampler.py::sample_density`.

    The returned `counts` hold the probability mass |psi|^2 of each state
    (not sample multiplicities); overflow flags a beam wider than `capacity`.
    """
    cfg = model.cfg
    s = cfg.n_shells
    cap = capacity
    dev = next(model.parameters()).device
    a, b, prob, valid, overflow = _root(cap, 1.0, dev)

    for j in range(s):
        _, mask, probs = amp_conditional_shell(model, j, a, b)
        child_prob = prob[:, None] * probs.to(torch.float64) * mask
        child_valid = (child_prob >= d_p) & valid[:, None]
        a, b, prob, valid, n_children = _compact_children(
            a, b, child_prob, child_valid, j, cap)
        overflow = overflow | (n_children > cap)
    return _batch(cfg, a, b, prob, valid, overflow)
