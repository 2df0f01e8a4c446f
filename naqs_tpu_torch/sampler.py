"""Exact autoregressive ancestral sampling over unique states.

Port of `naqs_tpu/sampler.py::sample`: samples are counted over UNIQUE
configurations, so cost scales with support size, not sample count. The
frontier is a fixed-capacity buffer; at each shell every frontier state's
count is split over its 4 child occupations (multinomial4) and the valid
children are compacted into a fresh buffer by a cumsum-scatter. Exceeding
capacity sets an overflow flag, which the trainer's controller answers by
shrinking the sample count. The shell loop is a Python loop; sampling is
gradient-free.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from naqs_tpu_torch.models.nade import NADE, amp_conditional_shell
from naqs_tpu_torch.ops.multinomial import multinomial4
from naqs_tpu_torch.utils.bits import SENTINEL


@dataclass(frozen=True)
class SampleBatch:
    """Fixed-capacity unique-sample buffer (sorted by packed state)."""

    states: torch.Tensor    # (cap,) int64, SENTINEL-padded, ascending
    counts: torch.Tensor    # (cap,) f64 multiplicities (0 on padding)
    n_unique: torch.Tensor  # () int64
    overflow: torch.Tensor  # () bool: frontier exceeded capacity


def _compact_children(a, b, child_weights, child_valid, j: int, cap: int):
    """Scatter the valid (parent, occupation) children of a (cap, 4) frontier
    expansion into a fresh cap-sized buffer, preserving order. Children
    beyond capacity land on a dummy slot and are dropped (callers flag
    overflow from the returned n_children)."""
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

    a = torch.zeros((cap,), dtype=torch.int64, device=dev)
    b = torch.zeros_like(a)
    counts = torch.zeros((cap,), dtype=torch.float64, device=dev)
    counts[0] = float(n_samples)
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    valid[0] = True
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    shells = torch.arange(s, device=dev)

    for j in range(s):
        alpha = (a[:, None] >> shells) & 1
        beta_bits = (b[:, None] >> shells) & 1
        log_amp4, mask, probs = amp_conditional_shell(model, j, alpha, beta_bits)
        if beta != 1.0:
            # log-space tempering: masked options carry log_amp -> -inf-ish,
            # so exp gives exact zeros; renormalize over the valid options
            pt = torch.exp(2.0 * beta * log_amp4.to(torch.float64))
            probs = pt / torch.clamp(pt.sum(dim=-1, keepdim=True), min=1e-300)
        child_counts = multinomial4(gen, counts, probs) * mask   # drop unphysical
        child_valid = (child_counts > 0) & valid[:, None]
        a, b, counts, valid, n_children = _compact_children(
            a, b, child_counts, child_valid, j, cap)
        overflow = overflow | (n_children > cap)

    # pack model-order spin bits into state-order int64 bitstrings
    order = np.asarray(cfg.shell_order, dtype=np.int64)
    wa = torch.as_tensor(np.int64(1) << (2 * order), device=dev)
    alpha = (a[:, None] >> shells) & 1
    beta_bits = (b[:, None] >> shells) & 1
    states = torch.sum(alpha * wa + beta_bits * (wa << 1), dim=-1)
    states = torch.where(valid, states, SENTINEL)

    states, perm = torch.sort(states)
    counts = torch.where(valid[perm], counts[perm], 0.0)
    return SampleBatch(states=states, counts=counts, n_unique=valid.sum(),
                       overflow=overflow)
