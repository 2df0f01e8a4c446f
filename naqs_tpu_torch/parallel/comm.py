"""The collectives of the sharded steps over `torch.distributed`: what
`jax.lax` gives the JAX package's steps over the mesh axis "dp"
(`axis_index`, `all_gather`, `psum`).

Every collective runs on its tensors' own device, in the process group that
`parallel.multihost.initialize_distributed` set up: NCCL across cards, gloo
on the CPU and for ranks that share one card. A failed collective raises;
nothing is retried, and no other route is taken.

One route gathers on both backends, chosen so that the CPU tests run the
code the card runs: `all_gather_rows` writes each rank's rows, as raw int64
words, into its slot of a zero-filled (D, n, words) buffer and sums the
buffer over the ranks with one `all_reduce`. Every slot but one holds zeros
and x + 0 = x in int64, so the result is every rank's bytes, bit for bit,
whatever the dtype (the sign of a float zero, NaN payloads included). gloo
has no all-gather of CUDA tensors, so a native all-gather could not serve
the ranks that share one card; the sum moves about twice the bytes of one,
a few MB a step at the paper's widths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ROUTE = ("all_gather_rows: each rank's rows as int64 words in its slot of a zero-filled "
         "(D, n, words) buffer, one SUM all_reduce of the buffer; sums: all_reduce")


def rank() -> int:
    """This process's rank in the group (`jax.lax.axis_index("dp")`)."""
    return dist.get_rank()


def world() -> int:
    """The number of ranks in the group (the mesh's size)."""
    return dist.get_world_size()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (`jax.lax.psum`), as a new tensor; `t` is
    left as it was. Every rank gets the same bits."""
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor of a list over the ranks, in place, with one
    collective per dtype (the tensors flattened into one buffer)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        for t, piece in zip(group, torch.split(flat, [t.numel() for t in group])):
            t.copy_(piece.view_as(t))


def _words(t: torch.Tensor) -> torch.Tensor:
    """The rows of t as (n, w) int64 words: each row's bytes, zero-padded to a
    whole word."""
    n = t.shape[0]
    raw = t.detach().contiguous().reshape(n, -1).view(torch.uint8)
    pad = -raw.shape[1] % 8
    if pad:
        raw = torch.cat([raw, raw.new_zeros((n, pad))], dim=1)
    return raw.view(torch.int64)


def all_gather_rows(*tensors: torch.Tensor):
    """Each tensor's rows of every rank, in rank order (`jax.lax.all_gather(t,
    "dp")` reshaped to (D * n, ...)): bit for bit, in one collective for all
    the tensors (they share their leading length n). Returns one tensor, or a
    tuple of them for several."""
    n = tensors[0].shape[0]
    if any(t.shape[0] != n for t in tensors):
        raise ValueError("all_gather_rows: the tensors' leading lengths differ")
    pieces = [_words(t) for t in tensors]
    widths = [p.shape[1] for p in pieces]
    d, r = world(), rank()
    buf = torch.zeros((d, n, sum(widths)), dtype=torch.int64, device=tensors[0].device)
    buf[r] = torch.cat(pieces, dim=1)
    dist.all_reduce(buf)
    out = []
    for t, words in zip(tensors, torch.split(buf.reshape(d * n, -1), widths, dim=1)):
        row = t[0].numel() * t.element_size()
        raw = words.contiguous().view(torch.uint8)[:, :row].contiguous()
        out.append(raw.view(t.dtype).reshape(d * n, *t.shape[1:]))
    return out[0] if len(out) == 1 else tuple(out)
