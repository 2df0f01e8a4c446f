"""Vectorized 4-way multinomial splitting via a binomial cascade.

Splits each frontier state's sample count over its 4 child occupations.
Counts are float64 (sample counts reach 1e12, exactly representable). Port
of `naqs_tpu/ops/multinomial.py`, with the same sampler:
  * variance > 25: Gaussian approximation (error < 1e-3 in distribution,
    far below VMC sampling noise),
  * else: exact inverse-CDF over a 128-wide support window using the pmf
    ratio recurrence, with the p > 1/2 flip so the window starts at 0.
Per-row sums are conserved exactly by construction.

The draws are separate from the arithmetic. `split_draws` takes the normal
and uniform numbers of one split from the caller's torch.Generator (so they
differ from the JAX stream); `multinomial4_split(counts, probs, z, u, mask,
valid)` is a pure function of its inputs. On a CUDA tensor it launches the
hand-written kernel `multinomial4_split` of `csrc/sampler_step.cu` (one
thread per frontier row, built by nvcc at first use) or raises; on a CPU
tensor it runs the plain PyTorch version `multinomial4_split_ref`, which
keeps the JAX order of operations, step by step. There is no fallback from
one to the other. `multinomial4_split.launches` counts kernel launches.
`sample()` runs the same arithmetic (the kernels share one device function)
inside the fused shell step `sampler._split_and_compact`.

The kernel does the plain version's arithmetic in the same order with no
fused multiply-add (it names the rounding of every product and sum), leaves
the CDF loop once u <= cdf (the CDF never falls, so no later step can count)
and skips dead rows, whose result is zero in the plain version too. Its CDF
loop computes four looks ahead of their tests and divides by k from a table
of correctly rounded reciprocals with an FMA correction, which gives the
correctly rounded quotient of every dividend it takes (held to `__fdiv_rn`
on every float on the card); the others take `__fdiv_rn`.
"""

from __future__ import annotations

import torch

from naqs_tpu_torch.ops._build import check_tensors
from naqs_tpu_torch.ops.sampler_kernels import launch

_SMALL_SUPPORT = 128
_GAUSS_VAR_MIN = 25.0


def split_draws(gen: torch.Generator, n_rows: int, device):
    """(z, u), each (3, n_rows) f32: the standard normal and the uniform [0, 1)
    numbers of one 4-way split, one row per binomial of the cascade."""
    z = torch.randn((3, n_rows), generator=gen, device=device, dtype=torch.float32)
    u = torch.rand((3, n_rows), generator=gen, device=device, dtype=torch.float32)
    return z, u


def _binomial_from_draws(n, p, z, u):
    """k ~ Binomial(n, p) elementwise from a normal z and a uniform u (f32).
    Returns (k, var, small): the sample, the variance that picks the branch
    and the inverse CDF's count. Follows naqs_tpu/ops/multinomial.py::binomial
    operation by operation; the loop index is a device tensor, so that the
    division by it is a true division on every device."""
    p64 = torch.clamp(p.to(torch.float64), 0.0, 1.0)
    flip = p64 > 0.5
    q = torch.where(flip, 1.0 - p64, p64)
    mean = n * q
    var = mean * (1.0 - q)

    gauss = torch.round(mean + torch.sqrt(torch.clamp(var, min=0.0)) * z.to(torch.float64))

    # inverse CDF over k = 0..127 in f32: pmf_k = pmf_{k-1} (n-k+1)/k * odds,
    # small = #{k in 1..127 : u > cdf_{k-1}}
    pmf = torch.exp((n * torch.log1p(-torch.clamp(q, max=1.0 - 1e-15))).to(torch.float32))
    nf = n.to(torch.float32)
    qf = q.to(torch.float32)
    odds = qf / torch.clamp(1.0 - qf, min=1e-30)
    cdf = pmf
    small = torch.zeros_like(pmf)
    for kf in torch.arange(1, _SMALL_SUPPORT, device=n.device, dtype=torch.float32):
        pmf = pmf * torch.clamp(nf - kf + 1.0, min=0.0) / kf * odds
        small = small + (u > cdf)
        cdf = cdf + pmf
    small = small.to(torch.float64)

    k = torch.where(var > _GAUSS_VAR_MIN, gauss, small)
    k = torch.minimum(torch.clamp(k, min=0.0), n)
    k = torch.where(q <= 0.0, 0.0, torch.where(q >= 1.0, n, k))
    return torch.where(flip, n - k, k), var, small


def binomial(gen: torch.Generator, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample k ~ Binomial(n, p) elementwise. n: f64 counts >= 0, p in [0, 1].

    The split's plain arithmetic on one binomial, kept for tests of the
    distribution: on every device it runs the 127-step loop of elementwise
    calls and launches no kernel. The sampler's path is
    `sampler._split_and_compact`, which splits as `multinomial4_split` does."""
    n = n.to(torch.float64)
    z = torch.randn(n.shape, generator=gen, device=n.device, dtype=torch.float32)
    u = torch.rand(n.shape, generator=gen, device=n.device, dtype=torch.float32)
    return _binomial_from_draws(n, p, z, u)[0]


def _cascade(counts, probs, z, u):
    """The binomial cascade over children 3, 2, 1 in the JAX order of
    operations (naqs_tpu/ops/multinomial.py::multinomial4). Returns (what is
    left for child 0, [(count, var, small) of each binomial in that order])."""
    rem = counts.to(torch.float64)
    p = probs.to(torch.float64)
    ps = [p[:, 0]]
    for i in (1, 2, 3):
        ps.append(ps[-1] + p[:, i])
    ps = torch.stack(ps, dim=-1)
    condp = torch.where(ps > 0, p / torch.clamp(ps, min=1e-300), 0.0)
    steps = []
    for i in (3, 2, 1):
        k, var, small = _binomial_from_draws(rem, condp[:, i], z[3 - i], u[3 - i])
        c = torch.minimum(k, rem)
        steps.append((c, var, small))
        rem = rem - c
    return rem, steps


def multinomial4_split_ref(counts, probs, z, u, mask=None, valid=None):
    """Plain PyTorch version of `multinomial4_split`."""
    rem, steps = _cascade(counts, probs, z, u)
    child = torch.stack([rem] + [c for c, _, _ in steps[::-1]], dim=-1)
    if mask is not None:
        child = child * mask
    child_valid = child > 0
    if valid is not None:
        child = torch.where(valid[:, None], child, 0.0)
        child_valid = child_valid & valid[:, None]
    return child, child_valid


def multinomial4_split(counts, probs, z, u, mask=None, valid=None):
    """Split counts (U,) f64 >= 0 over 4 children by probs (U, 4) f32 or f64
    (>= 0, need not be normalized) with the draws z, u (3, U) f32 of
    `split_draws`.

    Returns (child_counts (U, 4) f64, child_valid (U, 4) bool): per row
    child_counts ~ Multinomial(counts, probs / sum(probs)), with row sums
    preserved exactly and the full count on child 0 where probs are all zero;
    then multiplied by `mask` (U, 4) bool where given (children that are not
    allowed lose their count) and zero in rows where `valid` (U,) bool is
    false. child_valid = child_counts > 0.
    """
    n = counts.shape[0]
    b = (torch.bool,)
    want = {"counts": (counts, (torch.float64,), (n,)),
            "probs": (probs, (torch.float32, torch.float64), (n, 4)),
            "z": (z, (torch.float32,), (3, n)), "u": (u, (torch.float32,), (3, n))}
    if mask is not None:
        want["mask"] = (mask, b, (n, 4))
    if valid is not None:
        want["valid"] = (valid, b, (n,))
    check_tensors("multinomial4_split", counts, want, align=16)
    if counts.device.type == "cpu":
        return multinomial4_split_ref(counts, probs, z, u, mask, valid)
    child = torch.empty((n, 4), dtype=torch.float64, device=counts.device)
    child_valid = torch.empty((n, 4), dtype=torch.bool, device=counts.device)
    if n == 0:
        return child, child_valid
    launch("multinomial4_split", (counts, probs, z, u, mask, valid, child, child_valid,
                                  n, int(probs.dtype == torch.float64)), counts.device)
    multinomial4_split.launches += 1
    return child, child_valid


multinomial4_split.launches = 0


def multinomial4(gen: torch.Generator, counts: torch.Tensor,
                 probs: torch.Tensor) -> torch.Tensor:
    """counts: (U,) f64 >= 0; probs: (U, 4) >= 0 (need not be normalized).

    Returns (U, 4) f64 child counts with per-row sums preserved:
    out[u] ~ Multinomial(counts[u], probs[u] / sum(probs[u])).
    Rows with all-zero probs put their full count on child 0.
    """
    counts = counts.to(torch.float64)
    z, u = split_draws(gen, counts.shape[0], counts.device)
    return multinomial4_split(counts, probs, z, u)[0]
