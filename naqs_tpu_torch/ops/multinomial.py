"""Vectorized 4-way multinomial splitting via a binomial cascade.

Splits each frontier state's sample count over its 4 child occupations.
Counts are float64 (sample counts reach 1e12, exactly representable). Port
of `naqs_tpu/ops/multinomial.py`, with the same sampler:
  * variance > 25: Gaussian approximation (error < 1e-3 in distribution,
    far below VMC sampling noise),
  * else: exact inverse-CDF over a 128-wide support window using the pmf
    ratio recurrence, with the p > 1/2 flip so the window starts at 0.
The inverse CDF is evaluated for all 128 support points at once (a cumulative
product over a (U, 127) tensor) instead of a 127-step loop. Per-row sums are
conserved exactly by construction. Random numbers come from the caller's
torch.Generator, so they differ from the JAX stream.
"""

from __future__ import annotations

import torch

_SMALL_SUPPORT = 128
_GAUSS_VAR_MIN = 25.0


def binomial(gen: torch.Generator, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample k ~ Binomial(n, p) elementwise. n: f64 counts >= 0, p in [0, 1]."""
    n = n.to(torch.float64)
    p64 = torch.clamp(p.to(torch.float64), 0.0, 1.0)
    flip = p64 > 0.5
    q = torch.where(flip, 1.0 - p64, p64)
    mean = n * q
    var = mean * (1.0 - q)

    z = torch.randn(n.shape, generator=gen, device=n.device, dtype=torch.float32)
    gauss = torch.round(mean + torch.sqrt(torch.clamp(var, min=0.0)) * z.to(torch.float64))

    # inverse CDF over k = 0..127 in f32: pmf_k = pmf_{k-1} (n-k+1)/k * odds,
    # small = #{k in 1..127 : u > cdf_{k-1}}
    u = torch.rand(n.shape, generator=gen, device=n.device, dtype=torch.float32)
    pmf0 = torch.exp((n * torch.log1p(-torch.clamp(q, max=1.0 - 1e-15))).to(torch.float32))
    nf = n.to(torch.float32)[..., None]
    qf = q.to(torch.float32)
    odds = (qf / torch.clamp(1.0 - qf, min=1e-30))[..., None]
    j = torch.arange(1, _SMALL_SUPPORT, device=n.device, dtype=torch.float32)
    ratio = torch.clamp(nf - j + 1.0, min=0.0) / j * odds
    pmf = torch.cat([pmf0[..., None], pmf0[..., None] * torch.cumprod(ratio, dim=-1)],
                    dim=-1)
    cdf = torch.cumsum(pmf[..., :-1], dim=-1)   # cdf_{k-1}, k = 1..127
    small = torch.sum(u[..., None] > cdf, dim=-1).to(torch.float64)

    k = torch.where(var > _GAUSS_VAR_MIN, gauss, small)
    k = torch.minimum(torch.clamp(k, min=0.0), n)
    k = torch.where(q <= 0.0, 0.0, torch.where(q >= 1.0, n, k))
    return torch.where(flip, n - k, k)


def multinomial4(gen: torch.Generator, counts: torch.Tensor,
                 probs: torch.Tensor) -> torch.Tensor:
    """counts: (U,) f64 >= 0; probs: (U, 4) >= 0 (need not be normalized).

    Returns (U, 4) f64 child counts with per-row sums preserved:
    out[u] ~ Multinomial(counts[u], probs[u] / sum(probs[u])).
    Rows with all-zero probs put their full count on child 0.
    """
    rem = counts.to(torch.float64)
    p = probs.to(torch.float64)
    ps = torch.cumsum(p, dim=-1)
    condp = torch.where(ps > 0, p / torch.clamp(ps, min=1e-300), 0.0)
    out = []
    for i in (3, 2, 1):
        c = torch.minimum(binomial(gen, rem, condp[:, i]), rem)
        out.append(c)
        rem = rem - c
    out.append(rem)
    return torch.stack(out[::-1], dim=-1)
