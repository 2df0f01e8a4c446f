"""Orbital-wise autoregressive NAQS ansatz as a PyTorch module.

The wavefunction factorizes over spatial-orbital "shells" (pairs of
spin-qubits): psi(s) = prod_i psi_i(occ_i | occ_<i), occ in {00, a, b, ab}.
Per shell there is an amplitude head (masked log-softmax over 4 occupations,
optionally spin-exchange-symmetrized from 5 logits) and a phase head.

Port of `naqs_tpu/models/nade.py` with the same parameter layout: every
shell's input is zero-padded to the common width 2(S-1) and the per-shell
networks are stacked weights w (S, d_in, d_out), b (S, d_out), so the full
conditional table of a batch is one batched product over shells. The phase
head is either one net per shell (`aggregate_phase`) or one global net on
the final shell's input.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

import numpy as np
import torch
from torch import nn

from naqs_tpu_torch.utils.bits import unpack_bits

# masked-logit value; exp(x/2) underflows to 0
BIG_NEG = -1e9


@dataclass(frozen=True)
class NAQSConfig:
    """Static model configuration (the fields of the JAX NAQSConfig)."""

    n_qubits: int
    sectors: Tuple[Tuple[int, int], ...]
    masking: Literal["none", "partial", "full"] = "partial"
    amp_hidden: Tuple[int, ...] = (64,)
    phase_hidden: Tuple[int, ...] = (512, 512)
    use_amp_spin_sym: bool = True
    use_phase_spin_sym: bool = False
    aggregate_phase: bool = False  # False -> one global phase net (production)
    num_lut: int = 0
    combined_amp_phase: bool = False
    phase_activation: Optional[str] = None
    input_encoding: Literal["binary", "integer"] = "binary"
    shell_order: Tuple[int, ...] = ()  # model shell j <- state shell order[j]
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.n_qubits % 2:
            raise ValueError("n_qubits must be even (orbital shells)")
        if not self.shell_order:
            # default: reversed shell order
            object.__setattr__(
                self, "shell_order", tuple(range(self.n_shells - 1, -1, -1)))
        if sorted(self.shell_order) != list(range(self.n_shells)):
            raise ValueError("shell_order must be a permutation of shells")
        for name, unported in (("num_lut", self.num_lut != 0),
                               ("combined_amp_phase", self.combined_amp_phase),
                               ("phase_activation", self.phase_activation is not None),
                               ("input_encoding", self.input_encoding != "binary"),
                               ("param_dtype", self.param_dtype != "float32")):
            if unported:
                raise NotImplementedError(
                    f"NAQSConfig.{name}={getattr(self, name)!r} is not ported yet")

    @property
    def n_shells(self) -> int:
        return self.n_qubits // 2

    @property
    def in_width(self) -> int:
        return 2 * max(self.n_shells - 1, 1)

    @property
    def n_amp_out(self) -> int:
        return 5 if self.use_amp_spin_sym else 4

    @property
    def n_phase_out(self) -> int:
        return 3 if self.use_phase_spin_sym else 4


class MLPStack(nn.Module):
    """Per-shell-stacked dense layers with ReLU between them:
    w[i] (n_stack, d_in, d_out), b[i] (n_stack, d_out)."""

    def __init__(self, n_stack: int, dims, generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / math.sqrt(max(d_in, 1))
            u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
            self.w.append(nn.Parameter(u(n_stack, d_in, d_out)))
            self.b.append(nn.Parameter(u(n_stack, d_out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n_stack, d_in) -> (..., n_stack, d_out)."""
        n = len(self.w)
        for li, (w, b) in enumerate(zip(self.w, self.b)):
            x = torch.einsum("...si,sio->...so", x, w) + b
            if li < n - 1:
                x = torch.relu(x)
        return x

    def single(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        """Apply one stack entry's layers to x (..., d_in)."""
        n = len(self.w)
        for li, (w, b) in enumerate(zip(self.w, self.b)):
            k = idx if w.shape[0] > 1 else 0
            x = x @ w[k] + b[k]
            if li < n - 1:
                x = torch.relu(x)
        return x


class NADE(nn.Module):
    """Parameters of the ansatz; `forward(states)` is `log_psi`."""

    def __init__(self, cfg: NAQSConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        s = cfg.n_shells
        self.amp = MLPStack(s, (cfg.in_width, *cfg.amp_hidden, cfg.n_amp_out),
                            generator)
        self.phase = MLPStack(s if cfg.aggregate_phase else 1,
                              (cfg.in_width, *cfg.phase_hidden, cfg.n_phase_out),
                              generator)

    def forward(self, states: torch.Tensor):
        return log_psi(self, states)


# ------------------------------------------------------------------- features

def split_spins(cfg: NAQSConfig, states: torch.Tensor):
    """Packed states -> (alpha, beta) occupation bits (B, S) in MODEL order."""
    bits = unpack_bits(states, cfg.n_qubits)
    order = torch.as_tensor(cfg.shell_order, device=states.device)
    return bits[..., 0::2][..., order], bits[..., 1::2][..., order]


def _excl_cumsum(x):
    return torch.cumsum(x, dim=-1) - x


def prefix_stats(alpha: torch.Tensor, beta: torch.Tensor) -> dict:
    """Per-shell prefix statistics (exclusive over shells < j): counts
    (ca, cb), prefix integers (pa, pb) with shell t weighted 2^t, and the
    exchange order flag (0: pa > pb, 1: equal, 2: pa < pb)."""
    s = alpha.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=alpha.device) << torch.arange(
        s, device=alpha.device)
    pa = _excl_cumsum(alpha * w)
    pb = _excl_cumsum(beta * w)
    order3 = torch.where(pa > pb, 0, torch.where(pa == pb, 1, 2))
    return {"ca": _excl_cumsum(alpha), "cb": _excl_cumsum(beta),
            "pa": pa, "pb": pb, "order3": order3}


def _signed(bits):
    return (2 * bits - 1).to(torch.float32)


def shell_inputs(cfg: NAQSConfig, alpha, beta, canonical: bool,
                 order3: torch.Tensor | None = None):
    """(B, S, in_width) inputs for every shell: signed +-1 bits, layout
    [first substring (S-1 slots), second substring]; with `canonical` the
    lexicographically smaller spin substring goes first."""
    s = cfg.n_shells
    dev = alpha.device
    causal = torch.arange(s - 1, device=dev)[None, :] < torch.arange(s, device=dev)[:, None]
    a_in = _signed(alpha)[..., None, : s - 1] * causal
    b_in = _signed(beta)[..., None, : s - 1] * causal
    if canonical:
        if order3 is None:
            order3 = prefix_stats(alpha, beta)["order3"]
        swap = (order3 == 0)[..., None]
        a_in, b_in = torch.where(swap, b_in, a_in), torch.where(swap, a_in, b_in)
    return torch.cat([a_in, b_in], dim=-1)


# _SYM_GATHER[order3] maps the 5 raw amp logits onto 4 occupations
# [00, a, b, ab] (occ index = alpha + 2*beta). Logits: [l00, l_sym01, l11,
# d1, d2]; symmetrized output = (base + gathered) / 2.
_SYM_BASE = [0, 1, 1, 2]
_SYM_GATHER = np.array([[0, 3, 4, 2], [0, 1, 1, 2], [0, 4, 3, 2]])


def symmetrize_amp(logits5: torch.Tensor, order3: torch.Tensor) -> torch.Tensor:
    """(..., 5) + order flag -> (..., 4) exchange-symmetric amp logits."""
    base = logits5[..., _SYM_BASE]
    gidx = torch.as_tensor(_SYM_GATHER, device=logits5.device)[order3]
    return 0.5 * (base + torch.take_along_dim(logits5, gidx, dim=-1))


def occupation_mask(cfg: NAQSConfig, ca, cb, j=None):
    """(..., 4) bool mask of occupations allowed by the electron-number
    budgets, OR'd over sectors. ca, cb: prefix up-counts; j: shell index."""
    s = cfg.n_shells
    if j is None:
        j = torch.arange(s, device=ca.device).expand(ca.shape)
    da, db = j - ca, j - cb  # prefix down-counts
    mask = torch.zeros((*ca.shape, 4), dtype=torch.bool, device=ca.device)
    for (na, nb) in cfg.sectors:
        ok = (ca <= na) & (da <= s - na) & (cb <= nb) & (db <= s - nb)
        a1, a0 = ca < na, da < s - na
        b1, b0 = cb < nb, db < s - nb
        m = torch.stack([a0 & b0, a1 & b0, a0 & b1, a1 & b1], dim=-1)
        mask = mask | (m & ok[..., None])
    return mask


def masked_log_softmax_half(logits4: torch.Tensor, mask) -> torch.Tensor:
    """0.5 * log_softmax(2x) with masked options pushed to BIG_NEG. A row
    with no allowed option emits BIG_NEG/2 amplitudes, not log(1/4)."""
    z = 2.0 * logits4
    if mask is not None:
        z = torch.where(mask, z, BIG_NEG)
    out = 0.5 * torch.log_softmax(z, dim=-1)
    if mask is not None:
        out = torch.where(mask.any(dim=-1, keepdim=True), out, 0.5 * BIG_NEG)
    return out


def _last_shell_only(raw_last: torch.Tensor, s: int) -> torch.Tensor:
    """(..., d) -> (..., S, d), zero at every shell but the last."""
    zeros = raw_last.new_zeros((*raw_last.shape[:-1], s - 1, raw_last.shape[-1]))
    return torch.cat([zeros, raw_last[..., None, :]], dim=-2)


def _tables(model: NADE, alpha, beta, st):
    """Per-shell conditional tables (log_amp4, mask4, phase4), each
    (..., S, 4) in MODEL shell order."""
    cfg = model.cfg
    s = cfg.n_shells
    x_amp = shell_inputs(cfg, alpha, beta, cfg.use_amp_spin_sym, st["order3"])
    raw_amp = model.amp(x_amp)
    x_ph = (x_amp if cfg.use_phase_spin_sym == cfg.use_amp_spin_sym
            else shell_inputs(cfg, alpha, beta, cfg.use_phase_spin_sym, st["order3"]))
    if cfg.aggregate_phase:
        raw_phase = model.phase(x_ph)
    else:
        # one global net evaluated on the final shell's input
        raw_phase = _last_shell_only(model.phase.single(0, x_ph[..., s - 1, :]), s)

    logits4 = symmetrize_amp(raw_amp, st["order3"]) if cfg.use_amp_spin_sym else raw_amp
    if cfg.masking == "none":
        mask = None
    else:
        mask = occupation_mask(cfg, st["ca"], st["cb"])
        if cfg.masking == "partial":
            mask[..., s - 1, :] = True  # last shell unmasked
    log_amp = masked_log_softmax_half(logits4, mask)

    if cfg.use_phase_spin_sym:
        phase4 = raw_phase[..., [0, 1, 1, 2]]
        # exchange phase shift pi*(N01 mod 2) on the canonical-swapped
        # partner, applied at the last shell
        full_pa = st["pa"][..., s - 1] + alpha[..., s - 1] * (1 << (s - 1))
        full_pb = st["pb"][..., s - 1] + beta[..., s - 1] * (1 << (s - 1))
        n01 = torch.sum((alpha == 0) & (beta == 1), dim=-1)
        shift = torch.where(full_pa < full_pb, math.pi * (n01 % 2), 0.0)
        phase4 = phase4 + _last_shell_only(
            shift[..., None].expand(*shift.shape, 4).to(phase4.dtype), s)
    else:
        phase4 = raw_phase
    return log_amp, mask, phase4


def shell_tables(model: NADE, states: torch.Tensor):
    """(log_amp, phase) conditional tables for packed states, each (B, S, 4)
    in MODEL shell order."""
    alpha, beta = split_spins(model.cfg, states)
    log_amp, _, phase = _tables(model, alpha, beta, prefix_stats(alpha, beta))
    return log_amp, phase


def log_psi(model: NADE, states: torch.Tensor):
    """log|psi| and arg(psi) (f32) for packed int64 states."""
    alpha, beta = split_spins(model.cfg, states)
    log_amp4, _, phase4 = _tables(model, alpha, beta, prefix_stats(alpha, beta))
    occ = (alpha + 2 * beta)[..., None]
    la = torch.take_along_dim(log_amp4, occ, dim=-1)[..., 0]
    ph = torch.take_along_dim(phase4, occ, dim=-1)[..., 0]
    return la.sum(dim=-1), ph.sum(dim=-1)


def amp_conditional_shell(model: NADE, j: int, alpha, beta):
    """Masked amp table for ONE shell j over a frontier.

    alpha, beta: (U, S) prefix occupation bits (entries at shells >= j are
    0). Returns (log_amp4, mask4, probs4), each (U, 4); `mask4` is the
    electron-number mask even where partial masking leaves it unapplied.
    """
    cfg = model.cfg
    s = cfg.n_shells
    dev = alpha.device
    before = torch.arange(s, device=dev) < j
    a_in = _signed(alpha)[..., : s - 1] * before[: s - 1]
    b_in = _signed(beta)[..., : s - 1] * before[: s - 1]
    w = (torch.ones((), dtype=torch.int64, device=dev)
         << torch.arange(s, device=dev)) * before
    pa = torch.sum(alpha * w, dim=-1)
    pb = torch.sum(beta * w, dim=-1)
    order3 = torch.where(pa > pb, 0, torch.where(pa == pb, 1, 2))
    if cfg.use_amp_spin_sym:
        swap = (order3 == 0)[..., None]
        a_in, b_in = torch.where(swap, b_in, a_in), torch.where(swap, a_in, b_in)
    raw = model.amp.single(j, torch.cat([a_in, b_in], dim=-1))
    logits4 = symmetrize_amp(raw, order3) if cfg.use_amp_spin_sym else raw

    ca = torch.sum(alpha * before, dim=-1)
    cb = torch.sum(beta * before, dim=-1)
    mask = occupation_mask(cfg, ca, cb, j=torch.full_like(ca, j))
    if cfg.masking == "none" or (cfg.masking == "partial" and j == s - 1):
        log_amp = masked_log_softmax_half(logits4, None)
    else:
        log_amp = masked_log_softmax_half(logits4, mask)
    return log_amp, mask, torch.exp(2.0 * log_amp)
