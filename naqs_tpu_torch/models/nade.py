"""Orbital-wise autoregressive NAQS ansatz as a PyTorch module.

The wavefunction factorizes over spatial-orbital "shells" (pairs of
spin-qubits): psi(s) = prod_i psi_i(occ_i | occ_<i), occ in {00, a, b, ab}.
Per shell there is an amplitude head (masked log-softmax over 4 occupations,
optionally spin-exchange-symmetrized from 5 logits) and a phase head.

Port of `naqs_tpu/models/nade.py` with the same parameter layout: every
shell's input is zero-padded to the common width (2(S-1) signed bits, or
S-1 integers with the integer encoding) and the per-shell networks are
stacked weights w (S, d_in, d_out), b (S, d_out), so the full conditional
table of a batch is one batched product over shells. The phase head is
either one net per shell (`aggregate_phase`) or one global net on the final
shell's input, or, with `combined_amp_phase`, extra outputs of the amplitude
trunk. With `num_lut`, the first shells read their raw outputs from
learnable lookup tables (one row per input pattern) instead of the MLP.

Parameters are held in `param_dtype`; the products run in the type JAX
promotes float32 inputs and such weights to (float32 for bfloat16 weights,
float64 for float64 ones), so the outputs have that type too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Literal, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naqs_tpu_torch.utils.bits import unpack_bits

# masked-logit value; exp(x/2) underflows to 0
BIG_NEG = -1e9

PARAM_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16}


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
    num_lut: int = 0               # leading shells use lookup-table conditionals
    combined_amp_phase: bool = False  # one trunk emits amp+phase outputs
    phase_activation: Optional[str] = None  # none|softsign|tanh|hardtanh|sin|sigmoid
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
        if not (0 <= self.num_lut <= min(self.n_shells, 8)):
            raise ValueError("num_lut must be in [0, min(n_shells, 8)]")
        if self.num_lut >= self.n_shells and not self.aggregate_phase:
            raise ValueError("num_lut == n_shells with a single phase net is unsupported")
        if self.combined_amp_phase and self.use_amp_spin_sym != self.use_phase_spin_sym:
            # a combined trunk has one input, so one spin-symmetry setting
            object.__setattr__(self, "use_phase_spin_sym", self.use_amp_spin_sym)

    @property
    def n_shells(self) -> int:
        return self.n_qubits // 2

    @property
    def in_width(self) -> int:
        # binary: 2(S-1) signed bits; integer: one value per previous shell
        if self.input_encoding == "integer":
            return max(self.n_shells - 1, 1)
        return 2 * max(self.n_shells - 1, 1)

    @property
    def n_amp_out(self) -> int:
        return 5 if self.use_amp_spin_sym else 4

    @property
    def n_phase_out(self) -> int:
        return 3 if self.use_phase_spin_sym else 4

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' torch dtype."""
        if self.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(PARAM_DTYPES)}, "
                             f"got {self.param_dtype!r}")
        return PARAM_DTYPES[self.param_dtype]

    @property
    def compute_dtype(self) -> torch.dtype:
        """The type of the products: float32 inputs times the parameters,
        promoted as JAX promotes them."""
        return torch.promote_types(torch.float32, self.dtype)


def _amp_out_dim(cfg: NAQSConfig) -> int:
    return cfg.n_amp_out + (cfg.n_phase_out if cfg.combined_amp_phase else 0)


def _uniform(shape, bound, dtype, generator):
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    u = torch.rand(shape, generator=generator, dtype=draw)
    return ((u * 2 - 1) * bound).to(dtype)


class MLPStack(nn.Module):
    """Per-shell-stacked dense layers with ReLU between them:
    w[i] (n_stack, d_in, d_out), b[i] (n_stack, d_out)."""

    def __init__(self, n_stack: int, dims, generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        self.compute_dtype = torch.promote_types(torch.float32, dtype)
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / math.sqrt(max(d_in, 1))
            self.w.append(nn.Parameter(_uniform((n_stack, d_in, d_out), bound, dtype,
                                                generator)))
            self.b.append(nn.Parameter(_uniform((n_stack, d_out), bound, dtype, generator)))

    def forward(self, x: torch.Tensor, eps=None, taps=None) -> torch.Tensor:
        """x: (..., n_stack, d_in) -> (..., n_stack, d_out).

        `eps`: optional per-layer perturbations added to each pre-activation
        (zeros: the gradient w.r.t. eps[li] is the per-example pre-activation
        gradient); `taps`: a list that collects each layer's input. Both
        serve K-FAC's factors (`naqs_tpu_torch/kfac.py`)."""
        n = len(self.w)
        c = self.compute_dtype
        x = x.to(c)
        for li, (w, b) in enumerate(zip(self.w, self.b)):
            if taps is not None:
                taps.append(x)
            x = torch.einsum("...si,sio->...so", x, w.to(c)) + b.to(c)
            if eps is not None:
                x = x + eps[li]
            if li < n - 1:
                x = torch.relu(x)
        return x

    def single(self, idx: int, x: torch.Tensor, eps=None, taps=None) -> torch.Tensor:
        """Apply one stack entry's layers to x (..., d_in); `eps` and `taps` as
        in `forward`."""
        n = len(self.w)
        c = self.compute_dtype
        x = x.to(c)
        for li, (w, b) in enumerate(zip(self.w, self.b)):
            if taps is not None:
                taps.append(x)
            k = idx if w.shape[0] > 1 else 0
            x = x @ w[k].to(c) + b[k].to(c)
            if eps is not None:
                x = x + eps[li]
            if li < n - 1:
                x = torch.relu(x)
        return x


def _lut_base(cfg: NAQSConfig, canonical: bool) -> int:
    """Digits per previous shell in a LUT row index."""
    if cfg.input_encoding == "integer":
        return 3 if canonical else 4
    return 4  # two binary bits per shell


def _tables_of(n: int, base: int, width: int, dtype, generator) -> nn.ParameterList:
    """Lookup tables of shells 0..n-1: shell j has base**j rows of `width`."""
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    return nn.ParameterList(
        nn.Parameter(torch.randn((base**j, width), generator=generator, dtype=draw).to(dtype))
        for j in range(n))


class NADE(nn.Module):
    """Parameters of the ansatz; `forward(states)` is `log_psi`. Groups:
    `amp` (the amplitude trunk, with the phase outputs too under
    `combined_amp_phase`), `phase` (absent under `combined_amp_phase`),
    `lut` and `lut_phase` (with `num_lut`; `lut_phase` only for per-shell
    phase nets)."""

    def __init__(self, cfg: NAQSConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        s = cfg.n_shells
        dtype = cfg.dtype
        n_out = _amp_out_dim(cfg)
        self.amp = MLPStack(s, (cfg.in_width, *cfg.amp_hidden, n_out), generator, dtype)
        if not cfg.combined_amp_phase:
            self.phase = MLPStack(s if cfg.aggregate_phase else 1,
                                  (cfg.in_width, *cfg.phase_hidden, cfg.n_phase_out),
                                  generator, dtype)
        if cfg.num_lut:
            self.lut = _tables_of(cfg.num_lut, _lut_base(cfg, cfg.use_amp_spin_sym), n_out,
                                  dtype, generator)
            if cfg.aggregate_phase and not cfg.combined_amp_phase:
                self.lut_phase = _tables_of(cfg.num_lut,
                                            _lut_base(cfg, cfg.use_phase_spin_sym),
                                            cfg.n_phase_out, dtype, generator)

    def forward(self, states: torch.Tensor):
        return log_psi(self, states)


def count_parameters(model: NADE) -> int:
    return int(sum(p.numel() for p in model.parameters()))


# ------------------------------------------------------------------- features

@lru_cache(maxsize=64)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index tensor of constant values on the device, made once per
    device: an index given as a list or a numpy array is copied to the card
    at every call, a host sync that a window of updates must not take."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def split_spins(cfg: NAQSConfig, states: torch.Tensor):
    """Packed states -> (alpha, beta) occupation bits (B, S) in MODEL order."""
    bits = unpack_bits(states, cfg.n_qubits)
    order = _index(tuple(cfg.shell_order), states.device)
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


def _integer_inputs(alpha, beta, canonical: bool):
    """One value per shell: the exchange-invariant a+b-1 when canonical,
    else 2a+b."""
    v = alpha + beta - 1 if canonical else 2 * alpha + beta
    return v.to(torch.float32)


def shell_inputs(cfg: NAQSConfig, alpha, beta, canonical: bool,
                 order3: torch.Tensor | None = None):
    """(B, S, in_width) inputs for every shell. Binary encoding: signed +-1
    bits, layout [first substring (S-1 slots), second substring]; with
    `canonical` the lexicographically smaller spin substring goes first.
    Integer encoding: one value per previous shell (`_integer_inputs`)."""
    s = cfg.n_shells
    dev = alpha.device
    causal = torch.arange(s - 1, device=dev)[None, :] < torch.arange(s, device=dev)[:, None]
    if cfg.input_encoding == "integer":
        return _integer_inputs(alpha, beta, canonical)[..., None, : s - 1] * causal
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
_SYM_BASE = (0, 1, 1, 2)
_SYM_GATHER = ((0, 3, 4, 2), (0, 1, 1, 2), (0, 4, 3, 2))


def symmetrize_amp(logits5: torch.Tensor, order3: torch.Tensor) -> torch.Tensor:
    """(..., 5) + order flag -> (..., 4) exchange-symmetric amp logits."""
    base = logits5[..., _index(_SYM_BASE, logits5.device)]
    gidx = _index(_SYM_GATHER, logits5.device)[order3]
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


def scaled_phase_activation(name: str, x: torch.Tensor, mask=None) -> torch.Tensor:
    """Scaled phase activations: map raw outputs into [-pi, pi]-ish ranges;
    where the amplitude mask leaves only one option (a deterministic output),
    the phase is pinned to 0."""
    if name == "softsign":
        y = math.pi * x / (1.0 + torch.abs(x))
    elif name == "tanh":
        y = math.pi * torch.tanh(x)
    elif name == "hardtanh":
        y = math.pi * torch.clamp(x, -1.0, 1.0)
    elif name == "sin":
        y = math.pi * torch.sin(x) ** 2
    elif name == "sigmoid":
        y = math.pi * torch.sigmoid(x)
    else:
        raise ValueError(f"unknown phase activation '{name}'")
    if mask is not None and y.shape[-1] == mask.shape[-1]:
        deterministic = mask.sum(dim=-1, keepdim=True) == 1
        y = torch.where(deterministic & mask, 0.0, y)
    return y


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


# ------------------------------------------------------------------- LUTs

def _lut_index(cfg: NAQSConfig, x: torch.Tensor, j: int, canonical: bool = True):
    """LUT row index for shell j from one shell's input rows x (..., in_width)."""
    s = cfg.n_shells
    if j == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    if cfg.input_encoding == "integer":
        base = _lut_base(cfg, canonical)
        digits = torch.round(x[..., :j]).to(torch.int64) + (1 if canonical else 0)
        w = base ** torch.arange(j, device=x.device)
        return torch.sum(digits * w, dim=-1)
    first = (x[..., :j] > 0).to(torch.int64)
    second = (x[..., s - 1:s - 1 + j] > 0).to(torch.int64)
    w = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(j, device=x.device)
    return torch.sum(first * w, dim=-1) + torch.sum(second * (w << j), dim=-1)


def _lut_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as an embedding lookup: its backward sums the gradients of
    rows that share an index after sorting them, where the backward of
    `table[idx]` accumulates them one after another (a batch maps all its
    rows to a handful of table rows; tools/variant_cost.py times both)."""
    return F.embedding(idx, table)


def _apply_luts(cfg: NAQSConfig, tables, x, raw, canonical: bool):
    """raw (..., S, d) with the rows of shells < num_lut read from their
    tables (cast to raw's dtype) instead."""
    rows = [_lut_rows(tables[j], _lut_index(cfg, x[..., j, :], j, canonical)).to(raw.dtype)
            for j in range(cfg.num_lut)]
    return torch.cat([torch.stack(rows, dim=-2), raw[..., cfg.num_lut:, :]], dim=-2)


# ------------------------------------------------------------------- predict

def _tables(model: NADE, alpha, beta, st, eps=None, taps=None):
    """Per-shell conditional tables (log_amp4, mask4, phase4), each
    (..., S, 4) in MODEL shell order.

    eps/taps: optional K-FAC instrumentation dicts keyed "amp"/"phase" (see
    `MLPStack.forward`); only the dense layers are tapped, not the LUT
    shells."""
    cfg = model.cfg
    s = cfg.n_shells
    eps = eps or {}
    x_amp = shell_inputs(cfg, alpha, beta, cfg.use_amp_spin_sym, st["order3"])
    raw = model.amp(x_amp, eps.get("amp"),
                    None if taps is None else taps.setdefault("amp", []))
    if cfg.num_lut:
        raw = _apply_luts(cfg, model.lut, x_amp, raw, cfg.use_amp_spin_sym)
    if cfg.combined_amp_phase:
        raw_amp, raw_phase = raw[..., :cfg.n_amp_out], raw[..., cfg.n_amp_out:]
    else:
        raw_amp = raw
        x_ph = (x_amp if cfg.use_phase_spin_sym == cfg.use_amp_spin_sym
                else shell_inputs(cfg, alpha, beta, cfg.use_phase_spin_sym, st["order3"]))
        ph_taps = None if taps is None else taps.setdefault("phase", [])
        if cfg.aggregate_phase:
            raw_phase = model.phase(x_ph, eps.get("phase"), ph_taps)
            if cfg.num_lut:
                raw_phase = _apply_luts(cfg, model.lut_phase, x_ph, raw_phase,
                                        cfg.use_phase_spin_sym)
        else:
            # one global net evaluated on the final shell's input
            raw_phase = _last_shell_only(
                model.phase.single(0, x_ph[..., s - 1, :], eps.get("phase"), ph_taps), s)

    logits4 = symmetrize_amp(raw_amp, st["order3"]) if cfg.use_amp_spin_sym else raw_amp
    if cfg.masking == "none":
        mask = None
    else:
        mask = occupation_mask(cfg, st["ca"], st["cb"])
        if cfg.masking == "partial":
            mask[..., s - 1, :] = True  # last shell unmasked
    log_amp = masked_log_softmax_half(logits4, mask)

    if cfg.phase_activation is not None:
        # over every shell, the global net's zero rows too: sigmoid puts
        # pi/2 on those of them whose mask leaves a choice, as in JAX
        raw_phase = scaled_phase_activation(cfg.phase_activation, raw_phase, mask)
    if cfg.use_phase_spin_sym:
        phase4 = raw_phase[..., _index(_SYM_BASE, raw_phase.device)]
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


def _log_psi(model: NADE, states: torch.Tensor, eps=None, taps=None):
    alpha, beta = split_spins(model.cfg, states)
    log_amp4, _, phase4 = _tables(model, alpha, beta, prefix_stats(alpha, beta), eps, taps)
    occ = (alpha + 2 * beta)[..., None]
    la = torch.take_along_dim(log_amp4, occ, dim=-1)[..., 0]
    ph = torch.take_along_dim(phase4, occ, dim=-1)[..., 0]
    return la.sum(dim=-1), ph.sum(dim=-1)


def log_psi(model: NADE, states: torch.Tensor):
    """log|psi| and arg(psi) for packed int64 states, in the model's
    compute dtype (float32 unless the parameters are float64)."""
    return _log_psi(model, states)


def make_zero_eps(model: NADE, batch_size: int) -> dict:
    """Zero pre-activation perturbations matching `log_psi_taps`'s forward,
    keyed "amp"/"phase", one per dense layer: (B, n_stack, d_out), or (B,
    d_out) for the global phase net, in each bias's dtype on its device.
    Differentiating w.r.t. them gives the per-example pre-activation
    gradients (the g of K-FAC's G = E[g g^T])."""
    eps = {}
    for name in ("amp", "phase"):
        if not hasattr(model, name):
            continue
        layers = []
        for b in getattr(model, name).b:
            n_stack, d_out = b.shape
            shape = ((batch_size, d_out) if name == "phase" and not model.cfg.aggregate_phase
                     else (batch_size, n_stack, d_out))
            layers.append(torch.zeros(shape, dtype=b.dtype, device=b.device))
        eps[name] = layers
    return eps


def log_psi_taps(model: NADE, states: torch.Tensor, eps: dict):
    """`log_psi` with K-FAC instrumentation: adds `eps` (`make_zero_eps`) to
    every dense pre-activation and keeps each dense layer's input. Returns
    ((log_amp, phase), taps), taps[name][li] the input of layer li of stack
    `name`."""
    taps: dict = {}
    return _log_psi(model, states, eps, taps), taps


def amp_conditional_shell(model: NADE, j: int, alpha, beta):
    """Masked amp table for ONE shell j over a frontier.

    alpha, beta: (U, S) prefix occupation bits (entries at shells >= j are
    0). Returns (log_amp4, mask4, probs4), each (U, 4); `mask4` is the
    electron-number mask even where partial masking leaves it unapplied.
    A LUT shell (j < num_lut) reads its table row and skips the MLP.
    """
    cfg = model.cfg
    s = cfg.n_shells
    dev = alpha.device
    before = torch.arange(s, device=dev) < j
    w = (torch.ones((), dtype=torch.int64, device=dev)
         << torch.arange(s, device=dev)) * before
    pa = torch.sum(alpha * w, dim=-1)
    pb = torch.sum(beta * w, dim=-1)
    order3 = torch.where(pa > pb, 0, torch.where(pa == pb, 1, 2))
    if cfg.input_encoding == "integer":
        x = (_integer_inputs(alpha, beta, cfg.use_amp_spin_sym)[..., : s - 1]
             * before[: s - 1])
    else:
        a_in = _signed(alpha)[..., : s - 1] * before[: s - 1]
        b_in = _signed(beta)[..., : s - 1] * before[: s - 1]
        if cfg.use_amp_spin_sym:
            swap = (order3 == 0)[..., None]
            a_in, b_in = torch.where(swap, b_in, a_in), torch.where(swap, a_in, b_in)
        x = torch.cat([a_in, b_in], dim=-1)
    if j < cfg.num_lut:
        idx = _lut_index(cfg, x, j, cfg.use_amp_spin_sym)
        raw = _lut_rows(model.lut[j], idx).to(cfg.compute_dtype)
    else:
        raw = model.amp.single(j, x)
    if cfg.combined_amp_phase:
        raw = raw[..., :cfg.n_amp_out]
    logits4 = symmetrize_amp(raw, order3) if cfg.use_amp_spin_sym else raw

    ca = torch.sum(alpha * before, dim=-1)
    cb = torch.sum(beta * before, dim=-1)
    mask = occupation_mask(cfg, ca, cb, j=torch.full_like(ca, j))
    if cfg.masking == "none" or (cfg.masking == "partial" and j == s - 1):
        log_amp = masked_log_softmax_half(logits4, None)
    else:
        log_amp = masked_log_softmax_half(logits4, mask)
    return log_amp, mask, torch.exp(2.0 * log_amp)
