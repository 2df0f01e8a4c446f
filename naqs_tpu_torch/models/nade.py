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

Around the nets, the glue is four hand kernels (`ops/nade_glue.py`,
`csrc/nade_glue.cu`): the sampler's shell head and tail
(`amp_conditional_shell`), and `log_psi`'s features and the tables' tail
with the gather and sum over shells, whose vjp and jvp are kernels too.
The plain helpers of the features and tables live there and are
re-exported here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naqs_tpu_torch.ops.nade_glue import (  # noqa: F401  (the features' helpers, re-exported)
    BIG_NEG, _index, epilogue_tables_ref, log_psi_epilogue, masked_log_softmax_half,
    occupation_mask, prefix_stats, scaled_phase_activation, shell_epilogue, shell_features,
    shell_inputs, split_spins, state_features, symmetrize_amp)

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

def _raw(model: NADE, x, x_ph, eps=None, taps=None):
    """The nets' raw outputs from `state_features`' inputs: (the amp trunk's
    (..., S, n_out), the phase net's (..., S, P) with `aggregate_phase`, the
    global net's (..., P) on the last shell's input, or None with a combined
    trunk), LUT shells read from their tables.

    eps/taps: optional K-FAC instrumentation dicts keyed "amp"/"phase" (see
    `MLPStack.forward`); only the dense layers are tapped, not the LUT
    shells."""
    cfg = model.cfg
    eps = eps or {}
    raw = model.amp(x, eps.get("amp"), None if taps is None else taps.setdefault("amp", []))
    if cfg.num_lut:
        raw = _apply_luts(cfg, model.lut, x, raw, cfg.use_amp_spin_sym)
    if cfg.combined_amp_phase:
        return raw, None
    x_ph = x if x_ph is None else x_ph
    ph_taps = None if taps is None else taps.setdefault("phase", [])
    if cfg.aggregate_phase:
        raw_phase = model.phase(x_ph, eps.get("phase"), ph_taps)
        if cfg.num_lut:
            raw_phase = _apply_luts(cfg, model.lut_phase, x_ph, raw_phase,
                                    cfg.use_phase_spin_sym)
        return raw, raw_phase
    # one global net evaluated on the final shell's input
    x_last = x_ph if x_ph.dim() == 2 else x_ph[..., cfg.n_shells - 1, :]
    return raw, model.phase.single(0, x_last, eps.get("phase"), ph_taps)


def shell_tables(model: NADE, states: torch.Tensor):
    """(log_amp, phase) conditional tables for packed states, each (B, S, 4)
    in MODEL shell order. On no training path: the features come from the
    `state_features` kernel and the tables from the plain tail
    (`epilogue_tables_ref`), which `log_psi`'s kernel folds into its sums."""
    x, x_ph, code = state_features(model.cfg, states)
    log_amp, _, phase = epilogue_tables_ref(model.cfg, *_raw(model, x, x_ph), code)
    return log_amp, phase


def _log_psi(model: NADE, states: torch.Tensor, eps=None, taps=None):
    x, x_ph, code = state_features(model.cfg, states)
    return log_psi_epilogue(model.cfg, *_raw(model, x, x_ph, eps, taps), code)


def log_psi(model: NADE, states: torch.Tensor):
    """log|psi| and arg(psi) for packed int64 states, in the model's
    compute dtype (float32 unless the parameters are float64): the features
    (`state_features`), the nets, and the tables' tail with the gather and
    sum over shells (`log_psi_epilogue`, whose vjp and jvp are kernels too)."""
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


def amp_conditional_shell(model: NADE, j: int, a, b):
    """Masked amp table for ONE shell j over a frontier.

    a, b: (U,) int64 packed prefix occupations, bit t the alpha (beta)
    occupation of model shell t (bits at shells >= j are not read). Returns
    (log_amp4, mask4, probs4), each (U, 4); `mask4` is the electron-number
    mask even where partial masking leaves it unapplied. The shell's head and
    tail are the kernels `shell_features` and `shell_epilogue`, the MLP
    between them two dense products; a LUT shell (j < num_lut) reads its
    table row instead of the MLP.
    """
    cfg = model.cfg
    x, meta = shell_features(cfg, a, b, j)
    if j < cfg.num_lut:
        idx = _lut_index(cfg, x, j, cfg.use_amp_spin_sym)
        raw = _lut_rows(model.lut[j], idx).to(cfg.compute_dtype)
    else:
        raw = model.amp.single(j, x)
    return shell_epilogue(cfg, raw, meta, j)
