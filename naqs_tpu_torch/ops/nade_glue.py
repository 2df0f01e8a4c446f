"""The model's fused glue: the state features and the conditional tables'
epilogue, on the card in `csrc/nade_glue.cu`.

The JAX package compiles this work under XLA into the jitted `sample()` scan
and `log_psi` (`naqs_tpu/models/nade.py:209-275, :380-473, :514-575`); it has
no Pallas counterpart. Four hand-written kernels, built by nvcc at first use
(`ops/_build.py`) and bound through ctypes:

  `shell_features(cfg, a, b, j)` -> (x, meta): the sampler's shell head, the
      MLP input (rows, in_width) of shell j from the frontier's packed prefix
      ints and meta (3, rows) int32: the order flag, ca and cb;
  `shell_epilogue(cfg, raw, meta, j)` -> (log_amp4, mask4, probs4): its tail,
      from the amp trunk's raw outputs (rows, n_out) of that shell;
  `state_features(cfg, states)` -> (x, x2, code): `log_psi`'s inputs of every
      shell (rows, S, in_width), the phase net's own where its spin symmetry
      differs from the amp's (x2: every shell's with `aggregate_phase`, else
      the last shell's (rows, in_width); None where it does not differ) and
      one int32 code a (row, shell) (`unpack_code`);
  `tables_epilogue(cfg, raw, raw_phase, code)` -> (log|psi|, arg psi): the
      tables' tail with the gather and sum over shells; `tables_epilogue_vjp`
      and `tables_epilogue_jvp` are its derivatives, the three modes of one
      kernel. `TablesEpilogue` is the autograd Function over them and
      `log_psi_epilogue` its entry.

Every wrapper checks its tensors, and on a CUDA tensor launches its kernel or
raises; on a CPU tensor it runs its plain PyTorch version (`*_ref`), which
the CPU tests hold against the JAX package. Each counts its launches in
`.launches`. No wrapper reads anything back or builds a tensor on the host:
the shell index is a launch argument and the configuration is read by the C
entry from host memory.

The plain helpers of the model's features and tables (`split_spins`,
`prefix_stats`, `shell_inputs`, `symmetrize_amp`, `occupation_mask`,
`scaled_phase_activation`, `masked_log_softmax_half`) live here and are the
plain versions' pieces; `models/nade.py` re-exports them.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from naqs_tpu_torch.ops import _build
from naqs_tpu_torch.ops._build import check_tensors, strided_ok

# masked-logit value; exp(x/2) underflows to 0
BIG_NEG = -1e9

# _SYM_GATHER[order3] maps the 5 raw amp logits onto 4 occupations
# [00, a, b, ab] (occ index = alpha + 2*beta). Logits: [l00, l_sym01, l11,
# d1, d2]; symmetrized output = (base + gathered) / 2.
_SYM_BASE = (0, 1, 1, 2)
_SYM_GATHER = ((0, 3, 4, 2), (0, 1, 1, 2), (0, 4, 3, 2))

MASKINGS = {"none": 0, "partial": 1, "full": 2}
ACTIVATIONS = (None, "softsign", "tanh", "hardtanh", "sin", "sigmoid")
MAX_SECTORS, MAX_SHELLS = 16, 31
# tables_epilogue's phase layouts (csrc/nade_glue.cu::PhaseLayout)
PHASE_IN_AMP, PHASE_PER_SHELL, PHASE_GLOBAL = 0, 1, 2
FORWARD, VJP, JVP = 0, 1, 2

_I64, _I32 = (torch.int64,), (torch.int32,)

# The kernels against their plain versions, per entry within atol + rtol
# |want| by compute dtype: the same operations, but CUDA's expf/logf/tanhf/
# sinf against torch's, fused multiply-adds, and the sums over a row's shells
# and a softmax's options in another order. The features and the masks are
# exact (integer work; the inputs are +-1, 0 and small integers).
GLUE_TOL = {torch.float32: (1e-5, 1e-5), torch.float64: (1e-12, 1e-12)}


def glue_error(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the entries of one
    output or of a tuple of them (GLUE_TOL by want's dtype; integer and bool
    outputs must be equal: 0 or inf); within the tolerance where at most 1.
    None pairs with None."""
    if isinstance(got, (tuple, list)):
        return max([glue_error(g, w) for g, w in zip(got, want)], default=0.0)
    if got is None or want is None:
        return 0.0 if got is None and want is None else math.inf
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else math.inf
    rtol, atol = GLUE_TOL[want.dtype]
    if not got.numel():
        return 0.0
    err = (got.double() - want.double()).abs() / (atol + rtol * want.double().abs())
    return float(torch.nan_to_num(err, nan=math.inf).max())


def same_bits(got, want) -> bool:
    """Whether two outputs, or tuples of them (None pairs with None), hold the
    same bits: float tensors compared as integers of their width, so that
    -0.0 and +0.0 differ (the features' exactness, signed zeros included)."""
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(same_bits(g, w) for g, w in zip(got, want))
    if got is None or want is None:
        return got is None and want is None
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.is_floating_point():
        width = {8: torch.int64, 4: torch.int32, 2: torch.int16}[got.element_size()]
        got, want = got.view(width), want.view(width)
    return torch.equal(got, want)


@lru_cache(maxsize=64)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index tensor of constant values on the device, made once per
    device: an index given as a list or a numpy array is copied to the card
    at every call, a host sync that a window of updates must not take."""
    return torch.tensor(values, dtype=torch.int64, device=device)


# ------------------------------------------------------- the plain pieces

def split_spins(cfg, states: torch.Tensor):
    """Packed states -> (alpha, beta) occupation bits (B, S) in MODEL order."""
    shifts = _index(tuple(range(cfg.n_qubits)), states.device)
    bits = (states[..., None] >> shifts) & 1
    order = _index(tuple(cfg.shell_order), states.device)
    return bits[..., 0::2][..., order], bits[..., 1::2][..., order]


def _excl_cumsum(x):
    return torch.cumsum(x, dim=-1) - x


def prefix_stats(alpha: torch.Tensor, beta: torch.Tensor) -> dict:
    """Per-shell prefix statistics (exclusive over shells < j): counts
    (ca, cb), prefix integers (pa, pb) with shell t weighted 2^t, and the
    exchange order flag (0: pa > pb, 1: equal, 2: pa < pb)."""
    s = alpha.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=alpha.device) << _index(
        tuple(range(s)), alpha.device)
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


def shell_inputs(cfg, alpha, beta, canonical: bool, order3: torch.Tensor | None = None):
    """(B, S, in_width) float32 inputs for every shell. Binary encoding: signed
    +-1 bits, layout [first substring (S-1 slots), second substring]; with
    `canonical` the lexicographically smaller spin substring goes first.
    Integer encoding: one value per previous shell (`_integer_inputs`)."""
    s = cfg.n_shells
    dev = alpha.device
    causal = (_index(tuple(range(s - 1)), dev)[None, :]
              < _index(tuple(range(s)), dev)[:, None])
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


def symmetrize_amp(logits5: torch.Tensor, order3: torch.Tensor) -> torch.Tensor:
    """(..., 5) + order flag -> (..., 4) exchange-symmetric amp logits."""
    base = logits5[..., _index(_SYM_BASE, logits5.device)]
    gidx = _index(_SYM_GATHER, logits5.device)[order3.long()]
    return 0.5 * (base + torch.take_along_dim(logits5, gidx, dim=-1))


def occupation_mask(cfg, ca, cb, j=None):
    """(..., 4) bool mask of occupations allowed by the electron-number
    budgets, OR'd over sectors. ca, cb: prefix up-counts; j: shell index."""
    s = cfg.n_shells
    if j is None:
        j = _index(tuple(range(s)), ca.device).expand(ca.shape)
    da, db = j - ca, j - cb  # prefix down-counts
    mask = torch.zeros((*ca.shape, 4), dtype=torch.bool, device=ca.device)
    for (na, nb) in cfg.sectors:
        ok = (ca <= na) & (da <= s - na) & (cb <= nb) & (db <= s - nb)
        a1, a0 = ca < na, da < s - na
        b1, b0 = cb < nb, db < s - nb
        m = torch.stack([a0 & b0, a1 & b0, a0 & b1, a1 & b1], dim=-1)
        mask = mask | (m & ok[..., None])
    return mask


def _check_activation(name):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown phase activation '{name}'")


def _activate(name: str, x: torch.Tensor) -> torch.Tensor:
    _check_activation(name)
    if name == "softsign":
        return math.pi * x / (1.0 + torch.abs(x))
    if name == "tanh":
        return math.pi * torch.tanh(x)
    if name == "hardtanh":
        return math.pi * torch.clamp(x, -1.0, 1.0)
    if name == "sin":
        return math.pi * torch.sin(x) ** 2
    return math.pi * torch.sigmoid(x)


def _activate_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """d _activate(name, x) / dx, written out (torch.clamp's convention at
    the bounds: the gradient passes where -1 <= x <= 1)."""
    if name == "softsign":
        d = 1.0 + torch.abs(x)
        return math.pi / (d * d)
    if name == "tanh":
        t = torch.tanh(x)
        return math.pi * (1.0 - t * t)
    if name == "hardtanh":
        return torch.where((x >= -1.0) & (x <= 1.0), math.pi, 0.0).to(x.dtype)
    if name == "sin":
        return math.pi * (2.0 * torch.sin(x) * torch.cos(x))
    s = torch.sigmoid(x)
    return math.pi * (s * (1.0 - s))


def _pinned(y_shape, mask):
    """Where a scaled phase activation pins its output to 0: the mask leaves
    one option and this is it; None where nothing is pinned."""
    if mask is None or y_shape[-1] != mask.shape[-1]:
        return None
    return (mask.sum(dim=-1, keepdim=True) == 1) & mask


def scaled_phase_activation(name: str, x: torch.Tensor, mask=None) -> torch.Tensor:
    """Scaled phase activations: map raw outputs into [-pi, pi]-ish ranges;
    where the amplitude mask leaves only one option (a deterministic output),
    the phase is pinned to 0."""
    y = _activate(name, x)
    pinned = _pinned(y.shape, mask)
    return y if pinned is None else torch.where(pinned, 0.0, y)


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


# ----------------------------------------------------------- the library

class _Config(ctypes.Structure):
    """csrc/nade_glue.cu::GlueConfig, field by field."""

    _fields_ = [("n_shells", ctypes.c_int32), ("in_width", ctypes.c_int32),
                ("integer_inputs", ctypes.c_int32), ("amp_sym", ctypes.c_int32),
                ("phase_sym", ctypes.c_int32), ("masking", ctypes.c_int32),
                ("activation", ctypes.c_int32), ("n_amp_out", ctypes.c_int32),
                ("n_out", ctypes.c_int32), ("n_sectors", ctypes.c_int32),
                ("sectors", ctypes.c_int32 * (2 * MAX_SECTORS)),
                ("shell_order", ctypes.c_int32 * (MAX_SHELLS + 1))]


@lru_cache(maxsize=64)
def _config(cfg) -> _Config:
    """The kernels' view of a NAQSConfig, made once per configuration (the
    cache keeps it alive: the C entries read it by address)."""
    _check_activation(cfg.phase_activation)
    if not 2 <= cfg.n_shells <= MAX_SHELLS or len(cfg.sectors) > MAX_SECTORS:
        raise ValueError(f"nade_glue: {cfg.n_shells} shells and {len(cfg.sectors)} sectors; "
                         f"the kernels take 2..{MAX_SHELLS} shells and at most "
                         f"{MAX_SECTORS} sectors")
    n_amp, _, n_out = _n_out(cfg)
    c = _Config(n_shells=cfg.n_shells, in_width=cfg.in_width,
                integer_inputs=int(cfg.input_encoding == "integer"),
                amp_sym=int(cfg.use_amp_spin_sym), phase_sym=int(cfg.use_phase_spin_sym),
                masking=MASKINGS[cfg.masking], activation=ACTIVATIONS.index(cfg.phase_activation),
                n_amp_out=n_amp, n_out=n_out,
                n_sectors=len(cfg.sectors))
    for i, (na, nb) in enumerate(cfg.sectors):
        c.sectors[2 * i], c.sectors[2 * i + 1] = na, nb
    for j, o in enumerate(cfg.shell_order):
        c.shell_order[j] = o
    return c


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("nade_glue")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shell_features.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, i32, ptr]
    lib.shell_epilogue.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, ptr]
    lib.state_features.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr, i32, ptr]
    lib.tables_epilogue.argtypes = [ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                    ptr, ptr, i32, i32, i32, ptr]
    lib.state_features_smem.argtypes = [ptr]
    for fn in (lib.shell_features, lib.shell_epilogue, lib.state_features,
               lib.tables_epilogue, lib.state_features_smem):
        fn.restype = i32
    return lib


def _launch(name, cfg, args, device):
    """Launch kernel `name` with the configuration's address first; tensors
    among `args` pass as pointers (None as a null pointer). Under torch.func's
    transforms (SR's vjp and jvp over `functional_call`) a tensor made inside
    the transform is wrapped at its level: the pointer is its storage's."""
    _build.launch(_lib(), name, [ctypes.addressof(_config(cfg)),
                                 *(_plain(a) if torch.is_tensor(a) else a for a in args)],
                  device)


def _n_out(cfg) -> tuple:
    """(n_amp_out, n_phase_out, n_out): the amp logits, the phase outputs, and
    the amp trunk's outputs (the phase's too with a combined trunk)."""
    n_amp = 5 if cfg.use_amp_spin_sym else 4
    n_phase = 3 if cfg.use_phase_spin_sym else 4
    return n_amp, n_phase, n_amp + (n_phase if cfg.combined_amp_phase else 0)


def _f64(cfg) -> int:
    return int(cfg.compute_dtype == torch.float64)


def _second_input(cfg) -> int:
    """state_features' second input: 0 none (the phase net reads the amp's
    inputs, or there is no phase net), 1 the global phase net's (the last
    shell's), 2 every shell's (aggregate_phase)."""
    if cfg.combined_amp_phase or cfg.use_phase_spin_sym == cfg.use_amp_spin_sym:
        return 0
    return 2 if cfg.aggregate_phase else 1


def _plain(t):
    """The tensor that holds t's data. torch.func's vjp and jvp hand a
    Function's backward and jvp, and a factory call inside them, tensors
    wrapped at their level, which have no data pointer of their own; the
    kernels and the plain versions work on what they wrap and return plain
    tensors. A batched tensor (vmap, as jacrev maps the vjp) is kept: the
    plain versions take it, a kernel refuses it."""
    fn = torch._C._functorch
    while (t is not None and fn.is_functorch_wrapped_tensor(t)
           and not fn.is_batchedtensor(t)):
        t = fn.get_unwrapped(t)
    return t


def _for_kernel(anchor, *ts):
    """On the card, the tensors as the kernels take them (`_plain`: their
    storage, not torch.func's wrappers, whose data pointer cannot be read);
    on the CPU as they are, for the plain versions."""
    return tuple(_plain(t) for t in ts) if anchor.device.type == "cuda" else ts


# ------------------------------------------------------------ K1, K2

def shell_features_ref(cfg, a, b, j: int):
    """Plain version of `shell_features`: the head of the JAX package's
    `amp_conditional_shell` on the prefix bits of a, b."""
    s = cfg.n_shells
    shells = _index(tuple(range(s)), a.device)
    alpha, beta = (a[:, None] >> shells) & 1, (b[:, None] >> shells) & 1
    before = shells < j
    w = (torch.ones((), dtype=torch.int64, device=a.device) << shells) * before
    pa = torch.sum(alpha * w, dim=-1)
    pb = torch.sum(beta * w, dim=-1)
    order3 = torch.where(pa > pb, 0, torch.where(pa == pb, 1, 2))
    if cfg.input_encoding == "integer":
        x = _integer_inputs(alpha, beta, cfg.use_amp_spin_sym)[..., : s - 1] * before[: s - 1]
    else:
        a_in = _signed(alpha)[..., : s - 1] * before[: s - 1]
        b_in = _signed(beta)[..., : s - 1] * before[: s - 1]
        if cfg.use_amp_spin_sym:
            swap = (order3 == 0)[..., None]
            a_in, b_in = torch.where(swap, b_in, a_in), torch.where(swap, a_in, b_in)
        x = torch.cat([a_in, b_in], dim=-1)
    meta = torch.stack([order3, torch.sum(alpha * before, dim=-1),
                        torch.sum(beta * before, dim=-1)]).to(torch.int32)
    return x.to(cfg.compute_dtype), meta


def _check_j(name, cfg, j):
    if not 0 <= j < cfg.n_shells:
        raise ValueError(f"{name}: shell {j} outside 0..{cfg.n_shells - 1}")


def shell_features(cfg, a, b, j: int):
    """The MLP input of shell j over a frontier, with its order flags and
    prefix counts: a, b (rows,) int64, bit t the alpha (beta) occupation of
    model shell t (bits at t >= j are ignored). Returns (x (rows, in_width)
    in the compute dtype, meta (3, rows) int32: order3, ca, cb)."""
    n = a.shape[0] if a.dim() == 1 else -1
    a, b = _for_kernel(a, a, b)
    check_tensors("shell_features", a, {"a": (a, _I64, (n,)), "b": (b, _I64, (n,))}, align=8)
    _check_j("shell_features", cfg, j)
    if a.device.type == "cpu":
        return shell_features_ref(cfg, a, b, j)
    x = torch.empty((n, cfg.in_width), dtype=cfg.compute_dtype, device=a.device)
    meta = torch.empty((3, n), dtype=torch.int32, device=a.device)
    if n:
        _launch("shell_features", cfg, (a, b, j, n, x, meta, _f64(cfg)), a.device)
        shell_features.launches += 1
    return x, meta


shell_features.launches = 0


def shell_epilogue_ref(cfg, raw, meta, j: int):
    """Plain version of `shell_epilogue`: the tail of the JAX package's
    `amp_conditional_shell`."""
    raw = raw[:, :_n_out(cfg)[0]]
    order3, ca, cb = meta.long()
    logits4 = symmetrize_amp(raw, order3) if cfg.use_amp_spin_sym else raw
    mask = occupation_mask(cfg, ca, cb, j=torch.full_like(ca, j))
    if cfg.masking == "none" or (cfg.masking == "partial" and j == cfg.n_shells - 1):
        log_amp = masked_log_softmax_half(logits4, None)
    else:
        log_amp = masked_log_softmax_half(logits4, mask)
    return log_amp, mask, torch.exp(2.0 * log_amp)


def shell_epilogue(cfg, raw, meta, j: int):
    """Shell j's masked conditional from the amp trunk's raw outputs raw (rows,
    n_out) in the compute dtype (the amp logits first; a combined trunk's
    phase outputs after them are not read) and `shell_features`' meta.
    Returns (log_amp4, mask4, probs4), each (rows, 4): log_amp4 and probs4 =
    exp(2 log_amp4) in the compute dtype, mask4 the electron-number mask even
    where partial masking leaves it unapplied."""
    n = meta.shape[-1]
    raw, meta = _for_kernel(raw, raw, meta)
    check_tensors("shell_epilogue", raw, {
        "raw": (raw, (cfg.compute_dtype,), (n, _n_out(cfg)[2])), "meta": (meta, _I32, (3, n))},
        align=16)
    _check_j("shell_epilogue", cfg, j)
    if raw.device.type == "cpu":
        return shell_epilogue_ref(cfg, raw, meta, j)
    log_amp = torch.empty((n, 4), dtype=raw.dtype, device=raw.device)
    probs = torch.empty_like(log_amp)
    mask = torch.empty((n, 4), dtype=torch.bool, device=raw.device)
    if n:
        _launch("shell_epilogue", cfg, (raw, meta, j, n, log_amp, mask, probs, _f64(cfg)),
                raw.device)
        shell_epilogue.launches += 1
    return log_amp, mask, probs


shell_epilogue.launches = 0


# ------------------------------------------------------------ K3

def pack_code(order3, occ, shift, ca, cb) -> torch.Tensor:
    """state_features' int32 code of (row, shell): order flag (bits 0-1),
    occupation alpha + 2 beta (2-3), the row's phase-symmetry shift (4; set
    at the last shell only), ca (8-15), cb (16-23)."""
    return (order3 | occ << 2 | shift << 4 | ca << 8 | cb << 16).to(torch.int32)


def unpack_code(code: torch.Tensor) -> dict:
    """The fields of `pack_code`, as int64 tensors of code's shape."""
    c = code.long()
    return {"order3": c & 3, "occ": (c >> 2) & 3, "shift": (c >> 4) & 1,
            "ca": (c >> 8) & 0xFF, "cb": (c >> 16) & 0xFF}


def state_features_ref(cfg, states):
    """Plain version of `state_features`: `split_spins`, `prefix_stats`,
    `shell_inputs` and the occupation, as the JAX package's `log_psi`."""
    s = cfg.n_shells
    alpha, beta = split_spins(cfg, states)
    st = prefix_stats(alpha, beta)
    x = shell_inputs(cfg, alpha, beta, cfg.use_amp_spin_sym, st["order3"])
    second = _second_input(cfg)
    x2 = None
    if second:
        x2 = shell_inputs(cfg, alpha, beta, cfg.use_phase_spin_sym, st["order3"])
        x2 = (x2 if second == 2 else x2[..., s - 1, :]).to(cfg.compute_dtype)
    # the exchange phase shift pi*(N01 mod 2) where the full pa < pb
    full_pa = st["pa"][..., s - 1] + alpha[..., s - 1] * (1 << (s - 1))
    full_pb = st["pb"][..., s - 1] + beta[..., s - 1] * (1 << (s - 1))
    n01 = torch.sum((alpha == 0) & (beta == 1), dim=-1)
    shift = ((full_pa < full_pb) & (n01 % 2 == 1)).long()
    shift = torch.cat([torch.zeros_like(alpha[..., 1:]), shift[..., None]], dim=-1)
    code = pack_code(st["order3"], alpha + 2 * beta, shift, st["ca"], st["cb"])
    return x.to(cfg.compute_dtype), x2, code


def state_features(cfg, states):
    """`log_psi`'s state-only features for packed int64 states (rows,):
    (x (rows, S, in_width) in the compute dtype, the amp nets' inputs; x2,
    the phase net's where its spin symmetry differs from the amp's: every
    shell's (rows, S, in_width) with `aggregate_phase`, else the last
    shell's (rows, in_width), None where it does not differ; code (rows, S)
    int32, `pack_code`). No gradient flows to the states."""
    n = states.shape[0] if states.dim() == 1 else -1
    (states,) = _for_kernel(states, states)
    check_tensors("state_features", states, {"states": (states, _I64, (n,))}, align=8)
    if states.device.type == "cpu":
        return state_features_ref(cfg, states)
    s, w, dev = cfg.n_shells, cfg.in_width, states.device
    x = torch.empty((n, s, w), dtype=cfg.compute_dtype, device=dev)
    second = _second_input(cfg)
    x2 = (None if not second else
          torch.empty((n, s, w) if second == 2 else (n, w), dtype=x.dtype, device=dev))
    code = torch.empty((n, s), dtype=torch.int32, device=dev)
    if n:
        _launch("state_features", cfg, (states, n, x, x2, second, code, _f64(cfg)), dev)
        state_features.launches += 1
    return x, x2, code


state_features.launches = 0


def state_features_smem(cfg) -> int:
    """The bytes of dynamic shared memory a block of `state_features`' kernel
    launches with for this configuration, as its C entry sizes it (the other
    glue kernels launch with none)."""
    return _lib().state_features_smem(ctypes.addressof(_config(cfg)))


# ------------------------------------------------------------ K4

def _phase_layout(cfg, raw_phase) -> int:
    if raw_phase is None:
        return PHASE_IN_AMP
    return PHASE_PER_SHELL if raw_phase.dim() == 3 else PHASE_GLOBAL


def _raw_parts(cfg, raw, raw_phase):
    """(raw amp (B, S, n_amp_out), raw phase (B, S, P)): a combined trunk's
    columns, or the global net's outputs at the last shell and zeros before."""
    n_amp = _n_out(cfg)[0]
    if raw_phase is None:
        return raw[..., :n_amp], raw[..., n_amp:]
    if raw_phase.dim() == 2:
        raw_phase = _last_shell_only(raw_phase, cfg.n_shells)
    return raw[..., :n_amp], raw_phase


def _applied_mask(cfg, f):
    """The mask the tables apply (B, S, 4): None without masking; partial
    masking's last shell unmasked."""
    if cfg.masking == "none":
        return None
    mask = occupation_mask(cfg, f["ca"], f["cb"])
    if cfg.masking == "partial":
        mask[..., cfg.n_shells - 1, :] = True
    return mask


def epilogue_tables_ref(cfg, raw, raw_phase, code):
    """The per-shell conditional tables (log_amp4, mask4, phase4), each (B, S,
    4) in MODEL shell order, from the raw outputs and `state_features`'
    codes: the tail of the JAX package's `_tables`. raw: the amp trunk's
    outputs (B, S, n_out); raw_phase: the phase net's, (B, S, P) or the global
    net's (B, P), or None with a combined trunk."""
    s = cfg.n_shells
    f = unpack_code(code)
    raw_amp, raw_phase = _raw_parts(cfg, raw, raw_phase)
    logits4 = symmetrize_amp(raw_amp, f["order3"]) if cfg.use_amp_spin_sym else raw_amp
    mask = _applied_mask(cfg, f)
    log_amp = masked_log_softmax_half(logits4, mask)
    if cfg.phase_activation is not None:
        # over every shell, the global net's zero rows too: sigmoid puts
        # pi/2 on those of them whose mask leaves a choice, as in JAX
        raw_phase = scaled_phase_activation(cfg.phase_activation, raw_phase, mask)
    if cfg.use_phase_spin_sym:
        phase4 = raw_phase[..., _index(_SYM_BASE, raw_phase.device)]
        # exchange phase shift pi*(N01 mod 2) on the canonical-swapped
        # partner, applied at the last shell, in the compute dtype
        shift = f["shift"].to(phase4.dtype) * math.pi
        phase4 = phase4 + shift[..., None]
    else:
        phase4 = raw_phase
    return log_amp, mask, phase4


def _gather_sum(table4, occ):
    return torch.take_along_dim(table4, occ[..., None], dim=-1)[..., 0].sum(dim=-1)


def tables_epilogue_ref(cfg, raw, raw_phase, code):
    """Plain version of `tables_epilogue`: `epilogue_tables_ref`, then the
    realized occupation's entry of each shell summed over shells."""
    log_amp4, _, phase4 = epilogue_tables_ref(cfg, raw, raw_phase, code)
    occ = unpack_code(code)["occ"]
    return _gather_sum(log_amp4, occ), _gather_sum(phase4, occ)


def _softmax_parts(cfg, raw, raw_phase, code):
    """What the vjp and the jvp share: the code's fields, the raw parts, the
    applied mask (all True without masking), the row's any-allowed flag and
    the probabilities exp(log_softmax(z))."""
    f = unpack_code(code)
    raw_amp, x_phase = _raw_parts(cfg, raw, raw_phase)
    logits4 = symmetrize_amp(raw_amp, f["order3"]) if cfg.use_amp_spin_sym else raw_amp
    mask = _applied_mask(cfg, f)
    if mask is None:
        mask = torch.ones(logits4.shape, dtype=torch.bool, device=logits4.device)
    z = torch.where(mask, 2.0 * logits4, BIG_NEG)
    p = torch.exp(torch.log_softmax(z, dim=-1))
    return f, x_phase, mask, mask.any(dim=-1, keepdim=True), p


def _phase_pins(cfg, mask, x_phase):
    """Where the activation pins the phase to 0 (B, S, P), or None."""
    if cfg.phase_activation is None or cfg.masking == "none":
        return None
    return _pinned(x_phase.shape, mask)


def tables_epilogue_vjp_ref(cfg, raw, raw_phase, code, cot_la, cot_ph):
    """Plain version of `tables_epilogue_vjp`, written out: the gradients of
    sum(cot_la log|psi| + cot_ph arg psi) with respect to raw and raw_phase."""
    s = cfg.n_shells
    f, x_phase, mask, any_, p = _softmax_parts(cfg, raw, raw_phase, code)
    onehot = F.one_hot(f["occ"], 4).to(raw.dtype)
    h = 0.5 * cot_la.to(raw.dtype)[:, None, None]
    dl = torch.where(mask & any_, 2.0 * (h * onehot - p * h), 0.0)
    if cfg.use_amp_spin_sym:
        half = 0.5 * dl
        base = _index(_SYM_BASE, raw.device).expand(dl.shape)
        gidx = _index(_SYM_GATHER, raw.device)[f["order3"]]
        d_amp = torch.zeros((*dl.shape[:-1], 5), dtype=raw.dtype, device=raw.device)
        d_amp = d_amp.scatter_add(-1, base, half).scatter_add(-1, gidx, half)
    else:
        d_amp = dl
    g = cot_ph.to(raw.dtype)[:, None, None] * onehot
    if cfg.use_phase_spin_sym:
        base = _index(_SYM_BASE, raw.device).expand(g.shape)
        dy = torch.zeros(x_phase.shape, dtype=raw.dtype, device=raw.device).scatter_add(
            -1, base, g)
    else:
        dy = g
    if cfg.phase_activation is not None:
        pins = _phase_pins(cfg, mask, x_phase)
        if pins is not None:
            dy = torch.where(pins, 0.0, dy)
        dy = dy * _activate_grad(cfg.phase_activation, x_phase)
    if raw_phase is None:
        return torch.cat([d_amp, dy], dim=-1), None
    return d_amp, dy[:, s - 1] if raw_phase.dim() == 2 else dy


def tables_epilogue_jvp_ref(cfg, raw, raw_phase, code, tan_raw, tan_phase):
    """Plain version of `tables_epilogue_jvp`, written out: the tangents of
    (log|psi|, arg psi) along tangents of raw and raw_phase (None: zero)."""
    f, x_phase, mask, any_, p = _softmax_parts(cfg, raw, raw_phase, code)
    occ = f["occ"][..., None]
    if tan_raw is None:
        tan_raw = torch.zeros_like(raw)
    if raw_phase is not None and tan_phase is None:
        tan_phase = torch.zeros_like(raw_phase)
    t_amp, t_phase = _raw_parts(cfg, tan_raw, tan_phase)
    tl = symmetrize_amp(t_amp, f["order3"]) if cfg.use_amp_spin_sym else t_amp
    dz = torch.where(mask, 2.0 * tl, 0.0)
    dlsm = torch.take_along_dim(dz, occ, dim=-1)[..., 0] - torch.sum(p * dz, dim=-1)
    la_dot = torch.where(any_[..., 0], 0.5 * dlsm, 0.0).sum(dim=-1)
    dy = t_phase
    if cfg.phase_activation is not None:
        dy = _activate_grad(cfg.phase_activation, x_phase) * dy
        pins = _phase_pins(cfg, mask, x_phase)
        if pins is not None:
            dy = torch.where(pins, 0.0, dy)
    if cfg.use_phase_spin_sym:
        dy = dy[..., _index(_SYM_BASE, raw.device)]
    return la_dot, torch.take_along_dim(dy, occ, dim=-1)[..., 0].sum(dim=-1)


# the operands tables_epilogue reads (and the vjp's outputs, made like two of
# them) at their strides, with no copy: the nets' shell-major outputs
_STRIDED = ("raw", "raw_phase", "tan_raw", "tan_phase")


def _check_tables(name, cfg, raw, raw_phase, code, extra=None):
    n = code.shape[0] if code.dim() == 2 else -1
    s, (_, p, n_out) = cfg.n_shells, _n_out(cfg)
    t = (cfg.compute_dtype,)
    want = {"raw": (raw, t, (n, s, n_out)), "code": (code, _I32, (n, s))}
    if cfg.combined_amp_phase != (raw_phase is None):
        raise ValueError(f"{name}: raw_phase must be None exactly with a combined trunk")
    if raw_phase is not None:
        want["raw_phase"] = (raw_phase, t, (n, s, p) if cfg.aggregate_phase else (n, p))
    want.update(extra or {})
    esz = raw.element_size() if torch.is_tensor(raw) else 1
    check_tensors(name, raw, want, align={k: 16 if k == "code" else esz for k in want},
                  strided=_STRIDED)
    return n


@lru_cache(maxsize=64)
def _mask_table(cfg, device) -> torch.Tensor:
    """The mask tables_epilogue applies at shell j after ca, cb up-spins,
    (S, S, S) uint8 at [j, ca, cb], bit k occupation k: `occupation_mask`,
    every option where masking is "none" and at partial masking's last
    shell. Made once per configuration and device; the kernel reads it in
    place of the loop over the sectors. The plain versions do not read it."""
    s = cfg.n_shells
    j, ca, cb = torch.meshgrid(*(torch.arange(s),) * 3, indexing="ij")
    mask = occupation_mask(cfg, ca, cb, j)
    if cfg.masking == "none":
        mask[:] = True
    elif cfg.masking == "partial":
        mask[s - 1] = True
    bits = (mask.long() << torch.arange(4)).sum(dim=-1)
    # made inside torch.func's transforms (a jvp's first call, say) the
    # tensors are wrapped at its level: cache what they wrap
    return _plain(bits.to(torch.uint8).to(device))


def _pair(t):
    """(row, shell) strides in elements of a (rows, S, w) operand, (row, 0)
    of a (rows, w) one (read at the last shell), (0, 0) for None."""
    if t is None:
        return 0, 0
    return (t.stride(0), t.stride(1)) if t.dim() == 3 else (t.stride(0), 0)


# tables_epilogue on at least this many rows takes one thread a row (its row
# tiles, where raw is shell-major), on fewer one thread a (row, shell): below
# it one thread a row leaves too much of the card idle. On the H100 the two
# cross between 70,000 and 100,000 rows at H2O 6-31G's width
# (tools/epilogue_timing.py, PERF.md). Both give the same bits.
ROW_TILES_MIN = 80_000


def _strides(*ts):
    """The C entry's 12 strides: raw, phase, tan_raw, tan_phase, out0, out1."""
    return (ctypes.c_int64 * 12)(*(x for t in ts for x in _pair(t)))


def tables_epilogue(cfg, raw, raw_phase, code):
    """log|psi| and arg psi (rows,) in the compute dtype from the raw outputs
    and `state_features`' codes: raw the amp trunk's outputs (rows, S, n_out);
    raw_phase the phase net's (rows, S, P) with `aggregate_phase`, the global
    net's (rows, P) (read at the last shell, zeros before), or None with a
    combined trunk (its columns from n_amp_out on). On the card raw and
    raw_phase are read at their strides: contiguous, shell-major as the nets
    give them, or any view with a unit last stride and no overlap
    (`_build.strided_ok`); code contiguous and 16-byte aligned. No gradient:
    see `log_psi_epilogue`."""
    raw, raw_phase, code = _for_kernel(raw, raw, raw_phase, code)
    n = _check_tables("tables_epilogue", cfg, raw, raw_phase, code)
    if raw.device.type == "cpu":
        return tables_epilogue_ref(cfg, raw, raw_phase, code)
    la = torch.empty((n,), dtype=raw.dtype, device=raw.device)
    ph = torch.empty_like(la)
    if n:
        _launch("tables_epilogue", cfg, (FORWARD, raw, raw_phase, _phase_layout(cfg, raw_phase),
                                         code, _mask_table(cfg, raw.device), None, None, None,
                                         None, la, ph,
                                         _strides(raw, raw_phase, None, None, None, None), n,
                                         int(n >= ROW_TILES_MIN), _f64(cfg)), raw.device)
        tables_epilogue.launches += 1
    return la, ph


tables_epilogue.launches = 0


def tables_epilogue_vjp(cfg, raw, raw_phase, code, cot_la, cot_ph):
    """The gradients (of raw, of raw_phase or None) of sum(cot_la log|psi| +
    cot_ph arg psi), for cotangents (rows,) in the compute dtype; each laid
    out as `torch.empty_like` lays out its input (the nets' shell-major raw
    gets a shell-major gradient). A row with no allowed option has a zero
    gradient."""
    n = code.shape[0]
    t = (cfg.compute_dtype,)
    raw, raw_phase, code, cot_la, cot_ph = _for_kernel(raw, raw, raw_phase, code, cot_la, cot_ph)
    _check_tables("tables_epilogue_vjp", cfg, raw, raw_phase, code,
                  {"cot_la": (cot_la, t, (n,)), "cot_ph": (cot_ph, t, (n,))})
    if raw.device.type == "cpu":
        return tables_epilogue_vjp_ref(cfg, raw, raw_phase, code, cot_la, cot_ph)
    d_raw = torch.empty_like(raw)
    d_phase = None if raw_phase is None else torch.empty_like(raw_phase)
    if n:
        _launch("tables_epilogue", cfg, (VJP, raw, raw_phase, _phase_layout(cfg, raw_phase),
                                         code, _mask_table(cfg, raw.device), cot_la, cot_ph, None,
                                         None, d_phase, d_raw,
                                         _strides(raw, raw_phase, None, None, d_phase, d_raw), n,
                                         int(n >= ROW_TILES_MIN), _f64(cfg)), raw.device)
        tables_epilogue_vjp.launches += 1
    return d_raw, d_phase


tables_epilogue_vjp.launches = 0


def tables_epilogue_jvp(cfg, raw, raw_phase, code, tan_raw, tan_phase):
    """The tangents (rows,) of log|psi| and arg psi along tangents of raw and
    raw_phase (each of its primal's shape, in any layout the forward takes)
    or None (zero)."""
    n = code.shape[0]
    raw, raw_phase, code, tan_raw, tan_phase = _for_kernel(raw, raw, raw_phase, code, tan_raw,
                                                           tan_phase)
    extra = {}
    if tan_raw is not None:
        extra["tan_raw"] = (tan_raw, (cfg.compute_dtype,), tuple(raw.shape))
    if tan_phase is not None:
        if raw_phase is None:
            raise ValueError("tables_epilogue_jvp: a phase tangent without a phase net")
        extra["tan_phase"] = (tan_phase, (cfg.compute_dtype,), tuple(raw_phase.shape))
    _check_tables("tables_epilogue_jvp", cfg, raw, raw_phase, code, extra)
    if raw.device.type == "cpu":
        return tables_epilogue_jvp_ref(cfg, raw, raw_phase, code, tan_raw, tan_phase)
    la_dot = torch.empty((n,), dtype=raw.dtype, device=raw.device)
    ph_dot = torch.empty_like(la_dot)
    if n:
        _launch("tables_epilogue", cfg, (JVP, raw, raw_phase, _phase_layout(cfg, raw_phase),
                                         code, _mask_table(cfg, raw.device), None, None, tan_raw,
                                         tan_phase, la_dot, ph_dot,
                                         _strides(raw, raw_phase, tan_raw, tan_phase, None, None),
                                         n, int(n >= ROW_TILES_MIN), _f64(cfg)), raw.device)
        tables_epilogue_jvp.launches += 1
    return la_dot, ph_dot


tables_epilogue_jvp.launches = 0


def _readable(t):
    """t itself where the kernels read it at its strides (`strided_ok`: the
    nets' outputs, shell-major or not, and their tangents), else a contiguous
    copy (an expanded tangent or cotangent, say)."""
    return t if t is None or strided_ok(t) else t.contiguous()


def _dense(t, dtype):
    """A cotangent or tangent as the kernels take it: plain, in the compute
    dtype, in its own layout where the kernels read that (`_readable`)."""
    t = _plain(t)
    return None if t is None else _readable(t.to(dtype))


class TablesEpilogue(torch.autograd.Function):
    """(log|psi|, arg psi) from the raw outputs, with its derivatives as
    kernels: `backward` is `tables_epilogue_vjp`, `jvp` is
    `tables_epilogue_jvp` (torch.func's jvp and vjp, which SR takes over
    `functional_call`, reach them). Each dispatches by device as its wrapper
    does. No port path takes a second derivative: once differentiable."""

    @staticmethod
    def forward(raw, raw_phase, code, cfg):
        return tables_epilogue(cfg, raw, raw_phase, code)

    @staticmethod
    def setup_context(ctx, inputs, output):
        raw, raw_phase, code, cfg = inputs
        ctx.cfg = cfg
        ctx.has_phase = raw_phase is not None
        kept = (raw, code) + ((raw_phase,) if raw_phase is not None else ())
        ctx.save_for_backward(*kept)
        ctx.save_for_forward(*kept)

    @staticmethod
    def _saved(ctx):
        saved = [_plain(t) for t in ctx.saved_tensors]
        return saved[0], (saved[2] if ctx.has_phase else None), saved[1]

    @staticmethod
    @once_differentiable
    def backward(ctx, cot_la, cot_ph):
        raw, raw_phase, code = TablesEpilogue._saved(ctx)
        d_raw, d_phase = tables_epilogue_vjp(ctx.cfg, raw, raw_phase, code,
                                             _dense(cot_la, raw.dtype), _dense(cot_ph, raw.dtype))
        return d_raw, d_phase, None, None

    @staticmethod
    def jvp(ctx, tan_raw, tan_phase, _code, _cfg):
        raw, raw_phase, code = TablesEpilogue._saved(ctx)
        return tables_epilogue_jvp(ctx.cfg, raw, raw_phase, code, _dense(tan_raw, raw.dtype),
                                   _dense(tan_phase, raw.dtype) if ctx.has_phase else None)


def log_psi_epilogue(cfg, raw, raw_phase, code):
    """`tables_epilogue` under autograd (`TablesEpilogue`) on the nets' raw
    outputs as they lie: shell-major from the per-shell products, row-major
    from the LUT shells; no copy of either (`_readable`)."""
    return TablesEpilogue.apply(_readable(raw), _readable(raw_phase), code, cfg)
