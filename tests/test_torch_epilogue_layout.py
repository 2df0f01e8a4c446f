"""The tables' epilogue on the nets' own layout.

The per-shell products of `MLPStack.forward` (`einsum("...si,sio->...so")`)
leave the nets' raw outputs shell-major: (rows, S, n_out) at strides (n_out,
rows n_out, 1). `tables_epilogue` reads them there, at their strides, with no
copy (`csrc/nade_glue.cu`), and its vjp writes the gradient in the same layout.
On the CPU:

- the nets' raw outputs are shell-major, in the default and the
  `aggregate_phase` configurations;
- `log_psi_epilogue` hands `TablesEpilogue` the nets' own tensors (the same
  storage and strides), recorded by a stand-in for `nade_glue.tables_epilogue`;
- the three plain versions on that shell-major raw against the JAX package's
  `log_psi`, `jax.vjp` and `jax.jvp`, at test_torch_glue_shapes.SHAPES (28 and
  56 qubits, the integer encoding, float64, a per-shell phase net), within
  GLUE_TOL (`nade_glue.glue_error`). The JAX model's last layers are zero and
  the port's raw outputs are added as its last pre-activation perturbations
  (`log_psi_taps`' eps), so both epilogues read the same values;
- `TablesEpilogue`'s backward and jvp on shell-major leaves against autograd
  and forward-mode AD of the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

import naqs_tpu_torch as nt
from naqs_tpu.models import nade as nade_j
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.ops import nade_glue
from test_torch_glue_shapes import SHAPES, _case
from test_torch_glue_shapes import _ids as _shape_ids
from test_torch_nade_glue import _pair, _states
from test_torch_support import to_u64

NETS = [dict(), dict(aggregate_phase=True, use_phase_spin_sym=True)]


def _shell_major(t):
    """Whether t (rows, S, w) lies shell-major, as the per-shell products leave
    it."""
    n, _, w = t.shape
    return t.stride() == (w, n * w, 1)


def _nets(kw, seed=0):
    """A small model, its features on sector and random states, and its raw
    outputs."""
    cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), amp_hidden=(8,), phase_hidden=(8,),
                        **kw)
    model = nade_t.NADE(cfg, torch.Generator().manual_seed(seed))
    x, x2, code = nade_glue.state_features(cfg, torch.as_tensor(_states(((5, 5),), seed)))
    return cfg, model, x, x2, code


@pytest.mark.parametrize("kw", NETS, ids=["default", "aggregate_phase"])
def test_nets_leave_raw_shell_major_and_log_psi_reads_it_in_place(kw, monkeypatch):
    cfg, model, x, x2, code = _nets(kw)
    with torch.no_grad():
        raw, raw_phase = nade_t._raw(model, x, x2)
    assert _shell_major(raw)
    assert raw_phase.dim() == 2 if not cfg.aggregate_phase else _shell_major(raw_phase)

    made, handed = [], []
    raw_of, epilogue = nade_t._raw, nade_glue.tables_epilogue

    def nets(*args, **kwargs):
        out = raw_of(*args, **kwargs)
        made.append(out)
        return out

    def spy(cfg_, r, p, c):
        handed.append((r, p))
        return epilogue(cfg_, r, p, c)

    monkeypatch.setattr(nade_t, "_raw", nets)
    monkeypatch.setattr(nade_glue, "tables_epilogue", spy)
    la, ph = nade_t.log_psi(model, torch.as_tensor(_states(((5, 5),), 0)))
    (la.sum() + ph.sum()).backward()
    assert len(made) == len(handed) == 1
    for mine, theirs in zip(made[0], handed[0]):
        assert theirs.data_ptr() == mine.data_ptr() and theirs.stride() == mine.stride()


def _jax_epilogue(cfg_j, params, states, raw, raw_phase, cot, tangents):
    """The JAX package's log_psi, its vjp and its jvp as functions of the raw
    outputs: the model's last layers zeroed, the raw outputs added as the
    last layers' eps of `log_psi_taps` (0 + raw = raw exactly)."""
    zeroed = jax.tree_util.tree_map(lambda a: a, params)
    for name in ("amp", "phase"):
        if name in zeroed:
            zeroed[name] = list(zeroed[name])
            last = zeroed[name][-1]
            zeroed[name][-1] = {k: jnp.zeros_like(v) for k, v in last.items()}
    st = jnp.asarray(to_u64(states))
    eps0 = nade_j.make_zero_eps(cfg_j, zeroed, len(states))

    def f(e_amp, e_phase):
        eps = {k: list(v) for k, v in eps0.items()}
        eps["amp"][-1] = e_amp
        eps["phase"][-1] = e_phase
        return nade_j.log_psi_taps(cfg_j, zeroed, st, eps)[0]

    primals = (jnp.asarray(raw), jnp.asarray(raw_phase))
    out, vjp_fn = jax.vjp(f, *primals)
    grads = vjp_fn(tuple(jnp.asarray(c, out[0].dtype) for c in cot))
    dots = jax.jvp(f, primals, tuple(jnp.asarray(t) for t in tangents))[1]
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads], \
        [np.asarray(d) for d in dots]


@pytest.mark.parametrize("kw", SHAPES, ids=_shape_ids)
def test_plain_versions_on_shell_major_raw_match_jax(kw):
    kw = dict(kw)
    if "shell_order" in kw:
        kw["shell_order"] = tuple(int(o) for o in kw["shell_order"])
    _, _, states = _case(kw)
    cfg_j, params, model = _pair(((6, 5),), 13, **kw)
    cfg = model.cfg
    x, x2, code = nade_glue.state_features(cfg, torch.as_tensor(states))
    with torch.no_grad():
        raw, raw_phase = nade_t._raw(model, x, x2)
    assert _shell_major(raw) and (raw_phase.dim() == 2 or _shell_major(raw_phase))
    rng = np.random.default_rng(4)
    dtype = raw.dtype
    cot = [torch.as_tensor(rng.normal(size=len(states)), dtype=dtype) for _ in range(2)]
    tangents = [rng.normal(size=tuple(t.shape)) for t in (raw, raw_phase)]
    # the tangents laid out as their primals: shell-major where those are
    tan = [torch.empty_like(p).copy_(torch.as_tensor(t, dtype=dtype))
           for t, p in zip(tangents, (raw, raw_phase))]
    out_j, grads_j, dots_j = _jax_epilogue(
        cfg_j, params, states, raw.numpy(), raw_phase.numpy(), [c.numpy() for c in cot],
        [t.numpy() for t in tan])
    args = (cfg, raw, raw_phase, code)
    checks = {"forward": (nade_glue.tables_epilogue_ref(*args), out_j),
              "vjp": (nade_glue.tables_epilogue_vjp_ref(*args, *cot), grads_j),
              "jvp": (nade_glue.tables_epilogue_jvp_ref(*args, *tan), dots_j)}
    for mode, (got, want) in checks.items():
        want = tuple(torch.as_tensor(np.array(w), dtype=dtype) for w in want)
        err = nade_glue.glue_error(tuple(g.contiguous() for g in got), want)
        assert err <= 1.0, (mode, err)


@pytest.mark.parametrize("kw", NETS + [dict(phase_activation="sigmoid", masking="full")],
                         ids=["default", "aggregate_phase", "sigmoid,full"])
def test_epilogue_function_on_shell_major_leaves_matches_autograd_of_the_plain_forward(kw):
    """Backward and jvp of `log_psi_epilogue` (`TablesEpilogue`: the written-out
    vjp and jvp) on shell-major leaves, with rows whose masks leave no option,
    against autograd and forward-mode AD of `tables_epilogue_ref`."""
    import torch.autograd.forward_ad as fwad

    cfg, model, x, x2, code = _nets(kw, seed=2)
    with torch.no_grad():
        raw, raw_phase = nade_t._raw(model, x, x2)
    leaves = [raw.clone().requires_grad_(True), raw_phase.clone().requires_grad_(True)]
    assert _shell_major(leaves[0])
    gen = torch.Generator().manual_seed(6)
    cot = [torch.randn(raw.shape[0], generator=gen) for _ in range(2)]
    la, ph = nade_glue.log_psi_epilogue(cfg, *leaves, code)
    got = torch.autograd.grad(torch.sum(cot[0] * la + cot[1] * ph), leaves)
    la_r, ph_r = nade_glue.tables_epilogue_ref(cfg, *leaves, code)
    want = torch.autograd.grad(torch.sum(cot[0] * la_r + cot[1] * ph_r), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    tans = [torch.empty_like(t).copy_(torch.randn(t.shape, generator=gen)) for t in leaves]
    assert _shell_major(tans[0])
    with fwad.dual_level():
        duals = [fwad.make_dual(t.detach(), d) for t, d in zip(leaves, tans)]
        want = [fwad.unpack_dual(o).tangent
                for o in nade_glue.tables_epilogue_ref(cfg, *duals, code)]
    got = jvp(lambda r, p: nade_glue.log_psi_epilogue(cfg, r, p, code),
              tuple(t.detach() for t in leaves), tuple(tans))[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
