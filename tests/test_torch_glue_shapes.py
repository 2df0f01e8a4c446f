"""The plain versions of the model's two feature kernels against the JAX
package at the shapes the kernels' design has to handle.

`state_features_ref` against naqs_tpu.models.nade's `split_spins`,
`prefix_stats`, `shell_inputs` and `log_psi`'s occupation, and
`shell_features_ref` on every shell against the head of the JAX package's
`amp_conditional_shell` (its MLP input x, captured where the function hands
it to `_mlp_single_apply`, and the prefix counts it hands to
`occupation_mask`) with `prefix_stats`' order flag: at 28 qubits (a 104-byte
line of x), with the integer encoding's odd in_width (13), at 56 qubits (28
shells), with permuted shell orders, the phase net's own inputs and a
float64 model. The states are sector states whose electrons are placed at
shells drawn with numpy from a seed (no basis is enumerated), random states
of n_qubits bits and SENTINEL rows. Exact: every value's bits, signed zeros
included (float32; a float64 model's inputs are the same numbers), and every
integer. The card holds the kernels to these plain versions
(tests/test_torch_cuda.py, chip_smoke.py phase 18).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu.models import nade as nade_j
from naqs_tpu_torch.ops import nade_glue
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import to_u64

SHAPES = [
    dict(n_qubits=28, shell_order=(3, 0, 13, 7, 1, 12, 5, 9, 2, 11, 4, 8, 6, 10)),
    dict(n_qubits=28, input_encoding="integer", use_phase_spin_sym=True),
    dict(n_qubits=28, input_encoding="integer", use_amp_spin_sym=False, param_dtype="float64"),
    dict(n_qubits=56, use_phase_spin_sym=True, aggregate_phase=True),
    dict(n_qubits=56, input_encoding="integer", use_amp_spin_sym=False,
         use_phase_spin_sym=True, shell_order=tuple(np.random.default_rng(5).permutation(28))),
]


def _ids(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items() if k != "shell_order") + (
        ",permuted" if "shell_order" in kw else "")


def _case(kw, seed=0):
    """Both packages' configurations and the states: 40 sector states (6, 5),
    16 random states of n_qubits bits, 3 SENTINEL rows."""
    kw = dict(kw, sectors=((6, 5),), amp_hidden=(8,), phase_hidden=(8,))
    if "shell_order" in kw:
        kw["shell_order"] = tuple(int(o) for o in kw["shell_order"])
    cfg_j, cfg_t = nade_j.NAQSConfig(**kw), nt.NAQSConfig(**kw)
    rng = np.random.default_rng(seed)
    n_q = kw["n_qubits"]
    live = np.zeros(40, np.int64)
    for spin, k in enumerate(kw["sectors"][0]):
        pos = np.argsort(rng.random((40, n_q // 2)), axis=1)[:, :k]
        for i in range(k):
            live |= np.int64(1) << (2 * pos[:, i] + spin)
    states = np.concatenate([live, rng.integers(0, 1 << n_q, size=16), [SENTINEL] * 3])
    return cfg_j, cfg_t, states.astype(np.int64)


def _bits(x):
    """float32 values as their bits (a float64 model's inputs first rounded
    to float32: they are 0, +-1 and small integers, so exactly)."""
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kw", SHAPES, ids=_ids)
def test_state_features_ref_matches_jax(kw):
    cfg_j, cfg, states = _case(kw)
    s = cfg.n_shells
    x, x2, code = nade_glue.state_features(cfg, torch.as_tensor(states))
    alpha, beta = nade_j.split_spins(cfg_j, jnp.asarray(to_u64(states)))
    st = nade_j.prefix_stats(alpha, beta)
    f = {k: v.numpy() for k, v in nade_glue.unpack_code(code).items()}
    for k in ("order3", "ca", "cb"):
        np.testing.assert_array_equal(f[k], np.asarray(st[k]), err_msg=k)
    np.testing.assert_array_equal(f["occ"], np.asarray(alpha + 2 * beta))
    full_pa = np.asarray(st["pa"][:, -1] + alpha[:, -1].astype(jnp.int64) * (1 << (s - 1)))
    full_pb = np.asarray(st["pb"][:, -1] + beta[:, -1].astype(jnp.int64) * (1 << (s - 1)))
    n01 = np.asarray(jnp.sum((alpha == 0) & (beta == 1), axis=-1))
    np.testing.assert_array_equal(f["shift"][:, -1], (full_pa < full_pb) & (n01 % 2 == 1))
    assert not f["shift"][:, :-1].any()
    assert x.dtype == cfg.compute_dtype and x.shape == (len(states), s, cfg.in_width)
    want = nade_j.shell_inputs(cfg_j, alpha, beta, canonical=cfg.use_amp_spin_sym)
    np.testing.assert_array_equal(_bits(x.numpy()), _bits(want))
    second = not cfg.combined_amp_phase and cfg.use_phase_spin_sym != cfg.use_amp_spin_sym
    assert (x2 is not None) == second
    if second:
        want2 = np.asarray(nade_j.shell_inputs(cfg_j, alpha, beta,
                                               canonical=cfg.use_phase_spin_sym))
        np.testing.assert_array_equal(_bits(x2.numpy()),
                                      _bits(want2 if cfg.aggregate_phase else want2[:, -1]))


@pytest.mark.parametrize("kw", SHAPES, ids=_ids)
def test_shell_features_ref_matches_jax_amp_conditional_shell(kw, monkeypatch):
    cfg_j, cfg, states = _case(kw, seed=1)
    s = cfg.n_shells
    alpha, beta = (np.asarray(v) for v in nade_j.split_spins(cfg_j, jnp.asarray(to_u64(states))))
    order3 = np.asarray(nade_j.prefix_stats(jnp.asarray(alpha), jnp.asarray(beta))["order3"])
    seen = {}

    def mlp(params, j, x):   # the MLP's input, and zero logits for the tail
        seen["x"] = np.asarray(x)
        return jnp.zeros((x.shape[0], cfg_j.n_amp_out), x.dtype)

    def mask(cfg_, ca, cb, j):
        seen["ca"], seen["cb"] = np.asarray(ca), np.asarray(cb)
        return occupation_mask(cfg_, ca, cb, j=j)

    occupation_mask = nade_j.occupation_mask
    monkeypatch.setattr(nade_j, "_mlp_single_apply", mlp)
    monkeypatch.setattr(nade_j, "occupation_mask", mask)
    weights = np.int64(1) << np.arange(s, dtype=np.int64)
    for j in range(s):
        keep = (np.arange(s) < j).astype(alpha.dtype)   # the frontier's prefix bits
        nade_j.amp_conditional_shell(cfg_j, {"amp": None}, j, jnp.asarray(alpha * keep),
                                     jnp.asarray(beta * keep))
        a = torch.as_tensor((alpha * keep).astype(np.int64) @ weights)
        b = torch.as_tensor((beta * keep).astype(np.int64) @ weights)
        x, meta = nade_glue.shell_features(cfg, a, b, j)
        assert x.dtype == cfg.compute_dtype and x.shape == (len(states), cfg.in_width)
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(seen["x"]), err_msg=str(j))
        np.testing.assert_array_equal(meta.numpy(), np.stack(
            [order3[:, j], seen["ca"], seen["cb"]]), err_msg=str(j))
