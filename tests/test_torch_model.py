"""Port NADE against naqs_tpu's on converted parameters.

Tolerances: 1e-5 on log_psi, shell tables and conditionals (f32 products
in another order); gradients of a fixed weighted loss rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu.models import nade as nade_j
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.utils.bits import pack_bits
from test_torch_support import case, to_u64

TOL = 1e-5

VARIANTS = [
    dict(),
    dict(masking="none"),
    dict(masking="full"),
    dict(aggregate_phase=True),
    dict(use_amp_spin_sym=False),
    dict(use_phase_spin_sym=True),
    dict(use_phase_spin_sym=True, aggregate_phase=True, masking="full"),
    dict(shell_order=(0, 2, 4, 6, 1, 3, 5)),
    dict(amp_hidden=(16, 8), phase_hidden=(8,)),
]


def _pair(sectors=((5, 5),), n_qubits=14, seed=0, **kw):
    kw.setdefault("amp_hidden", (16,))
    kw.setdefault("phase_hidden", (12, 12))
    cfg_j = nade_j.NAQSConfig(n_qubits=n_qubits, sectors=sectors, **kw)
    cfg_t = nt.NAQSConfig(n_qubits=n_qubits, sectors=sectors, **kw)
    params = nade_j.init_params(jax.random.key(seed), cfg_j)
    model = nade_t.NADE(cfg_t)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, params, model


def _states(n_qubits, sectors, n=300, seed=0):
    h = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    rng = np.random.default_rng(seed)
    b = h.basis
    return np.sort(rng.choice(b, size=min(n, len(b)), replace=False))


def _check_all(cfg_j, params, model, states):
    la_j, ph_j = nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(states)))
    la_t, ph_t = nade_t.log_psi(model, torch.as_tensor(states))
    np.testing.assert_allclose(la_t.detach().numpy(), np.asarray(la_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(ph_t.detach().numpy(), np.asarray(ph_j), rtol=0, atol=TOL)

    ta_j, tp_j = nade_j.shell_tables(cfg_j, params, jnp.asarray(to_u64(states)))
    ta_t, tp_t = nade_t.shell_tables(model, torch.as_tensor(states))
    np.testing.assert_allclose(ta_t.detach().numpy(), np.asarray(ta_j), rtol=1e-6, atol=TOL)
    np.testing.assert_allclose(tp_t.detach().numpy(), np.asarray(tp_j), rtol=0, atol=TOL)

    # per-shell conditionals on prefixes of the same states
    alpha_t, beta_t = nade_t.split_spins(model.cfg, torch.as_tensor(states))
    s = model.cfg.n_shells
    for j in range(s):
        keep = torch.arange(s) < j
        a, b = alpha_t * keep, beta_t * keep
        la4_j, m_j, p_j = nade_j.amp_conditional_shell(
            cfg_j, params, jnp.int32(j), jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        la4_t, m_t, p_t = nade_t.amp_conditional_shell(model, j, pack_bits(a), pack_bits(b))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=0, atol=TOL)
        live = np.asarray(la4_j) > -1e8
        np.testing.assert_allclose(la4_t.detach().numpy()[live], np.asarray(la4_j)[live],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_model_matches_jax(kw):
    cfg_j, params, model = _pair(**kw)
    _check_all(cfg_j, params, model, _states(14, ((5, 5),)))


def test_multi_sector_model_matches_jax():
    sectors = ((5, 3), (4, 4), (3, 5))
    cfg_j, params, model = _pair(sectors=sectors, masking="full", seed=3)
    _check_all(cfg_j, params, model, _states(14, sectors))


def test_full_width_model_matches_jax():
    """The paper-scale widths (amp 64, phase 512x512) on H2O STO-3G."""
    c = case("H2O")
    cfg_j, params, model = _pair(sectors=c.h_t.sectors, amp_hidden=(64,),
                                 phase_hidden=(512, 512), seed=1)
    _check_all(cfg_j, params, model, c.h_t.basis)


@pytest.mark.parametrize("kw", [dict(), dict(aggregate_phase=True, use_phase_spin_sym=True)])
def test_gradients_match_jax(kw):
    cfg_j, params, model = _pair(seed=2, **kw)
    states = _states(14, ((5, 5),), n=200, seed=4)
    rng = np.random.default_rng(5)
    w_a = rng.normal(size=len(states)).astype(np.float32)
    w_p = rng.normal(size=len(states)).astype(np.float32)

    def loss_j(p):
        la, ph = nade_j.log_psi(cfg_j, p, jnp.asarray(to_u64(states)))
        return jnp.sum(w_a * la + w_p * ph)

    g_j = jax.grad(loss_j)(params)
    la, ph = nade_t.log_psi(model, torch.as_tensor(states))
    torch.sum(torch.as_tensor(w_a) * la + torch.as_tensor(w_p) * ph).backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
