"""The NADE variants of the port against naqs_tpu's on converted parameters:
lookup-table conditionals (`num_lut`, with and without per-shell phase
tables), the combined amp-phase trunk, the integer input encoding, the
scaled phase activations and float64 / bfloat16 parameters.

Tolerances: 1e-5 on log_psi, shell tables and conditionals, as
test_torch_model.py (f32 products in another order); gradients of a fixed
weighted loss rtol 1e-4 / atol 1e-6. bfloat16 parameters: both packages
multiply float32 inputs by the same bfloat16 weights in float32, so the
outputs keep the float32 tolerance; a gradient is rounded to bfloat16
(8-bit mantissa) on each side, so two float32 sums that straddle a rounding
boundary can land one bfloat16 step (2^-7 relative) apart: rtol 2^-7.
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
from test_torch_model import _check_all, _pair, _states
from test_torch_support import case, to_u64

BF16_GRAD_RTOL = 2.0 ** -7

VARIANTS = [
    dict(num_lut=1),
    dict(num_lut=2),
    dict(num_lut=4),
    dict(num_lut=2, aggregate_phase=True),
    dict(num_lut=7, aggregate_phase=True, use_phase_spin_sym=True),
    dict(num_lut=3, use_amp_spin_sym=False, aggregate_phase=True),
    dict(combined_amp_phase=True),
    dict(combined_amp_phase=True, use_amp_spin_sym=False),
    dict(combined_amp_phase=True, num_lut=2),
    dict(combined_amp_phase=True, num_lut=2, aggregate_phase=True, masking="full"),
    dict(input_encoding="integer"),
    dict(input_encoding="integer", use_amp_spin_sym=False),
    dict(input_encoding="integer", use_amp_spin_sym=False, use_phase_spin_sym=True,
         aggregate_phase=True),
    dict(input_encoding="integer", num_lut=2, aggregate_phase=True),
    dict(input_encoding="integer", num_lut=3, use_amp_spin_sym=False, aggregate_phase=True),
    dict(input_encoding="integer", combined_amp_phase=True, num_lut=3),
    dict(param_dtype="float64"),
    dict(param_dtype="float64", num_lut=2, combined_amp_phase=True,
         input_encoding="integer"),
    dict(param_dtype="float64", aggregate_phase=True, phase_activation="tanh", num_lut=2),
]
ACTIVATIONS = [dict(phase_activation=a, masking=m, aggregate_phase=agg)
               for a in ("softsign", "tanh", "hardtanh", "sin", "sigmoid")
               for m in ("none", "partial", "full") for agg in (False, True)]


def _ids(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items())


def _grads(cfg_j, params, model, seed=4):
    """Gradients of sum(w_a log|psi| + w_p arg psi) on both sides, the JAX
    ones as a state_dict."""
    states = _states(14, ((5, 5),), n=200, seed=seed)
    rng = np.random.default_rng(seed + 1)
    w_a = rng.normal(size=len(states)).astype(np.float32)
    w_p = rng.normal(size=len(states)).astype(np.float32)

    def loss_j(p):
        la, ph = nade_j.log_psi(cfg_j, p, jnp.asarray(to_u64(states)))
        return jnp.sum(w_a * la + w_p * ph)

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(loss_j)(params)))
    la, ph = nade_t.log_psi(model, torch.as_tensor(states))
    torch.sum(torch.as_tensor(w_a) * la + torch.as_tensor(w_p) * ph).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    return got, want


@pytest.mark.parametrize("kw", VARIANTS + ACTIVATIONS, ids=_ids)
def test_variant_matches_jax(kw):
    """log_psi, the shell tables, every shell's conditional, the parameter
    count and the gradients of every group."""
    cfg_j, params, model = _pair(seed=7, **kw)
    assert nade_t.count_parameters(model) == nade_j.count_parameters(params)
    assert model.cfg == nt.NAQSConfig(**{f: getattr(cfg_j, f)
                                         for f in cfg_j.__dataclass_fields__})
    _check_all(cfg_j, params, model, _states(14, ((5, 5),)))
    got, want = _grads(cfg_j, params, model)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_lut_groups_and_dtypes():
    """The LUT tables' shapes, the groups combined_amp_phase leaves out, and
    the parameters' dtype."""
    cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), num_lut=3, aggregate_phase=True,
                        amp_hidden=(8,), phase_hidden=(8,), param_dtype="float64")
    model = nade_t.NADE(cfg)
    assert [tuple(t.shape) for t in model.lut] == [(1, 5), (4, 5), (16, 5)]
    assert [tuple(t.shape) for t in model.lut_phase] == [(1, 4), (4, 4), (16, 4)]
    assert {p.dtype for p in model.parameters()} == {torch.float64}
    comb = nade_t.NADE(nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), num_lut=2,
                                     combined_amp_phase=True, input_encoding="integer",
                                     amp_hidden=(8,)))
    names = {k.split(".")[0] for k, _ in comb.named_parameters()}
    assert names == {"amp", "lut"}
    assert [tuple(t.shape) for t in comb.lut] == [(1, 8), (3, 8)]
    assert comb.amp.w[0].shape == (7, 6, 8) and comb.cfg.use_phase_spin_sym


@pytest.mark.parametrize("kw", [dict(num_lut=-1), dict(num_lut=8), dict(num_lut=7),
                                dict(num_lut=9, aggregate_phase=True, n_qubits=20),
                                dict(shell_order=(0, 1, 2, 3, 4, 5, 5)), dict(n_qubits=13)],
                         ids=_ids)
def test_config_errors_match_jax(kw):
    kw = dict(dict(n_qubits=14, sectors=((5, 5),)), **kw)
    with pytest.raises(ValueError):
        nade_j.NAQSConfig(**kw)
    with pytest.raises(ValueError):
        nt.NAQSConfig(**kw)


@pytest.mark.parametrize("kw", [dict(combined_amp_phase=True),
                                dict(combined_amp_phase=True, use_amp_spin_sym=False,
                                     use_phase_spin_sym=True),
                                dict(num_lut=7, aggregate_phase=True),
                                dict(num_lut=8, n_qubits=20)], ids=_ids)
def test_config_normalization_matches_jax(kw):
    """combined_amp_phase forces the phase spin symmetry to the amplitude's;
    in_width and the accepted LUT counts as in JAX."""
    kw = dict(dict(n_qubits=14, sectors=((5, 5),)), **kw)
    for enc in ("binary", "integer"):
        cfg_j = nade_j.NAQSConfig(input_encoding=enc, **kw)
        cfg_t = nt.NAQSConfig(input_encoding=enc, **kw)
        assert cfg_t.use_phase_spin_sym == cfg_j.use_phase_spin_sym
        assert cfg_t.in_width == cfg_j.in_width and cfg_t.n_shells == cfg_j.n_shells


def test_unknown_phase_activation_raises_at_use():
    cfg_j, params, model = _pair(phase_activation="relu")
    states = _states(14, ((5, 5),), n=4)
    with pytest.raises(ValueError, match="relu"):
        nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(states)))
    with pytest.raises(ValueError, match="relu"):
        nade_t.log_psi(model, torch.as_tensor(states))


def test_sigmoid_phase_on_the_global_nets_zero_rows():
    """With one global phase net, the activation sees the zero rows of every
    shell but the last: sigmoid puts pi/2 on each whose mask leaves a choice,
    and the port's arg psi carries them as JAX's does."""
    cfg_j, params, model = _pair(phase_activation="sigmoid", masking="none", seed=2)
    states = _states(14, ((5, 5),), n=50)
    _, ph_j = nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(states)))
    _, ph_t = nade_t.log_psi(model, torch.as_tensor(states))
    _, tp_t = nade_t.shell_tables(model, torch.as_tensor(states))
    np.testing.assert_allclose(tp_t[:, :-1].detach().numpy(), np.pi / 2, rtol=1e-6)
    np.testing.assert_allclose(ph_t.detach().numpy(), np.asarray(ph_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(num_lut=2, combined_amp_phase=True),
                                dict(aggregate_phase=True, num_lut=2,
                                     input_encoding="integer")], ids=lambda kw: _ids(kw) or "default")
def test_bfloat16_params_match_jax(kw):
    cfg_j, params, model = _pair(seed=5, param_dtype="bfloat16", **kw)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert nade_t.count_parameters(model) == nade_j.count_parameters(params)
    _check_all(cfg_j, params, model, _states(14, ((5, 5),)))
    got, want = _grads(cfg_j, params, model)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.bfloat16, k
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                   rtol=BF16_GRAD_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(num_lut=4, aggregate_phase=False),  # chip_smoke run A's model
    dict(num_lut=3, combined_amp_phase=True, input_encoding="integer",
         aggregate_phase=True),  # run B's
], ids=["lut4-single-phase", "lut3-combined-integer"])
def test_full_width_variant_matches_jax(kw):
    """The paper-scale widths (amp 64, phase 512x512) on H2O STO-3G."""
    c = case("H2O")
    cfg_j, params, model = _pair(sectors=c.h_t.sectors, amp_hidden=(64,),
                                 phase_hidden=(512, 512), seed=1, **kw)
    _check_all(cfg_j, params, model, c.h_t.basis)
