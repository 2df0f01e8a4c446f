"""The model's fused glue against naqs_tpu's on converted parameters: the
plain versions of `csrc/nade_glue.cu`'s four kernels (`ops/nade_glue.py`)
and the autograd Function over the tables' epilogue, which `log_psi`,
`loss.backward()` and torch.func's jvp and vjp (SR's S v) go through.

Per variant (test_torch_model_variants.py's VARIANTS and ACTIVATIONS, more
sectors, float64), on sector states, states outside the sector (rows
whose masks leave no option at some shells) and SENTINEL rows:
`state_features` against split_spins, prefix_stats, shell_inputs and the
occupation, exactly; `log_psi` against JAX's; its gradient (the Function's
vjp) against jax.vjp; its tangent (the Function's jvp) against jax.jvp; and
`amp_conditional_shell` (`shell_features`, the MLP, `shell_epilogue`) on
every shell's prefixes. One whole-slice case: `vmc_loss` and its gradients
on one batch fed to both packages.

Tolerances, as test_torch_model*.py: 1e-5 on values (f32 products and sums
in another order), and relative 1e-6 where a masked option or a row with no
allowed option puts a value near -5e8 (one float32 ulp there is 32-256);
rtol 1e-4 / atol 1e-6 on gradients and tangents (tangents scaled by the
largest); bfloat16 gradients rtol 2^-7 (test_torch_model_variants.py); a
float64 model's arg psi within 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, jvp

import naqs_tpu_torch as nt
from naqs_tpu.models import nade as nade_j
from naqs_tpu_torch.models import nade as nade_t
from naqs_tpu_torch.models.convert import params_from_jax
from naqs_tpu_torch.ops import nade_glue
from naqs_tpu_torch.utils.bits import SENTINEL, pack_bits
from test_torch_model_variants import ACTIVATIONS, BF16_GRAD_RTOL, VARIANTS, _ids
from test_torch_support import to_u64

TOL = 1e-5
F64_TOL = 1e-10   # arg psi of a float64 model: float64 products and sums
MULTI = ((5, 3), (4, 4), (3, 5))
CASES = VARIANTS + ACTIVATIONS + [
    dict(sectors=MULTI, masking="full"),
    dict(sectors=MULTI, phase_activation="sigmoid", use_phase_spin_sym=True),
    dict(param_dtype="float64", use_phase_spin_sym=True, phase_activation="sin",
         masking="full"),
    dict(param_dtype="bfloat16", aggregate_phase=True, use_phase_spin_sym=True),
]


def _pair(sectors, seed, n_qubits=14, **kw):
    """The JAX and the port's model on the same parameters, drawn with numpy
    in the JAX package's tree layout (`init_params`' shapes) and converted
    by `params_from_jax`."""
    kw = dict(dict(amp_hidden=(16,), phase_hidden=(32, 32)), **kw)
    cfg_j = nade_j.NAQSConfig(n_qubits=n_qubits, sectors=sectors, **kw)
    cfg_t = nt.NAQSConfig(n_qubits=n_qubits, sectors=sectors, **kw)
    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(cfg_j.param_dtype)

    def draw(shape, scale):
        return jnp.asarray(rng.uniform(-scale, scale, size=shape), dtype)

    def stack(n, dims):
        return [{"w": draw((n, a, b), a ** -0.5), "b": draw((n, b), a ** -0.5)}
                for a, b in zip(dims[:-1], dims[1:])]

    s, n_amp = cfg_j.n_shells, cfg_j.n_amp_out
    n_out = n_amp + (cfg_j.n_phase_out if cfg_j.combined_amp_phase else 0)
    params = {"amp": stack(s, (cfg_j.in_width, *cfg_j.amp_hidden, n_out))}
    if not cfg_j.combined_amp_phase:
        params["phase"] = stack(s if cfg_j.aggregate_phase else 1,
                                (cfg_j.in_width, *cfg_j.phase_hidden, cfg_j.n_phase_out))
    for name, canonical, width in (("lut", cfg_j.use_amp_spin_sym, n_out),
                                   ("lut_phase", cfg_j.use_phase_spin_sym, cfg_j.n_phase_out)):
        if cfg_j.num_lut and (name == "lut" or "phase" in params and cfg_j.aggregate_phase):
            base = nade_j._lut_base(cfg_j, canonical)
            params[name] = [draw((base ** j, width), 1.0) for j in range(cfg_j.num_lut)]
    model = nade_t.NADE(cfg_t)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return cfg_j, params, model


def _states(sectors, seed=0):
    """Sector states, random 14-bit states (most outside the sector: their
    masks leave no option at some shells) and SENTINEL rows."""
    rng = np.random.default_rng(seed)
    basis = nt.Hilbert(n_qubits=14, sectors=sectors).basis
    return np.concatenate([rng.choice(basis, size=48, replace=False),
                           rng.integers(0, 1 << 14, size=12), [SENTINEL] * 3]).astype(np.int64)


def _close(got, want, atol, err_msg=""):
    """Within atol where |want| < 1e8, within 1e-6 relative elsewhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = np.abs(want) > 1e8
    np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=atol, err_msg=err_msg)
    np.testing.assert_allclose(got[big], want[big], rtol=1e-6, atol=0, err_msg=err_msg)


def _check_features(cfg_j, model, states):
    """state_features against the JAX package's features, exactly."""
    cfg = model.cfg
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
    assert x.dtype == cfg.compute_dtype
    want = nade_j.shell_inputs(cfg_j, alpha, beta, canonical=cfg.use_amp_spin_sym)
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(want))
    second = (not cfg.combined_amp_phase
              and cfg.use_phase_spin_sym != cfg.use_amp_spin_sym)
    assert (x2 is not None) == second
    if second:
        want2 = np.asarray(nade_j.shell_inputs(cfg_j, alpha, beta,
                                               canonical=cfg.use_phase_spin_sym))
        np.testing.assert_array_equal(x2.float().numpy(),
                                      want2 if cfg.aggregate_phase else want2[:, -1])


def _jax_reference(cfg_j, params, states, cot, tangent):
    """The JAX package's side in one compiled program: (log|psi|, arg psi),
    the vjp of the cotangents, the jvp along the tangent, and
    amp_conditional_shell on the prefixes of every shell (mapped over j)."""
    s = cfg_j.n_shells

    @jax.jit
    def run(params, states, cot, tangent):
        f = lambda p: nade_j.log_psi(cfg_j, p, states)
        out, vjp_fn = jax.vjp(f, params)
        grads = vjp_fn((cot[0].astype(out[0].dtype), cot[1].astype(out[1].dtype)))[0]
        dots = jax.jvp(f, (params,), (tangent,))[1]
        alpha, beta = nade_j.split_spins(cfg_j, states)
        keep = jnp.arange(s)[:, None, None] > jnp.arange(s)[None, None, :]
        conds = jax.vmap(lambda j, k: nade_j.amp_conditional_shell(
            cfg_j, params, j, alpha * k, beta * k))(jnp.arange(s, dtype=jnp.int32), keep)
        return out, grads, dots, conds

    return jax.tree_util.tree_map(np.asarray, run(params, states, cot, tangent))


def _check_conditionals(model, states, want):
    """amp_conditional_shell on the prefixes of every shell."""
    alpha, beta = nade_t.split_spins(model.cfg, torch.as_tensor(states))
    s = model.cfg.n_shells
    keep = torch.arange(s)[:, None, None] > torch.arange(s)[None, None, :]
    for j in range(s):
        la4_j, m_j, p_j = (w[j] for w in want)
        a, b = alpha * keep[j], beta * keep[j]
        with torch.no_grad():
            la4_t, m_t, p_t = nade_t.amp_conditional_shell(model, j, pack_bits(a), pack_bits(b))
        np.testing.assert_array_equal(m_t.numpy(), m_j, err_msg=f"shell {j}")
        np.testing.assert_allclose(p_t.float().numpy(), p_j, rtol=0, atol=TOL)
        np.testing.assert_array_equal(p_t.numpy() == 0, p_j == 0)
        _close(la4_t.numpy(), la4_j, TOL, f"shell {j}")


@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_glue_matches_jax(kw):
    kw = dict(kw)
    sectors = kw.pop("sectors", ((5, 5),))
    cfg_j, params, model = _pair(sectors, 11, **kw)
    states = _states(sectors)
    st_j, st_t = jnp.asarray(to_u64(states)), torch.as_tensor(states)
    _check_features(cfg_j, model, states)

    # the forward (state_features, the nets, tables_epilogue), its vjp and
    # its jvp along a seeded tangent of every parameter (SR's S v)
    rng = np.random.default_rng(3)
    cot = rng.normal(size=(2, len(states))).astype(np.float32)
    tangent = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
    (la_j, ph_j), grads_j, dots_j, conds_j = _jax_reference(cfg_j, params, st_j, cot, tangent)
    la_t, ph_t = nade_t.log_psi(model, st_t)
    _close(la_t.detach().float().numpy(), la_j, TOL, "log|psi|")
    _close(ph_t.detach().float().numpy(), ph_j, TOL, "arg psi")
    if model.cfg.param_dtype == "float64":   # the phase symmetry's shift is pi in float64 too
        np.testing.assert_allclose(ph_t.detach().numpy(), ph_j, rtol=0, atol=F64_TOL)
    assert np.isfinite(la_t.detach().numpy()).all() and np.isfinite(ph_t.detach().numpy()).all()
    torch.sum(torch.as_tensor(cot[0]) * la_t + torch.as_tensor(cot[1]) * ph_t).backward()
    want = params_from_jax(grads_j)
    rtol = BF16_GRAD_RTOL if model.cfg.param_dtype == "bfloat16" else 1e-4
    for k, p in model.named_parameters():
        assert p.grad.dtype == want[k].dtype, k
        np.testing.assert_allclose(p.grad.float().numpy(), want[k].float().numpy(), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    primals = {k: p.detach() for k, p in model.named_parameters()}
    tangents = params_from_jax(jax.tree_util.tree_map(np.asarray, tangent))
    tangents = {k: tangents[k] for k in primals}
    dots_t = jvp(lambda p: functional_call(model, p, (st_t,)), (primals,), (tangents,))[1]
    for got, w in zip(dots_t, dots_j):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got.double().numpy(), w, rtol=rtol,
                                   atol=1e-6 * max(1.0, float(np.abs(w).max())))
    _check_conditionals(model, states, conds_j)


def test_epilogue_function_modes_agree_with_autograd_of_the_plain_forward():
    """TablesEpilogue's backward and jvp (the written-out plain vjp and jvp)
    against autograd and forward-mode AD of the plain forward, for a combined
    trunk and a global phase net, with rows whose masks leave no option."""
    import torch.autograd.forward_ad as fwad

    for kw in (dict(combined_amp_phase=True, num_lut=2, masking="full"),
               dict(phase_activation="sigmoid", masking="full")):
        cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), amp_hidden=(8,),
                            phase_hidden=(8,), **kw)
        model = nade_t.NADE(cfg, torch.Generator().manual_seed(5))
        x, x2, code = nade_glue.state_features(cfg, torch.as_tensor(_states(((5, 5),), 2)))
        with torch.no_grad():
            raw, raw_phase = nade_t._raw(model, x, x2)
        leaves = [raw.clone().requires_grad_(True)]
        if raw_phase is not None:
            leaves.append(raw_phase.clone().requires_grad_(True))
        phase = leaves[1] if raw_phase is not None else None
        gen = torch.Generator().manual_seed(6)
        cot = [torch.randn(raw.shape[0], generator=gen) for _ in range(2)]
        la, ph = nade_glue.log_psi_epilogue(cfg, leaves[0], phase, code)
        got = torch.autograd.grad(torch.sum(cot[0] * la + cot[1] * ph), leaves)
        la_r, ph_r = nade_glue.tables_epilogue_ref(cfg, *leaves[:1], phase, code)
        want = torch.autograd.grad(torch.sum(cot[0] * la_r + cot[1] * ph_r), leaves)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        tans = [torch.randn(t.shape, generator=gen) for t in leaves]
        with fwad.dual_level():
            duals = [fwad.make_dual(t.detach(), d) for t, d in zip(leaves, tans)]
            dual_phase = duals[1] if raw_phase is not None else None
            outs = nade_glue.tables_epilogue_ref(cfg, duals[0], dual_phase, code)
            want = [fwad.unpack_dual(o).tangent for o in outs]
        got = jvp(lambda *t: nade_glue.log_psi_epilogue(cfg, t[0], t[1] if len(t) > 1 else None,
                                                        code),
                  tuple(t.detach() for t in leaves), tuple(tans))[1]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_vmc_loss_on_one_batch_matches_jax():
    """The whole slice on LiH STO-3G: vmc_loss over one batch at capacity
    (SENTINEL rows past n_unique, each weighted 0) and its gradients, the
    features and the epilogue on every row, against the JAX package's update
    on the same batch (its gradients kept by test_torch_trainer's optax
    transform that applies nothing), with test_torch_trainer's tolerances."""
    from naqs_tpu import trainer as trainer_j
    from naqs_tpu.ops.local_energy import DeviceTerms as DeviceTermsJ
    from naqs_tpu.sampler import SampleBatch as SampleBatchJ
    from naqs_tpu_torch.sampler import SampleBatch
    from naqs_tpu_torch.trainer import vmc_loss
    from test_torch_support import case, padded_batch
    from test_torch_trainer import _grab_grads, _rank_terms

    c = case("LiH")
    cfg_j, params, model = _pair(c.h_t.sectors, 4, n_qubits=c.h_t.n_qubits,
                                 use_phase_spin_sym=True, phase_activation="tanh")
    rng = np.random.default_rng(1)
    s, _, _, counts = padded_batch(np.sort(rng.choice(c.h_t.basis, 120, replace=False)), 128,
                                   rng)
    bj = SampleBatchJ(states=jnp.asarray(to_u64(s)), counts=jnp.asarray(counts),
                      n_unique=jnp.int32(120), overflow=jnp.array(False))
    bt = SampleBatch(states=torch.as_tensor(s), counts=torch.as_tensor(counts),
                     n_unique=torch.tensor(120), overflow=torch.tensor(False))
    assert int((bt.states == SENTINEL).sum()) == 8
    dt_j = dataclasses.replace(DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j), dense=None)
    grab = _grab_grads()
    update_j = jax.jit(trainer_j._vmc_update_impl, static_argnums=(0, 1))
    _, g_j, m_j = update_j(cfg_j, grab, params, grab.init(params), dt_j, bj)
    loss, e_mean, e_var = vmc_loss(model, _rank_terms(c), bt)
    loss.backward()
    assert abs(loss.item() - float(m_j["loss"])) < 5e-6
    assert abs(e_mean.item() - float(m_j["e_loc"])) < 5e-6
    assert abs(e_var.item() - float(m_j["e_loc_var"])) < 1e-4 * max(1.0, float(m_j["e_loc_var"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("bad", ["states_dtype", "raw_shape", "phase_for_combined", "shell"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    cfg = nt.NAQSConfig(n_qubits=14, sectors=((5, 5),), amp_hidden=(8,), phase_hidden=(8,))
    states = torch.as_tensor(_states(((5, 5),)))
    x, _, code = nade_glue.state_features(cfg, states)
    with pytest.raises(ValueError):
        if bad == "states_dtype":
            nade_glue.state_features(cfg, states.int())
        elif bad == "raw_shape":
            nade_glue.tables_epilogue(cfg, torch.zeros(len(states), 7, 4), torch.zeros(
                len(states), 4), code)
        elif bad == "phase_for_combined":
            nade_glue.tables_epilogue(dataclasses.replace(cfg, combined_amp_phase=True),
                                      torch.zeros(len(states), 7, 9), torch.zeros(
                                          len(states), 4), code)
        else:
            a = torch.zeros(4, dtype=torch.int64)
            nade_glue.shell_features(cfg, a, a, 7)
