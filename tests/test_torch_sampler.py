"""Port sampler, checked statistically (its random stream differs from JAX's).

Mirrors tests/test_sampler.py and tests/test_sample_beta.py on H2O STO-3G
(441 states), with the model's parameters converted from naqs_tpu and the
target |psi|^2 computed by naqs_tpu's log_psi. A sampled frequency must lie
within 4 sqrt(p(1-p)/n) + 5e-5 of its probability.
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
from naqs_tpu_torch.ops.multinomial import binomial, multinomial4
from naqs_tpu_torch.sampler import sample
from naqs_tpu_torch.utils.bits import SENTINEL
from test_torch_support import case, to_u64


def _setup(**kw):
    c = case("H2O")
    kw = dict(dict(amp_hidden=(16,), phase_hidden=(8,), masking="full"), **kw)
    cfg_j = nade_j.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, **kw)
    params = nade_j.init_params(jax.random.key(11), cfg_j)
    model = nade_t.NADE(nt.NAQSConfig(n_qubits=14, sectors=c.h_t.sectors, **kw))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return c, cfg_j, params, model


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _live(batch):
    nu = int(batch.n_unique)
    return batch.states[:nu].numpy(), batch.counts[:nu].numpy(), nu


def _check_freqs(states, counts, n, p_of_basis, basis):
    p_map = dict(zip(basis.tolist(), p_of_basis.tolist()))
    p = np.array([p_map[s] for s in states.tolist()])
    freqs = counts / n
    tol = 4.0 * np.sqrt(p * (1 - p) / n) + 5e-5
    assert np.all(np.abs(freqs - p) < tol), np.max(np.abs(freqs - p) - tol)
    # every state with decent mass was sampled
    sampled = set(states.tolist())
    assert all(b in sampled for b, q in zip(basis.tolist(), p_of_basis) if q > 1e-3)
    return freqs


def test_multinomial4_conserves_and_distributes():
    counts = torch.tensor([1e6, 0.0, 17.0, 1e12], dtype=torch.float64)
    probs = torch.tensor([[0.1, 0.2, 0.3, 0.4], [0.25] * 4, [0.0, 0.0, 1.0, 0.0],
                          [0.5, 0.5, 0.0, 0.0]])
    out = multinomial4(_gen(0), counts, probs).numpy()
    np.testing.assert_array_equal(out.sum(-1), counts.numpy())  # exact row sums
    assert out[2, 2] == 17.0 and out[2, [0, 1, 3]].sum() == 0
    np.testing.assert_allclose(out[0] / 1e6, [0.1, 0.2, 0.3, 0.4], atol=2e-3)
    assert out[3, 2] == 0 and out[3, 3] == 0
    assert np.all(out == np.round(out)) and np.all(out >= 0)


@pytest.mark.parametrize("n,p", [(20.0, 0.3), (5000.0, 0.001), (40.0, 0.9), (1e5, 0.4)])
def test_binomial_moments(n, p):
    """Both branches (inverse CDF for var <= 25, Gaussian above) and the
    p > 1/2 flip: sample mean and variance within 5 standard errors."""
    m = 200_000
    k = binomial(_gen(1), torch.full((m,), n, dtype=torch.float64),
                 torch.full((m,), p, dtype=torch.float64)).numpy()
    mean, var = n * p, n * p * (1 - p)
    assert np.all((k >= 0) & (k <= n)) and np.all(k == np.round(k))
    assert abs(k.mean() - mean) < 5 * np.sqrt(var / m)
    assert abs(k.var() - var) < 5 * var * np.sqrt(2 / m) + 0.05


def test_sampler_physical_and_conserving():
    c, _, _, model = _setup()
    n = 1e6
    batch = sample(model, _gen(1), n, capacity=512)
    states, counts, nu = _live(batch)
    assert not bool(batch.overflow)
    assert nu <= c.h_t.size
    assert np.all(np.diff(states) > 0)              # unique, ascending
    assert np.all(c.h_t.contains(states))
    assert np.all(batch.states[nu:].numpy() == SENTINEL)  # SENTINEL sorts last
    assert np.all(batch.counts[nu:].numpy() == 0)
    assert batch.counts.sum().item() == n           # full masking: nothing lost


def test_sampler_frequencies_match_psi2():
    c, cfg_j, params, model = _setup()
    n = 2e6
    states, counts, _ = _live(sample(model, _gen(2), n, capacity=512))
    basis = c.h_t.basis
    la, _ = nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(basis)))
    p = np.exp(2 * np.asarray(la, dtype=np.float64))
    p /= p.sum()
    freqs = _check_freqs(states, counts, n, p, basis)
    assert freqs.sum() > 0.999


def test_sampler_overflow_flag():
    _, _, _, model = _setup()
    batch = sample(model, _gen(3), 1e6, capacity=32)
    assert bool(batch.overflow)  # 441-state basis at a flat-ish init > 32 uniques
    assert int(batch.n_unique) <= 32


def test_sampler_partial_masking_discards_unphysical():
    c, _, _, model = _setup(masking="partial")
    n = 1e5
    batch = sample(model, _gen(4), n, capacity=512)
    states, _, _ = _live(batch)
    assert np.all(c.h_t.contains(states))  # discarded, never returned
    assert batch.counts.sum().item() < n    # some mass dropped


def test_beta_one_is_the_default_path():
    _, _, _, model = _setup()
    a = sample(model, _gen(7), 1e4, 64)
    b = sample(model, _gen(7), 1e4, 64, beta=1.0)
    assert torch.equal(a.states, b.states) and torch.equal(a.counts, b.counts)


def test_tempering_widens_support_and_conserves_counts():
    c, _, _, model = _setup()
    with torch.no_grad():  # skew |psi|^2 so the plain sampler misses the tail
        model.amp.w[-1].mul_(8.0)
    plain = sample(model, _gen(11), 1000.0, 1024)
    temp = sample(model, _gen(11), 1000.0, 1024, beta=0.25)
    assert int(temp.n_unique) > int(plain.n_unique)
    assert temp.counts.sum().item() == 1000.0
    states, _, _ = _live(temp)
    assert np.all(c.h_t.contains(states))


def test_tempered_frequencies_match_tempered_conditionals():
    """With beta, state s is drawn with prob prod_j p_j(s)^beta / Z_j(s)."""
    c, _, _, model = _setup()
    beta, n = 0.5, 2e6
    states, counts, _ = _live(sample(model, _gen(12), n, capacity=512, beta=beta))
    basis = c.h_t.basis
    with torch.no_grad():
        la4, _ = nade_t.shell_tables(model, torch.as_tensor(basis))
        alpha, beta_bits = nade_t.split_spins(model.cfg, torch.as_tensor(basis))
    pt = torch.exp(2.0 * beta * la4.double())
    cond = pt / pt.sum(-1, keepdim=True)
    occ = (alpha + 2 * beta_bits)[..., None]
    q = torch.take_along_dim(cond, occ, dim=-1)[..., 0].prod(-1).numpy()
    _check_freqs(states, counts, n, q, basis)


@pytest.mark.parametrize("kw", [dict(num_lut=3), dict(num_lut=2, param_dtype="float64"),
                                dict(num_lut=2, combined_amp_phase=True,
                                     input_encoding="integer", param_dtype="bfloat16")],
                         ids=["lut", "lut-float64", "lut-combined-integer-bfloat16"])
def test_variant_sampler_frequencies_match_psi2(kw):
    """The sampler on LUT shells (the table row, no MLP), with float64
    conditionals (split in float64, as JAX splits them) and bfloat16
    parameters (float32 conditionals)."""
    c, cfg_j, params, model = _setup(**kw)
    n = 2e6
    states, counts, _ = _live(sample(model, _gen(3), n, capacity=512))
    basis = c.h_t.basis
    la, _ = nade_j.log_psi(cfg_j, params, jnp.asarray(to_u64(basis)))
    p = np.exp(2 * np.asarray(la, dtype=np.float64))
    p /= p.sum()
    assert _check_freqs(states, counts, n, p, basis).sum() > 0.999
