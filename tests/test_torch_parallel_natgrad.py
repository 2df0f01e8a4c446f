"""The port's data-parallel SR and K-FAC steps against naqs_tpu's
`make_sharded_sr_step` and `make_sharded_kfac_step`, two ranks on the CPU
(gloo), set up as `tests/test_torch_parallel_adam.py` is: LiH STO-3G
(DenseTerms), amp and phase nets of 16, capacity 128 a rank, 500 samples, the
ranks' batches those of JAX's `sample` from `jax.random.split(k, 2)`.

SR (`step.sharded_sr_update`): float32 parameters at cg_iters 3 and damping
1e-2, the new parameters within 2e-3 of the update's norm (as the
single-device test: float32 CG amplifies the last bits of the gradient);
float64 parameters at cg_iters 10 and damping 1e-3 with the KL clip,
fisher_mix and |psi|^2 weights, within 5e-8 (the local energies are float32
sums in another order in each package, ~1e-6 Ha apart; the rest is float64).
Energies 5e-6 Ha, the gradient norm 1e-5 relative, n_unique exactly.

K-FAC (`step.sharded_kfac_update`): two successive steps from fresh
factors, the second on batches sampled from JAX's parameters after the
first; the factors rtol 1e-5 / atol 1e-7 (float32 Grams summed over both
ranks), nu 1e-5 relative and the parameters within 1e-4 of the update's
norm (float32 LU solves), as the single-device K-FAC test.

Both ranks' parameters (and K-FAC's factors) bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naqs_tpu.kfac import kfac_init as kfac_init_j
from naqs_tpu.models import nade as nade_j
from naqs_tpu.ops.local_energy import DeviceTerms as DeviceTermsJ
from naqs_tpu.parallel import make_mesh, make_sharded_kfac_step, make_sharded_sr_step
from naqs_tpu.sampler import sample as sample_j
from naqs_tpu_torch.models.convert import kfac_state_from_jax
from naqs_tpu_torch.parallel.launch import spawn
from test_torch_parallel_adam import CAP, D, N_SAMPLES, port_batch, tree
from test_torch_support import case

import test_torch_parallel_ranks as ranks

MEAN_TOL = 5e-6
TIMEOUT = 180
SR_CASES = {
    "float32": dict(cfg={}, cg_iters=3, damping=1e-2, tol=2e-3),
    "float64_kl_clip_fisher_mix_reweight": dict(
        cfg=dict(param_dtype="float64"), cg_iters=10, damping=1e-3, kl_clip=1e-4,
        fisher_mix=0.2, reweight=True, tol=5e-8),
}
KFAC = dict(lr=5e-2, damping=1e-2, decay=0.95, kl_clip=1e-3)
KFAC_STEPS = 2


def _update_error(got: dict, want: dict, old: dict) -> float:
    """|port's new parameters - JAX's| / |JAX's update| over every parameter."""
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum()) for k in want)
    den = sum(float(((want[k].astype(np.float64) - old[k]) ** 2).sum()) for k in want)
    return (num / max(den, 1e-300)) ** 0.5


@pytest.fixture(scope="module")
def setup():
    c = case("LiH")
    cfg_kw = dict(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                  phase_hidden=(16,))
    dt_j = DeviceTermsJ.from_terms(c.terms_j, hilbert=c.h_j)
    return c, cfg_kw, dt_j, make_mesh(jax.devices()[:D])


def _batches(cfg_j, params, seed):
    keys = jax.random.split(jax.random.key(seed), D)
    return keys, [port_batch(sample_j(cfg_j, params, keys[i], jnp.float64(N_SAMPLES) / D, CAP))
                  for i in range(D)]


@pytest.fixture(scope="module")
def sr_runs(setup, tmp_path_factory):
    c, cfg_kw, dt_j, mesh = setup
    want, cases = {}, []
    for i, (name, k) in enumerate(SR_CASES.items()):
        cfg_j = nade_j.NAQSConfig(**cfg_kw, **k["cfg"])
        params = nade_j.init_params(jax.random.key(10 + i), cfg_j)
        keys, batches = _batches(cfg_j, params, 20 + i)
        assert not any(b[3] for b in batches)
        step = make_sharded_sr_step(cfg_j, mesh, CAP, cg_iters=k["cg_iters"],
                                    reweight_by_psi=k.get("reweight", False),
                                    kl_clip=k.get("kl_clip"),
                                    fisher_mix=k.get("fisher_mix", 0.0))
        new, m = step(params, dt_j, keys, jnp.float64(N_SAMPLES), jnp.float64(5e-2),
                      jnp.float64(k["damping"]))
        want[name] = dict(old=tree(params), params=tree(new), metrics=m)
        cases.append(dict(cfg=k["cfg"], params=tree(params), batches=batches, lr=5e-2,
                          damping=k["damping"], cg_iters=k["cg_iters"],
                          reweight=k.get("reweight", False), kl_clip=k.get("kl_clip"),
                          fisher_mix=k.get("fisher_mix", 0.0)))
    got = spawn(ranks.sharded_sr, D, (cfg_kw, None, c.h_t, c.terms_t, cases),
                workdir=str(tmp_path_factory.mktemp("sr")), timeout=TIMEOUT)
    return want, {name: [got[r][i] for r in range(D)] for i, name in enumerate(SR_CASES)}


@pytest.mark.parametrize("name", list(SR_CASES))
def test_sharded_sr_step_matches_jax(sr_runs, name):
    want, got = sr_runs
    w = want[name]
    for r in range(D):
        m = got[name][r]["metrics"]
        assert abs(float(m["e_loc"]) - float(w["metrics"]["e_loc"])) < MEAN_TOL
        np.testing.assert_allclose(float(m["e_loc_var"]), float(w["metrics"]["e_loc_var"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(w["metrics"]["grad_norm"]),
                                   rtol=1e-5)
        assert int(m["n_unique"]) == int(w["metrics"]["n_unique"])
        assert not bool(m["overflow"]) and int(m["cg_iters"]) == SR_CASES[name]["cg_iters"]
        err = _update_error(got[name][r]["params"], w["params"], w["old"])
        assert err < SR_CASES[name]["tol"], err
    a, b = (got[name][r]["params"] for r in range(D))
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.fixture(scope="module")
def kfac_runs(setup, tmp_path_factory):
    c, cfg_kw, dt_j, mesh = setup
    cfg_j = nade_j.NAQSConfig(**cfg_kw)
    params = nade_j.init_params(jax.random.key(30), cfg_j)
    step = make_sharded_kfac_step(cfg_j, mesh, CAP)
    kstate = kfac_init_j(params)
    want, batches = [], []
    for s in range(KFAC_STEPS):
        keys, b = _batches(cfg_j, params, 40 + s)
        assert not any(x[3] for x in b)
        old = tree(params)
        params, kstate, m = step(params, kstate, dt_j, keys, jnp.float64(N_SAMPLES),
                                 *(jnp.float32(KFAC[k]) for k in ("lr", "damping", "decay",
                                                                   "kl_clip")))
        want.append(dict(old=old, params=tree(params), metrics=m,
                         kstate=kfac_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                           kstate))))
        batches.append(b)
    got = spawn(ranks.sharded_kfac, D,
                (cfg_kw, want[0]["old"], c.h_t, c.terms_t, batches, KFAC),
                workdir=str(tmp_path_factory.mktemp("kfac")), timeout=TIMEOUT)
    return want, got


@pytest.mark.parametrize("step", range(KFAC_STEPS))
def test_sharded_kfac_steps_match_jax(kfac_runs, step):
    want, got = kfac_runs
    w = want[step]
    for r in range(D):
        s = got[r][step]
        assert s["kstep"] == step + 1
        for name in ("amp", "phase"):
            for fac, fac_j in zip(s["kstate"][name], w["kstate"][name]):
                for k in ("A", "G"):
                    np.testing.assert_allclose(fac[k], fac_j[k].numpy(), rtol=1e-5, atol=1e-7,
                                               err_msg=f"rank {r} {name} {k}")
        np.testing.assert_allclose(float(s["metrics"]["nu"]), float(w["metrics"]["nu"]),
                                   rtol=1e-5)
        assert abs(float(s["metrics"]["e_loc"]) - float(w["metrics"]["e_loc"])) < MEAN_TOL
        assert int(s["metrics"]["n_unique"]) == int(w["metrics"]["n_unique"])
        err = _update_error(s["params"], w["params"], w["old"])
        assert err < 1e-4, err
    a, b = got[0][step], got[1][step]
    assert all(a["params"][k].tobytes() == b["params"][k].tobytes() for k in a["params"])
    for name in ("amp", "phase"):
        for fa, fb in zip(a["kstate"][name], b["kstate"][name]):
            assert fa["A"].tobytes() == fb["A"].tobytes() and fa["G"].tobytes() == fb["G"].tobytes()
