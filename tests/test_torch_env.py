"""The JAX package's engine-cap environment variables pick the same E_loc
engine in the port, and both packages then agree on E_loc.

`NAQS_TPU_DENSE` is read at each `DeviceTerms.from_terms` call, so it is set
in-process. The size caps are read at import (`naqs_tpu/ops/rank.py:42`,
`naqs_tpu/ops/dense_engine.py:56-62, 551-552`), so each case runs in a fresh
interpreter that imports both packages with the variable set; the compiled
terms and the batch reach it through an .npz file.

Tolerances: those of tests/test_torch_local_energy.py, 2e-5 Ha per E_loc row
and 5e-6 Ha on the weighted mean (fp32 off-diagonal sums in another order).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naqs_tpu.ops import dense_engine as de_j
from naqs_tpu.ops import local_energy as le_j
from naqs_tpu_torch.ops import dense_engine as de_t
from naqs_tpu_torch.ops import local_energy as le_t
from test_torch_support import REPO, case, near_hf_states, padded_batch, to_u64

ROW_TOL = 2e-5
MEAN_TOL = 5e-6
M, CAP = 120, 128

_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax.numpy as jnp
    import torch
    import naqs_tpu as nq
    import naqs_tpu_torch as nt
    from naqs_tpu.hamiltonian import PauliTerms as PauliTermsJ
    from naqs_tpu.ops import local_energy as le_j
    from naqs_tpu_torch.hamiltonian import PauliTerms
    from naqs_tpu_torch.ops import local_energy as le_t

    z = np.load(sys.argv[1])
    n_exc = int(z["n_exc"]) if int(z["n_exc"]) >= 0 else None
    sectors = [tuple(int(v) for v in x) for x in z["sectors"]]
    arrays = {k: z[k] for k in ("diag_yz", "diag_coeff", "xy", "yz", "coeff",
                                "xy_unique", "gxy", "yz_unique", "gyz")}
    n_q = int(z["n_qubits"])
    terms_t = PauliTerms(n_qubits=n_q, **arrays)
    u64 = ("diag_yz", "xy", "yz", "xy_unique", "yz_unique")
    terms_j = PauliTermsJ(n_qubits=n_q, **{k: (v.astype(np.uint64) if k in u64 else v)
                                            for k, v in arrays.items()})
    dt_t = le_t.DeviceTerms.from_terms(
        terms_t, hilbert=nt.Hilbert(n_qubits=n_q, sectors=sectors, n_exc_max=n_exc),
        device="cpu")
    dt_j = le_j.DeviceTerms.from_terms(
        terms_j, hilbert=nq.Hilbert(n_qubits=n_q, sectors=sectors, n_exc_max=n_exc))

    def engine(dt):
        if dt.dense is not None:
            return type(dt.dense).__name__
        return "rank" if dt.rank_spec is not None else "sort"

    m = int(z["m"])
    re_t, im_t = le_t.local_energy(dt_t, torch.as_tensor(z["s"]), torch.as_tensor(z["la"]),
                                   torch.as_tensor(z["ph"]), m)
    re_j, im_j = le_j.local_energy(dt_j, jnp.asarray(z["s_u64"]), jnp.asarray(z["la"]),
                                   jnp.asarray(z["ph"]), jnp.int32(m))
    re_t, im_t, re_j, im_j = (np.asarray(a)[:m] for a in (re_t, im_t, re_j, im_j))
    w = z["w"][:m]
    print(json.dumps({"port": engine(dt_t), "jax": engine(dt_j),
                      "row": float(max(np.abs(re_t - re_j).max(), np.abs(im_t - im_j).max())),
                      "mean": float(abs(np.sum(w * re_t) - np.sum(w * re_j)))}))
""")

# (variable, value, the other variables of the case, n_exc_max, the engine
# both packages must pick, the engine they pick without the variable)
IMPORT_CASES = [
    ("NAQS_TPU_RANK_MAX", "1", {}, None, "sort", "DenseTerms"),
    ("NAQS_TPU_DENSE_MAX", "1", {}, None, "FactorTerms", "DenseTerms"),
    ("NAQS_TPU_DENSE_H_MAX", "1", {}, None, "FactorTerms", "DenseTerms"),
    ("NAQS_TPU_FACT_MAX", "1", {"NAQS_TPU_DENSE_MAX": "1"}, None, "rank", "FactorTerms"),
    ("NAQS_TPU_FACT_R1_MAX", "1", {"NAQS_TPU_DENSE_MAX": "1"}, None, "rank", "FactorTerms"),
    ("NAQS_TPU_XL_CELLS_MAX", "1", {"NAQS_TPU_DENSE_MAX": "1", "NAQS_TPU_FACT_MAX": "1"}, 2,
     "rank", "FactorTermsXL"),
    ("NAQS_TPU_XL_U_MAX", "1", {"NAQS_TPU_DENSE_MAX": "1", "NAQS_TPU_FACT_MAX": "1"}, 2,
     "rank", "FactorTermsXL"),
]
_CAP_NAMES = {"NAQS_TPU_DENSE_MAX": "DENSE_SIZE_MAX", "NAQS_TPU_FACT_MAX": "FACT_SIZE_MAX"}


def _batch(c):
    rng = np.random.default_rng(3)
    s, la, ph, counts = padded_batch(near_hf_states(c, M, rng), CAP, rng)
    return s, la, ph, counts / counts.sum()


def _engine(dt):
    if dt.dense is not None:
        return type(dt.dense).__name__
    return "rank" if dt.rank_spec is not None else "sort"


def test_dense_switch_turns_the_grid_engines_off_in_both(monkeypatch):
    """NAQS_TPU_DENSE=0: no grid program, the rank engine in both packages;
    without it both carry DenseTerms (H2O STO-3G)."""
    c = case("H2O")
    s, la, ph, w = _batch(c)
    for value, want in (("1", "DenseTerms"), ("0", "rank")):
        monkeypatch.setenv("NAQS_TPU_DENSE", value)
        dt_t = le_t.DeviceTerms.from_terms(c.terms_t, hilbert=c.h_t, device="cpu")
        dt_j = le_j.DeviceTerms.from_terms(c.terms_j, hilbert=c.h_j)
        assert _engine(dt_t) == _engine(dt_j) == want
        re_t, im_t = le_t.local_energy(dt_t, torch.as_tensor(s), torch.as_tensor(la),
                                       torch.as_tensor(ph), M)
        re_j, im_j = le_j.local_energy(dt_j, jnp.asarray(to_u64(s)), jnp.asarray(la),
                                       jnp.asarray(ph), jnp.int32(M))
        np.testing.assert_allclose(re_t.numpy()[:M], np.asarray(re_j)[:M], rtol=0, atol=ROW_TOL)
        np.testing.assert_allclose(im_t.numpy()[:M], np.asarray(im_j)[:M], rtol=0, atol=ROW_TOL)
        assert abs(np.sum(w[:M] * (re_t.numpy()[:M] - np.asarray(re_j)[:M]))) < MEAN_TOL


@pytest.mark.parametrize("var,value,base,n_exc,want,without",
                         IMPORT_CASES, ids=[c[0] for c in IMPORT_CASES])
def test_import_time_cap_picks_the_same_engine(var, value, base, n_exc, want, without,
                                               tmp_path, monkeypatch):
    c = case("H2O")
    # without the variable (its base caps patched in, as the fresh interpreter
    # would read them), this process picks `without` in both packages
    for name, v in base.items():
        for mod in (de_t, de_j):
            monkeypatch.setattr(mod, _CAP_NAMES[name], int(v))
    hil_t = c.h_t if n_exc is None else type(c.h_t)(
        n_qubits=c.h_t.n_qubits, sectors=c.h_t.sectors, n_exc_max=n_exc)
    assert _engine(le_t.DeviceTerms.from_terms(c.terms_t, hilbert=hil_t,
                                               device="cpu")) == without

    s, la, ph, w = _batch(c)
    t = c.terms_t
    path = tmp_path / "case.npz"
    np.savez(path, n_qubits=t.n_qubits, sectors=np.asarray(c.h_t.sectors),
             n_exc=-1 if n_exc is None else n_exc, m=M, s=s, s_u64=to_u64(s), la=la, ph=ph,
             w=w, diag_yz=t.diag_yz, diag_coeff=t.diag_coeff, xy=t.xy, yz=t.yz,
             coeff=t.coeff, xy_unique=t.xy_unique, gxy=t.gxy, yz_unique=t.yz_unique, gyz=t.gyz)
    env = {k: v for k, v in os.environ.items() if not k.startswith("NAQS_TPU_")}
    env.update(base, **{var: value}, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port"] == got["jax"] == want, got
    assert got["row"] <= ROW_TOL and got["mean"] <= MEAN_TOL, got
