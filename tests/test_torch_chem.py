"""The port's chemistry modules against the JAX package's, on the CPU.

The same geometries go through `naqs_tpu.chem` and `naqs_tpu_torch.chem`
(device="cpu"). On the CPU the port's ERIs come from its plain version,
`eri_tensor_ref`, a copy of the JAX loops, so the AO integrals agree to the
bit; the SCF, MP2 and CCSD are torch float64 against numpy, in another
summation order, so they agree to the convergence thresholds' scale:

* `boys_ref` (the kernel's Boys routine as torch) against `boys` within 1e-14
  relative on x in {0, 1e-14} and [2e-3, 1e3], n_max <= 8, and against
  mpmath within 2e-15 on [0, 1e3], the band 1e-13 < x < 2e-3 included, where
  the JAX formula (gammainc / x^(n+1/2)) itself errs by up to 2.5e-14;
* `build_integrals` S, T, V and the ERIs within 1e-13 absolute (H2O STO-3G;
  a hand-made basis with a d sextet on two centres, through the spherical-d
  transform);
* `rhf` (H2O, LiH STO-3G): HF within 1e-9 Ha, MP2 within 1e-8, orbital
  energies within 1e-9, h1 and the MO ERIs within 1e-8 once both sides' MOs
  are sign-fixed the same way (each column's largest-|c| entry positive);
  `rohf` (triplet CH2): HF within 1e-9; `ccsd` closed and open shell within
  1e-8 Ha (the SCF and CCSD stop at |dE| < 1e-11 and 1e-9: another add
  order can end an iteration earlier or later);
* `rotate_state` against the JAX one; `plot_wavefunction` draws and writes.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import mpmath
import numpy as np
import pytest
import torch

import naqs_tpu_torch  # noqa: F401  (settles the CPU math first)
from naqs_tpu.chem import cc as cc_j
from naqs_tpu.chem import integrals as int_j
from naqs_tpu.chem import scf as scf_j
from naqs_tpu.chem.basis import build_basis as build_basis_j
from naqs_tpu.utils.unitaries import rotate_state as rotate_state_j
from naqs_tpu_torch.chem import cc as cc_t
from naqs_tpu_torch.chem import generate as gen_t
from naqs_tpu_torch.chem import integrals as int_t
from naqs_tpu_torch.chem import scf as scf_t
from naqs_tpu_torch.chem.basis import build_basis as build_basis_t
from naqs_tpu_torch.utils.plotting import plot_wavefunction
from naqs_tpu_torch.utils.unitaries import rotate_state

GEOMETRIES = {
    "H2O": (["O", "H", "H"], [[0.0, 0.0, 0.0], [0.2774, 0.8929, 0.2544],
                              [0.6068, -0.2383, -0.7169]]),
    "LiH": (["Li", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 1.5949]]),
    "CH2": (["C", "H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.9911, 0.6040],
                              [0.0, -0.9911, 0.6040]]),
}
INT_ATOL = 1e-13
HF_TOL, MP2_TOL, EPS_TOL, MO_TOL, CC_TOL = 1e-9, 1e-8, 1e-9, 1e-8, 1e-8


@lru_cache(maxsize=None)
def _scf(name: str):
    """(JAX result, port result) of rhf, or rohf (triplet) for CH2."""
    syms, pos = GEOMETRIES[name]
    if name == "CH2":
        return (scf_j.rohf(syms, np.asarray(pos)),
                scf_t.rohf(syms, np.asarray(pos), device="cpu"))
    return scf_j.rhf(syms, np.asarray(pos)), scf_t.rhf(syms, np.asarray(pos), device="cpu")


def _boys_grid():
    # 0 and 1e-14 take the JAX formula's Taylor branch (x < 1e-13); between
    # 1e-13 and ~2e-3 that formula (gammainc / x^(n+1/2)) errs by up to 2.5e-14
    # relative for n >= 5 (against mpmath), so that band is held to mpmath below
    return np.unique(np.concatenate([[0.0, 1e-14], np.geomspace(2e-3, 1e3, 400),
                                     np.linspace(2e-3, 30.0, 601)]))


@pytest.mark.parametrize("n_max", range(9))
def test_boys_ref_matches_jax_boys(n_max):
    x = _boys_grid()
    want = int_j.boys(n_max, x)
    got = int_t.boys_ref(n_max, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    np.testing.assert_array_equal(int_t.boys_tensor(n_max, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("n_max", [3, 8])
def test_boys_ref_matches_mpmath(n_max):
    """Over the whole range, the small-x band included, against the exact
    F_n = gamma(n+1/2, x) / (2 x^(n+1/2)) at 40 digits."""
    mpmath.mp.dps = 40
    x = np.concatenate([[0.0, 1e-14], np.geomspace(1e-13, 1e3, 90),
                        np.linspace(11.5, 12.5, 11)])
    got = int_t.boys_ref(n_max, torch.from_numpy(x)).numpy()
    for n in range(n_max + 1):
        exact = np.array([1.0 / (2 * n + 1) if v == 0 else float(
            mpmath.gammainc(n + 0.5, 0, mpmath.mpf(v)) / (2 * mpmath.mpf(v) ** (n + 0.5)))
            for v in x])
        np.testing.assert_allclose(got[n], exact, rtol=2e-15, atol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 7])
def test_unique_quartets_cover_every_position_once(n):
    q = int_t.unique_quartets(n)
    loop = [(i, j, k, l) for i in range(n) for j in range(i + 1) for k in range(i + 1)
            for l in range((j if k == i else k) + 1)]
    assert [tuple(r) for r in q.tolist()] == loop
    owner = {}
    for idx, quartet in enumerate(q.tolist()):
        for pos in set(int_t.quartet_images(quartet)):
            assert owner.setdefault(pos, idx) == idx, (pos, owner[pos], idx)
    assert len(owner) == n ** 4


def _d_basis(mod_integrals):
    """A d sextet (in D_CART_ORDER, so that the spherical-d transform
    applies) on each of two centres, beside an s and a p triplet."""
    cg = mod_integrals.ContractedGaussian
    a, b = np.zeros(3), np.array([0.3, -0.4, 1.9])
    out = [cg(a, (0, 0, 0), [3.1, 0.6], [0.4, 0.7])]
    out += [cg(a, lmn, [0.9], [1.0]) for lmn in mod_integrals.D_CART_ORDER]
    out += [cg(b, lmn, [1.7], [1.0]) for lmn in ((1, 0, 0), (0, 1, 0), (0, 0, 1))]
    out += [cg(b, lmn, [1.2], [1.0]) for lmn in mod_integrals.D_CART_ORDER]
    return out


def _check_integrals(got, want):
    for g, w, name in zip(got, want, ("S", "T", "V", "ERI")):
        assert g.dtype == torch.float64 and g.device.type == "cpu", name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=INT_ATOL, err_msg=name)


def test_build_integrals_matches_jax_h2o():
    syms, pos = GEOMETRIES["H2O"]
    centers = np.asarray(pos) * int_j.ANGSTROM_TO_BOHR
    charges = [8.0, 1.0, 1.0]
    want = int_j.build_integrals(build_basis_j(syms, centers), charges, centers)
    got = int_t.build_integrals(build_basis_t(syms, centers), charges, centers, device="cpu")
    _check_integrals(got, want)


def test_build_integrals_with_d_functions_and_spherical_transform():
    centers = np.array([[0.0, 0.0, 0.0], [0.3, -0.4, 1.9]])
    charges = [3.0, 1.0]
    bj, bt = _d_basis(int_j), _d_basis(int_t)
    want = int_j.build_integrals(bj, charges, centers)
    got = int_t.build_integrals(bt, charges, centers, device="cpu")
    _check_integrals(got, want)
    np.testing.assert_array_equal(int_t.spherical_d_transform(bt),
                                  int_j.spherical_d_transform(bj))
    sph_j = scf_j._to_spherical(bj, *want)
    sph_t = scf_t._to_spherical(bt, *got)
    assert sph_t[3].shape == (14, 14, 14, 14)
    _check_integrals(sph_t, sph_j)


def test_packed_basis_sorts_quartets_by_class():
    pb = int_t.PackedBasis.from_basis(_d_basis(int_t), "cpu")
    lmn = pb.lmn.sum(dim=1)
    cls = lmn[pb.quartets.long()].sum(dim=1)
    assert pb.class_ptr[0] == 0 and pb.class_ptr[-1] == pb.quartets.shape[0]
    for L in range(int_t.ERI_MAX_L + 1):
        assert (cls[pb.class_ptr[L]:pb.class_ptr[L + 1]] == L).all()
    assert [c[0] for c in pb.classes] == list(range(int_t.ERI_MAX_L + 1))  # dddd present
    assert sorted(map(tuple, pb.quartets.tolist())) == \
        sorted(map(tuple, int_t.unique_quartets(pb.n).tolist()))


def test_eri_tensor_checks_its_inputs():
    pb = int_t.PackedBasis.from_basis(_d_basis(int_t), "cpu")
    with pytest.raises(ValueError, match="alphas"):
        int_t.eri_tensor(dataclasses.replace(pb, alphas=pb.alphas.float()))
    with pytest.raises(ValueError, match="class_ptr"):
        int_t.eri_tensor(dataclasses.replace(pb, class_ptr=pb.class_ptr[:-1]))
    with pytest.raises(ValueError, match="n_max"):
        int_t.boys_tensor(9, torch.zeros(3, dtype=torch.float64))
    f_shell = int_t.ContractedGaussian(np.zeros(3), (3, 0, 0), [1.0], [1.0])
    with pytest.raises(NotImplementedError):
        int_t.PackedBasis.from_basis([f_shell], "cpu")


def _sign_fixed(c):
    """Signs that make each MO column's largest-|c| entry positive."""
    c = np.asarray(c)
    return np.sign(c[np.abs(c).argmax(axis=0), np.arange(c.shape[1])])


@pytest.mark.parametrize("name", ["H2O", "LiH"])
def test_rhf_matches_jax(name):
    rj, rt = _scf(name)
    assert abs(rt.e_hf - rj.e_hf) < HF_TOL
    assert abs(rt.e_mp2 - rj.e_mp2) < MP2_TOL
    assert abs(rt.e_nuc - rj.e_nuc) < 1e-12
    assert rt.n_electrons == rj.n_electrons
    np.testing.assert_allclose(rt.orbital_energies.numpy(), rj.orbital_energies,
                               rtol=0, atol=EPS_TOL)
    sj, st = _sign_fixed(rj.mo_coeff), _sign_fixed(rt.mo_coeff.numpy())
    h1j = np.einsum("p,q,pq->pq", sj, sj, rj.one_body_mo)
    h1t = np.einsum("p,q,pq->pq", st, st, rt.one_body_mo.numpy())
    np.testing.assert_allclose(h1t, h1j, rtol=0, atol=MO_TOL)
    g2j = np.einsum("p,q,r,s,pqrs->pqrs", sj, sj, sj, sj, rj.two_body_mo)
    g2t = np.einsum("p,q,r,s,pqrs->pqrs", st, st, st, st, rt.two_body_mo.numpy())
    np.testing.assert_allclose(g2t, g2j, rtol=0, atol=MO_TOL)


def test_rohf_matches_jax():
    rj, rt = _scf("CH2")
    assert (rt.n_alpha, rt.n_beta, rt.multiplicity) == (rj.n_alpha, rj.n_beta, 3)
    assert abs(rt.e_hf - rj.e_hf) < HF_TOL
    assert np.isnan(rt.e_mp2)
    np.testing.assert_allclose(rt.orbital_energies.numpy(), rj.orbital_energies,
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", ["H2O", "CH2"])
def test_ccsd_matches_jax(name):
    rj, rt = _scf(name)
    cj = cc_j.ccsd(rj)
    ct = cc_t.ccsd(rt, device="cpu")
    assert cj.converged and ct.converged
    assert abs(ct.e_ccsd - cj.e_ccsd) < CC_TOL
    assert abs(ct.e_corr - cj.e_corr) < CC_TOL
    # the stored-layout entry point takes numpy integrals as well
    ct2 = cc_t.ccsd_from_integrals(rj.one_body_mo, rj.two_body_mo, rj.n_electrons, rj.e_hf,
                                   rj.e_nuc, n_alpha=rj.n_alpha or None,
                                   n_beta=rj.n_beta or None, device="cpu")
    assert abs(ct2.e_ccsd - cj.e_ccsd) < CC_TOL


def test_entry_points_refuse_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    syms, pos = GEOMETRIES["LiH"]
    centers = np.asarray(pos) * int_t.ANGSTROM_TO_BOHR
    for call in (lambda: scf_t.rhf(syms, pos), lambda: scf_t.rohf(*GEOMETRIES["CH2"]),
                 lambda: gen_t.generate_molecule_data(syms, pos),
                 lambda: int_t.build_integrals(build_basis_t(syms, centers), [3.0, 1.0], centers),
                 lambda: cc_t.ccsd(_scf("LiH")[1])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("state,bases", [
    (0b00, {0: "X"}), (0b01, {0: "X"}), (0b10, {0: "Y", 1: "Y"}),
    (0b1011, {0: "X", 2: "Y", 3: "Z"}), ((1 << 40) | 0b101, {40: "Y", 1: "X", 5: "X"}),
    (0b111, {})])
def test_rotate_state_matches_jax(state, bases):
    sj, aj = rotate_state_j(state, bases)
    st, at = rotate_state(state, bases)
    assert st.dtype == np.int64
    np.testing.assert_array_equal(st, sj.astype(np.int64))
    np.testing.assert_array_equal(at, aj)
    assert np.all(np.diff(st) > 0)


def test_plot_wavefunction_draws_and_writes(tmp_path):
    amps = np.random.default_rng(0).random(200)
    fname = os.path.join(tmp_path, "psi.png")
    fig = plot_wavefunction(torch.from_numpy(amps), top_k=20, fname=fname)
    assert os.path.getsize(fname) > 0
    bars = fig.axes[0].patches
    assert len(bars) == 20
    np.testing.assert_allclose([b.get_height() for b in bars], np.sort(amps)[::-1][:20])
