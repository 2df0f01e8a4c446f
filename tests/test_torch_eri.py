"""The ERI kernel's inputs and schedule against the JAX package, on the CPU.

`csrc/eri.cu` reads a primitive-pair table and a work list that
`naqs_tpu_torch.chem.integrals.PackedBasis` builds on the host. Here:

* the table's rows (p, P and the Hermite weights c_a c_b / p E_t E_u E_v)
  against the JAX package's `_e_coeffs` on every function and primitive pair
  of H2O 6-31G and H2 cc-pVTZ (d functions), within 1e-14 relative, zeros
  where JAX's E products are zero;
* primitive quartets evaluated from two rows as the kernel does (`_prim_rows`:
  alpha, `boys_ref`, the R box in place, the signed contraction) against
  c_a c_b c_c c_d times JAX's `_prim_eri` on a seeded sample of each of those
  bases, within 1e-13 Ha;
* the work list: every (quartet, primitive quartet) covered by exactly one
  item, a quartet's items consecutive and in order, the quartets visited by
  class, largest first, the unrolled shapes stored bra first, each
  descriptor's shape the one its functions have (`pair_shape` against
  `ERI_PAIR_SHAPES`, and that list against `csrc/eri.cu`'s);
* `_replay`, a numpy replay of the whole kernel (per-item sums in order, each
  warp's segmented scan, the two partial slots a warp, the last warp's sum in
  warp order) against `eri_tensor_ref` within ERI_ATOL on two small bases
  made by hand, s and p on three centres and s and d on two (classes up to
  L = 8), at the default chunk and at others, in two orders of the warps'
  arrival; no partial slot is written twice and every position is written.
"""

from __future__ import annotations

import math
import os
import re
from functools import lru_cache

import numpy as np
import pytest
import torch

import naqs_tpu_torch  # noqa: F401  (settles the CPU math first)
from naqs_tpu.chem import integrals as int_j
from naqs_tpu_torch.chem import integrals as int_t
from naqs_tpu_torch.chem.basis import build_basis
from naqs_tpu_torch.tools.eri_timing import with_chunk

H2O = (["O", "H", "H"], [[0.0, 0.0, 0.0], [0.2774, 0.8929, 0.2544], [0.6068, -0.2383, -0.7169]])
H2 = (["H", "H"], [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7414]])
TWO_PI25 = 2.0 * math.pi ** 2.5


def _basis(name):
    """A molecule's basis ("H2O 6-31g", "H2 cc-pvtz"), or a small one made by
    hand: "sp" (s and p contractions of 1-3 primitives on three centres,
    classes up to L = 4) and "sd" (an s of two primitives, then a d sextet of
    two on another centre: classes up to L = 8)."""
    cg = int_t.ContractedGaussian
    a, b, c = np.zeros(3), np.array([0.3, -0.4, 1.9]), np.array([-1.1, 0.8, 0.5])
    if name == "sp":
        return ([cg(a, (0, 0, 0), [5.03, 1.17, 0.38], [0.15, 0.53, 0.44]),
                 cg(a, (0, 0, 0), [0.9, 0.25], [0.3, 0.8])]
                + [cg(a, lmn, [1.1, 0.3], [0.5, 0.6]) for lmn in ((1, 0, 0), (0, 1, 0), (0, 0, 1))]
                + [cg(b, (0, 0, 0), [3.4, 0.6, 0.17], [0.15, 0.53, 0.44]),
                   cg(c, (0, 0, 0), [0.5], [1.0])])
    if name == "sd":
        return ([cg(a, (0, 0, 0), [3.1, 0.6], [0.4, 0.7])]
                + [cg(b, lmn, [1.2, 0.4], [0.6, 0.5]) for lmn in int_t.D_CART_ORDER])
    syms, pos = {"H2O": H2O, "H2": H2}[name.split()[0]]
    return build_basis(syms, np.asarray(pos) * int_t.ANGSTROM_TO_BOHR, name.split()[1])


def _packed(name, chunk=None):
    pb = int_t.PackedBasis.from_basis(_basis(name), "cpu")
    if chunk is not None:
        pb = with_chunk(pb, chunk)
    h = {f: getattr(pb, f).numpy() for f in
         ("centers", "lmn", "prim_ptr", "alphas", "cn", "quartets", "qdesc", "qitems", "items")}
    h["pairs"] = pb.pairs.numpy().T        # the table by rows
    h["pair_l"] = pb.pair_l
    return pb, h


@lru_cache(maxsize=None)
def _plain(name):
    return int_t.eri_tensor_ref(_packed(name)[0]).numpy()


def _sums(h):
    """(Q, 6) the exponent sums of each quartet's bra and ket, from its
    functions: the bra the function pair whose rows qdesc[:, 0] starts at."""
    _, row0 = int_t.pair_table(h["centers"], h["lmn"], h["prim_ptr"], h["alphas"], h["cn"])
    q = h["quartets"].astype(np.int64)
    swap = h["qdesc"][:, 0] != row0[int_t.pair_id(q[:, 0], q[:, 1])]   # stored as (kl|ij)
    q = np.where(swap[:, None], q[:, [2, 3, 0, 1]], q)
    lmn = h["lmn"]
    return np.concatenate([lmn[q[:, 0]] + lmn[q[:, 1]], lmn[q[:, 2]] + lmn[q[:, 3]]], axis=1)


def _decoded(h):
    """(Q, 6) the bra's and ket's exponent sums as the kernel reads them
    from the descriptors: the shape code, or on an s/p basis the two places
    in ERI_PAIR_SHAPES."""
    shape = h["qdesc"][:, 3].astype(np.int64) >> 8
    if h["pair_l"] > 2:
        return np.stack([(shape >> (3 * k)) & 7 for k in range(6)], axis=1)
    table = np.asarray(int_t.ERI_PAIR_SHAPES)
    return np.concatenate([table[shape & 15], table[shape >> 4]], axis=1)


def _prim_rows(bra, ket, shape):
    """c_a c_b c_c c_d [ab|cd] of primitive quartets from their (N, ERI_ROW)
    bra and ket rows, one shape: the kernel's arithmetic in numpy."""
    t1, u1, v1, t2, u2, v2 = shape
    big_l = sum(shape)
    p, q = bra[:, 0], ket[:, 0]
    x_, y_, z_ = (bra[:, 1 + d] - ket[:, 1 + d] for d in range(3))
    alpha = p * q / (p + q)
    f = int_t.boys_ref(big_l, torch.from_numpy(alpha * (x_ * x_ + y_ * y_ + z_ * z_))).numpy()
    pw = np.ones_like(alpha)
    for n in range(big_l + 1):
        f[n] = f[n] * pw
        pw = pw * (-2.0 * alpha)
    tm, um, vm = t1 + t2, u1 + u2, v1 + v2
    nv, nuv = vm + 1, (um + 1) * (vm + 1)
    r = [None] * ((tm + 1) * nuv)   # a read of an entry never written fails
    r[0] = f[big_l]
    for n in range(big_l - 1, -1, -1):
        for tot in range(big_l - n, 0, -1):
            for t in range(min(tot, tm), -1, -1):
                for u in range(min(tot - t, um), -1, -1):
                    v = tot - t - u
                    if v > vm:
                        break
                    if t > 0:
                        val = x_ * r[(t - 1) * nuv + u * nv + v]
                        if t > 1:
                            val = val + (t - 1) * r[(t - 2) * nuv + u * nv + v]
                    elif u > 0:
                        val = y_ * r[(u - 1) * nv + v]
                        if u > 1:
                            val = val + (u - 1) * r[(u - 2) * nv + v]
                    else:
                        val = z_ * r[v - 1]
                        if v > 1:
                            val = val + (v - 1) * r[v - 2]
                    r[t * nuv + u * nv + v] = val
        r[0] = f[n]
    out, eb = np.zeros_like(p), 4
    for t in range(t1 + 1):
        for u in range(u1 + 1):
            for v in range(v1 + 1):
                inner, ek = np.zeros_like(p), 4
                for tt in range(t2 + 1):
                    for uu in range(u2 + 1):
                        for vv in range(v2 + 1):
                            term = ket[:, ek] * r[(t + tt) * nuv + (u + uu) * nv + v + vv]
                            inner = inner - term if (tt + uu + vv) & 1 else inner + term
                            ek += 1
                out = out + bra[:, eb] * inner
                eb += 1
    return out * TWO_PI25 / np.sqrt(p + q)


def _prim_values(h, qs, ms):
    """The kernel's value of primitive quartet ms[i] of quartet qs[i]."""
    d = h["qdesc"][qs]
    nk = d[:, 3] & 0xFF
    bra = h["pairs"][d[:, 0] + ms // nk]
    ket = h["pairs"][d[:, 1] + ms % nk]
    out = np.empty(len(qs))
    shapes = _decoded(h)[qs]
    for shape in np.unique(shapes, axis=0):
        sel = (shapes == shape).all(axis=1)
        out[sel] = _prim_rows(bra[sel], ket[sel], shape.tolist())
    return out


def _expanded(h, chunk):
    """(item, quartet, primitive quartet, place in the item) of every
    primitive quartet the work list covers."""
    items, qdesc = h["items"].astype(np.int64), h["qdesc"].astype(np.int64)
    rows = []
    for k in range(chunk):
        m = items[:, 1] + k
        ok = m < qdesc[items[:, 0], 2]
        rows.append(np.stack([np.nonzero(ok)[0], items[ok, 0], m[ok], np.full(ok.sum(), k)],
                             axis=1))
    return np.concatenate(rows)


def _replay(h, chunk, n, seed=0):
    """The kernel end to end in numpy: (n, n, n, n) output, NaN where nothing
    was written; the warps arrive in an order drawn from `seed`."""
    items = h["items"].astype(np.int64)
    n_items = items.shape[0]
    ex = _expanded(h, chunk)
    vals = _prim_values(h, ex[:, 1], ex[:, 2])
    acc = np.zeros(-(-n_items // 32) * 32)
    for k in range(chunk):                         # acc += v in each item's m order
        sel = ex[:, 3] == k
        acc[ex[sel, 0]] = acc[ex[sel, 0]] + vals[sel]
    qi = np.full(acc.size, -1)
    qi[:n_items] = items[:, 0]
    acc, qi = acc.reshape(-1, 32), qi.reshape(-1, 32)
    lane = np.arange(32)
    prev = np.concatenate([qi[:, :1], qi[:, :-1]], axis=1)
    head = (lane == 0) | (prev != qi)
    start = np.maximum.accumulate(np.where(head, lane, 0), axis=1)
    for off in (1, 2, 4, 8, 16):                   # __shfl_up_sync: low lanes keep theirs
        y = np.concatenate([acc[:, :off], acc[:, :-off]], axis=1)
        acc = np.where(lane - off >= start, acc + y, acc)
    last = np.concatenate([head[:, 1:], np.ones((head.shape[0], 1), bool)], axis=1)
    partial = np.full(2 * acc.shape[0], np.nan)
    written = np.zeros(partial.size, int)
    result, spans = {}, {}
    warps = np.random.default_rng(seed).permutation(acc.shape[0])   # arrival order
    for w in warps:
        for ln in np.nonzero(last[w] & (qi[w] >= 0))[0]:
            q = int(qi[w, ln])
            first, count = h["qitems"][q]
            w0, w1 = first >> 5, (first + count - 1) >> 5
            if w0 == w1:
                result[q] = acc[w, ln]
                continue
            slot = 2 * w + (0 if start[w, ln] == 0 else 1)
            partial[slot] = acc[w, ln]
            written[slot] += 1
            spans.setdefault(q, []).append(w)
            if len(spans[q]) == w1 - w0 + 1:       # the last warp to arrive
                s = partial[2 * w0 + (1 if first & 31 else 0)]
                for v in range(w0 + 1, w1 + 1):
                    s = s + partial[2 * v]
                result[q] = s
    assert written.max(initial=0) <= 1
    g = np.full((n,) * 4, np.nan)
    for q, val in result.items():
        for pos in int_t.quartet_images(tuple(h["quartets"][q])):
            g[pos] = val
    return g


@pytest.mark.parametrize("name", ["H2O 6-31g", "H2 cc-pvtz"])
def test_pair_table_matches_jax_e_coeffs(name):
    pb, h = _packed(name)
    centers, lmn, ptr = h["centers"], h["lmn"], h["prim_ptr"]
    alphas, cn = h["alphas"], h["cn"]
    _, row0 = int_t.pair_table(centers, lmn, ptr, alphas, cn)
    n, checked = pb.n, 0
    for i in range(n):
        for j in range(i + 1):
            r = row0[int_t.pair_id(i, j)]
            for a in range(ptr[i], ptr[i + 1]):
                for b in range(ptr[j], ptr[j + 1]):
                    row = h["pairs"][r]
                    r += 1
                    aa, bb = alphas[a], alphas[b]
                    p = aa + bb
                    e = [int_j._e_coeffs(lmn[i, d], lmn[j, d], aa, bb,
                                         centers[i, d] - centers[j, d])[lmn[i, d], lmn[j, d]]
                         for d in range(3)]
                    w = np.einsum("t,u,v->tuv", *e).ravel() * (cn[a] * cn[b] / p)
                    assert row[0] == p
                    np.testing.assert_allclose(row[1:4], (aa * centers[i] + bb * centers[j]) / p,
                                               rtol=1e-15, atol=0)
                    np.testing.assert_allclose(row[4:4 + w.size], w, rtol=1e-14, atol=0)
                    assert np.array_equal(row[4:4 + w.size] == 0, w == 0)
                    assert not row[4 + w.size:].any()
                    checked += 1
    assert checked == h["pairs"].shape[0]


@pytest.mark.parametrize("name", ["H2O 6-31g", "H2 cc-pvtz"])
def test_pair_rows_give_jax_prim_eri(name):
    pb, h = _packed(name)
    rng = np.random.default_rng(7)
    nq_prim = h["qdesc"][:, 2].astype(np.int64)
    classes = pb.classes
    qs = np.concatenate([rng.integers(q0, q1, 40) for _, q0, q1 in classes])
    ms = (rng.random(qs.size) * nq_prim[qs]).astype(np.int64)
    got = _prim_values(h, qs, ms)
    centers, lmn, ptr = h["centers"], h["lmn"], h["prim_ptr"]
    alphas, cn = h["alphas"], h["cn"]
    _, row0 = int_t.pair_table(centers, lmn, ptr, alphas, cn)
    for q, m, g in zip(qs, ms, got):
        fns = h["quartets"][q]
        if h["qdesc"][q, 0] != row0[int_t.pair_id(fns[0], fns[1])]:   # stored as (kl|ij)
            fns = fns[[2, 3, 0, 1]]
        npr = [ptr[f + 1] - ptr[f] for f in fns]
        idx = np.unravel_index(m, npr)
        prim = [ptr[f] + k for f, k in zip(fns, idx)]
        args = []
        for f, pr in zip(fns, prim):
            args += [tuple(lmn[f]), alphas[pr], centers[f]]
        want = np.prod(cn[prim]) * int_j._prim_eri(*args)
        assert abs(g - want) <= 1e-13, (name, q, m, g, want)
    assert set(_sums(h)[qs].sum(axis=1).tolist()) == {c[0] for c in classes}


@pytest.mark.parametrize("name,chunk", [("H2O 6-31g", None), ("H2 cc-pvtz", None),
                                        ("sp", 1), ("sp", 4), ("sd", 3)])
def test_work_list_covers_every_primitive_quartet_once(name, chunk):
    pb, h = _packed(name, chunk)
    total = int(h["qdesc"][:, 2].astype(np.int64).sum())
    if chunk is None:
        assert pb.chunk == max(1, math.isqrt(total // int_t.ERI_CHUNK_SCALE))
    ex = _expanded(h, pb.chunk)
    assert ex.shape[0] == total
    key = ex[:, 1] * (1 << 32) + ex[:, 2]
    assert np.unique(key).size == total                    # no primitive quartet twice
    want = np.repeat(np.arange(pb.quartets.shape[0]), h["qdesc"][:, 2])
    assert np.array_equal(np.sort(ex[:, 1]), want)        # each quartet's m = 0 .. n_prim - 1
    first, count = h["qitems"][:, 0], h["qitems"][:, 1]
    items = h["items"]
    assert count.sum() == items.shape[0]
    place = np.arange(items.shape[0]) - first[items[:, 0]]   # an item's place in its quartet
    assert ((place >= 0) & (place < count[items[:, 0]])).all()
    assert np.array_equal(items[:, 1], place * pb.chunk)
    sums = _sums(h)
    assert np.array_equal(_decoded(h), sums)               # the shapes its functions have
    cls = sums[items[:, 0]].sum(axis=1)
    assert (np.diff(cls) <= 0).all()                        # largest class first
    assert pb.pair_l == max(max(s[:3].sum(), s[3:].sum()) for s in sums)
    # the unrolled shapes come bra first: pair_shape(bra) <= pair_shape(ket)
    shapes = list(int_t.ERI_PAIR_SHAPES)
    for s in sums:
        bs, ks = (int(int_t.pair_shape(*x)) for x in (s[:3], s[3:]))
        assert bs == (shapes.index(tuple(s[:3])) if tuple(s[:3]) in shapes else -1)
        assert ks == (shapes.index(tuple(s[3:])) if tuple(s[3:]) in shapes else -1)
        assert bs < 0 or ks < 0 or bs <= ks
    assert pb.box == max(int(np.prod(s[:3] + s[3:] + 1)) for s in sums)


def test_pair_shapes_match_the_kernel_list():
    """ERI_PAIR_SHAPES is csrc/eri.cu's ERI_PAIR_SHAPES list, place for place."""
    src = os.path.join(os.path.dirname(int_t.__file__), os.pardir, "csrc", "eri.cu")
    with open(src) as f:
        body = re.search(r"#define ERI_PAIR_SHAPES\(X\)((?:.*\\\n)*.*)", f.read()).group(1)
    listed = [tuple(int(x) for x in m) for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)",
                                                           body)]
    assert listed == [(i, *s) for i, s in enumerate(int_t.ERI_PAIR_SHAPES)]
    assert [int(int_t.pair_shape(*s)) for s in int_t.ERI_PAIR_SHAPES] == list(range(10))


@pytest.mark.parametrize("name,chunk", [("sp", None), ("sp", 5), ("sd", None), ("sd", 2)])
def test_kernel_replay_matches_plain(name, chunk):
    pb, h = _packed(name, chunk)
    want = _plain(name)
    got = _replay(h, pb.chunk, pb.n)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=int_t.ERI_ATOL)
    assert np.array_equal(_replay(h, pb.chunk, pb.n, seed=1), got)   # any arrival order


def test_small_quartets_share_warps_and_big_ones_span_them():
    """The replays above reach both of the kernel's ends: quartets summed
    inside one warp, and quartets whose items span warps, starting at lane 0
    and elsewhere."""
    spans = []
    for name, chunk in (("sp", None), ("sp", 5), ("sd", None), ("sd", 2)):
        pb, h = _packed(name, chunk)
        first, count = h["qitems"][:, 0], h["qitems"][:, 1]
        spans.append((((first + count - 1) >> 5) - (first >> 5), first & 31))
    span, lane = (np.concatenate(x) for x in zip(*spans))
    assert (span == 0).any() and (span >= 2).any()
    assert ((span >= 1) & (lane == 0)).any() and ((span >= 1) & (lane != 0)).any()
