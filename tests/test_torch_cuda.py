"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA card: a CUDA kernel has no CPU mode. Imports nothing
of JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import naqs_tpu_torch as nt
from naqs_tpu_torch.ops.dyn_gather import rank_gather2, rank_gather2_ref
from naqs_tpu_torch.ops.rank import RankSpec, build_value_table

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("sectors,n_qubits,n_rows,n_cols", [
    (((5, 5),), 14, 400, 256),
    (((5, 3), (4, 4), (3, 5)), 14, 77, 1000),   # ragged shapes, three sectors
    (((5, 5),), 26, 512, 4608),                 # H2O 6-31G table, main-path chunk
])
def test_rank_gather2_kernel_matches_plain(sectors, n_qubits, n_rows, n_cols):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    h = nt.Hilbert(n_qubits=n_qubits, sectors=sectors)
    spec = RankSpec.for_hilbert(h)
    rng = np.random.default_rng(0)
    pool = h.basis if h.size < 10**6 else h.basis[rng.choice(h.size, 200_000, replace=False)]
    states = np.sort(rng.choice(pool, size=min(len(pool), 50_000), replace=False))
    la = -rng.uniform(0, 3, size=len(states)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, size=len(states)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    tabs = build_value_table(spec, t(states), t(la), t(ph), len(states))
    s = t(states[:n_rows])
    xy = t(rng.integers(0, 2 ** n_qubits, size=n_cols).astype(np.int64))
    before = rank_gather2.launches
    got = rank_gather2(spec, s, xy, *tabs)
    torch.cuda.synchronize()
    assert rank_gather2.launches == before + 1
    want = rank_gather2_ref(spec, s, xy, *tabs)
    for g, w in zip(got, want):
        assert g.shape == (n_rows, n_cols) and torch.equal(g, w)


def test_rank_gather2_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    spec = RankSpec.for_hilbert(nt.Hilbert(n_qubits=14, sectors=((5, 5),)))
    tab = torch.zeros(spec.size + 1, device=dev)
    s = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        rank_gather2(spec, s.int(), s, tab, tab)
    with pytest.raises(ValueError):
        rank_gather2(spec, s, s, tab[:-1], tab[:-1])
    with pytest.raises(ValueError):
        rank_gather2(spec, s, s.cpu(), tab, tab)
