"""naqs_tpu_torch: the NAQS-VMC framework in PyTorch, for NVIDIA Hopper.

A port of `naqs_tpu` (JAX) that mirrors its module layout. It imports
neither JAX nor `naqs_tpu`. Entry points run on the CUDA card unless the
caller passes `device="cpu"`; its command line is `python -m
naqs_tpu_torch.cli` (flag for flag with `naqs_tpu.cli`). Its kernels are hand-written CUDA
(`csrc/rank_gather.cu`: the rank engine's psi lookup; `csrc/sort_lookup.cu`:
the sort engine's, for spaces with no rank table, and its whole E_loc call
in one launch where there is no dense A either; `csrc/offdiag_h.cu`: the H
row term by term; `csrc/grid_engine.cu`: the grid engines' accumulation;
`csrc/sampler_step.cu`: the sampler's count split and frontier compaction;
`csrc/eri.cu`: the two-electron integrals of `chem/`, which generates a
molecule's `.npz` from a geometry), built with nvcc on first use;
`csrc/naqs_host.cpp` is the host library (`native.py`), built with g++.
"""

__version__ = "0.1.0"

from naqs_tpu_torch.utils.device import settle_cpu_math

settle_cpu_math()   # before any parallel CPU math: see its docstring

from naqs_tpu_torch.hamiltonian import PauliTerms, compile_pauli_terms  # noqa: F401
from naqs_tpu_torch.models.nade import NAQSConfig  # noqa: F401
from naqs_tpu_torch.sampler import SampleBatch, sample, sample_density  # noqa: F401
from naqs_tpu_torch.trainer import TrainConfig, VMCTrainer  # noqa: F401
from naqs_tpu_torch.utils.hilbert import Hilbert  # noqa: F401
from naqs_tpu_torch.utils.molecule import Molecule, load_molecule  # noqa: F401
