"""Molecule data from a geometry: basis, integrals (the ERIs on the card),
RHF/ROHF, MP2, CCSD, FCI baselines and the `.npz` writer; port of
`naqs_tpu.chem`. `python -m naqs_tpu_torch.chem.generate` is its command line."""
