"""Training-curve plots with HF/CCSD/FCI/chemical-accuracy reference lines.

Port of `naqs_tpu/utils/plotting.py` (`plot_training`, `plot_wavefunction`);
matplotlib is imported inside the functions, so the package imports without
it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

CHEM_ACC = 1.6e-3  # Ha: chemical accuracy


def plot_training(trainer, molecule=None, window: int = 50, fname: Optional[str] = None):
    """E_loc (raw and its sliding mean), the exact energies where logged, the
    reference energies, and the unique-sample count by step."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_e, ax_n) = plt.subplots(
        2, 1, figsize=(9, 7), sharex=True, height_ratios=[3, 1]
    )

    steps, e_loc = zip(*trainer.log["E_LOC"]) if trainer.log["E_LOC"] else ([], [])
    steps = np.asarray(steps)
    e_loc = np.asarray(e_loc)
    ax_e.plot(steps, e_loc, lw=0.5, alpha=0.4, color="C0", label=r"$\langle E_{loc}\rangle$")
    if window and len(e_loc) > window:
        kernel = np.ones(window) / window
        smooth = np.convolve(e_loc, kernel, "valid")
        ax_e.plot(steps[window - 1:], smooth, lw=1.5, color="C0",
                  label=f"sliding mean ({window})")
    if trainer.log.get("E"):
        es, ev = zip(*[(s, v) for s, v in trainer.log["E"] if v is not None] or [(None, None)])
        if es[0] is not None:
            ax_e.plot(es, ev, "o-", ms=3, lw=1, color="C1", label=r"exact $\langle E\rangle$")

    if molecule is not None:
        if molecule.hf_energy is not None:
            ax_e.axhline(molecule.hf_energy, color="gray", ls=":", lw=1, label="HF")
        if molecule.ccsd_energy is not None:
            ax_e.axhline(molecule.ccsd_energy, color="purple", ls=":", lw=1, label="CCSD")
        if molecule.fci_energy is not None:
            ax_e.axhline(molecule.fci_energy, color="k", ls="-", lw=1, label="FCI")
            ax_e.axhspan(
                molecule.fci_energy, molecule.fci_energy + CHEM_ACC,
                color="green", alpha=0.15, label="chemical accuracy",
            )
            lo = molecule.fci_energy - 0.01
            hi = molecule.hf_energy + 0.05 if molecule.hf_energy else lo + 0.3
            ax_e.set_ylim(lo, hi)
    ax_e.set_ylabel("Energy (Ha)")
    ax_e.legend(loc="upper right", fontsize=8)

    if trainer.log["N_UNIQUE_SAMP"]:
        s2, nu = zip(*trainer.log["N_UNIQUE_SAMP"])
        ax_n.plot(s2, nu, lw=0.8, color="C2")
    ax_n.set_yscale("log")
    ax_n.set_ylabel("unique samples")
    ax_n.set_xlabel("step")

    fig.tight_layout()
    if fname:
        fig.savefig(fname, dpi=150)
    return fig


def plot_wavefunction(amps, phases=None, top_k: int = 50, fname: Optional[str] = None):
    """Bar plot of the top-k amplitudes |psi| (an array or a tensor), log
    scale; `phases` is accepted as in the JAX package and not drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    amps = np.asarray(amps.detach().cpu() if hasattr(amps, "detach") else amps)
    order = np.argsort(amps)[::-1][:top_k]
    fig, ax = plt.subplots(figsize=(9, 3.5))
    ax.bar(np.arange(len(order)), amps[order], color="C0")
    ax.set_ylabel("|psi|")
    ax.set_xlabel("basis state (sorted by amplitude)")
    ax.set_yscale("log")
    fig.tight_layout()
    if fname:
        fig.savefig(fname, dpi=150)
    return fig
