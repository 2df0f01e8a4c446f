"""Single-qubit measurement-basis rotations over packed states.

Port of `naqs_tpu/utils/unitaries.py` on the port's int64 packed states
(SENTINEL = INT64_MAX is never a state here): expands a state measured with
some qubits rotated into the X or Y basis into the computational-basis
superposition it represents.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# single-qubit change-of-basis rows: basis[b] of H/S^dagger-H acting on |b>
_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)  # X basis
_SH = np.array([[1, 1], [1j, -1j]], dtype=np.complex128).conj().T / np.sqrt(2)  # Y


def rotate_state(
    state: int, bases: Dict[int, str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a packed state measured in rotated bases.

    bases: {qubit: 'X'|'Y'|'Z'}; Z entries are ignored. Returns
    (states, amplitudes): the 2^k computational-basis states (int64, sorted)
    and their complex amplitudes, where k is the number of rotated qubits.
    """
    rot = [(q, b) for q, b in sorted(bases.items()) if b in ("X", "Y")]
    states = np.array([state], dtype=np.int64)
    amps = np.array([1.0 + 0j])
    for q, b in rot:
        if not 0 <= q < 63:
            raise ValueError(f"qubit {q} outside the int64 packed state's 63 bits")
        u = _H if b == "X" else _SH
        bit = np.int64(1) << np.int64(q)
        measured = ((states & bit) != 0).astype(int)
        base0 = states & ~bit
        states = np.concatenate([base0, base0 | bit])
        amps = np.concatenate([amps * u[measured, 0], amps * u[measured, 1]])
    order = np.argsort(states)
    return states[order], amps[order]
