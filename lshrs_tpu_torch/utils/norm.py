"""L2 normalisation (host-side parity helper).

Device code normalises inline with torch; this NumPy version serves the
public API and the host rerank path, with the same zero-vector rejection
contract as the reference (upstream `lshrs/utils/norm.py`).
"""

from __future__ import annotations

import numpy as np


def l2_norm(vector: np.ndarray) -> np.ndarray:
    """Return the unit-length (L2-normalised) copy of a vector.

    Input may be any array-like; it is flattened to 1-D float32.

    Raises:
        ValueError: if the vector has zero Euclidean norm (no direction).
    """
    vec = np.asarray(vector, dtype=np.float32).reshape(-1)
    norm = np.linalg.norm(vec)
    if norm == 0:
        raise ValueError("Cannot normalize zero vector")
    return vec / norm
