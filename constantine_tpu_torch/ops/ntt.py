"""Evaluation-domain helpers (the ``bit_reversal_perm`` of
``constantine_tpu/ops/ntt.py``; the NTT itself is ROADMAP.md slice 3)."""

from __future__ import annotations

import numpy as np


def bit_reversal_perm(n: int) -> np.ndarray:
    """Bit-reversal index table for size n = 2^k."""
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev
