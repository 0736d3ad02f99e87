"""Carry-over of data between the JAX package's layout and the port's.

The reference stores field elements as (..., 2n) u32 arrays of 16-bit
digits; the port as (..., n) int32 tensors of 32-bit limbs with the same
Montgomery R, so the values are bit-identical and converting is the
reference's own ``_pack16`` (digit 2i in the low half of limb i). This
turns the reference's arrays -- ``KZGSettings.g1_lagrange_brp``, the setup
cache's ``lx``/``ly`` -- into port tensors, and back for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.trusted_setup import DEFAULT_SETUP
from .ops import limbs as lb


def from_reference(digits, device="cpu") -> torch.Tensor:
    """Reference (..., 2n) 16-bit digits (numpy or array-like) -> int32 limbs."""
    return lb.to_tensor(lb.pack16(np.asarray(digits, np.uint32)), device)


def to_reference(limbs: torch.Tensor) -> np.ndarray:
    """Port int32 (..., n) limbs -> reference (..., 2n) u32 16-bit digits."""
    return lb.unpack16(lb.to_numpy(limbs))


def load_npz_lagrange(path: str = DEFAULT_SETUP + ".cache.npz", device="cpu"):
    """The reference's decompressed setup cache -> brp Lagrange (x, y)
    tensors (4096, 12), Montgomery form (numpy only, no JAX)."""
    with np.load(path) as z:
        return from_reference(z["lx"], device), from_reference(z["ly"], device)
