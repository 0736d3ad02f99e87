"""Multi-scalar multiplication entry point and signed-digit recoding.

Counterpart of ``constantine_tpu/ops/msm.py``. This slice carries the
fixed-base (``digits=``) path, which runs the kernel pipeline of
``msm_gpu.py`` on either device. The online path (scalars in, window
combine, GLV) is ROADMAP.md slice 2 and raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as lb
from .msm_gpu import msm_gpu


def _signed_digits(scalars: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(N, NL) canonical 32-bit scalar limbs -> (W, N) int32 signed digits in
    [-2^(c-1), 2^(c-1)]; bucket id = |digit|.

    Same digits as the reference: raw c-bit windows, then the carry chain
    carry_w = g_w | (p_w & carry_{w-1}) (g = raw > half, p = raw == half)
    resolved by a log-depth Kogge-Stone scan.
    """
    if not 1 <= c <= 16:
        raise ValueError("window bits c must be in 1..16")
    N, NL = scalars.shape
    half = 1 << (c - 1)
    full = 1 << c
    dev = scalars.device
    sT = lb.widen(scalars).T                                   # (NL, N) int64
    bit0 = np.arange(n_windows) * c
    li = bit0 // lb.LIMB_BITS
    sh = torch.as_tensor(bit0 % lb.LIMB_BITS, device=dev)[:, None]
    zero = torch.zeros_like(sT[0])
    lo = torch.stack([sT[i] if i < NL else zero for i in li])
    hi = torch.stack([sT[i + 1] if i + 1 < NL else zero for i in li])
    raw = ((lo >> sh) | (hi << (lb.LIMB_BITS - sh))) & (full - 1)   # (W, N)
    g = raw > half
    p = raw == half
    carry = g
    s = 1
    while s < n_windows:
        pad = torch.zeros((s, N), dtype=torch.bool, device=dev)
        shifted = torch.cat([pad, carry[:-s]])
        pacc = torch.cat([pad, p[:-s]])
        carry = carry | (p & shifted)
        p = p & pacc
        s *= 2
    carry_in = torch.cat([torch.zeros((1, N), dtype=torch.bool, device=dev), carry[:-1]])
    return (raw + carry_in.long() - full * carry.long()).to(torch.int32)


def msm(group, points_aff, scalars, c: int = None, digits=None):
    """sum_i d_i P_i over precomputed signed digits (W, N).

    Returns a Jacobian point (batch ()). Only the fixed-base path
    (`digits` given, as PrecomputedMSM calls it) is in this slice.
    """
    if digits is None:
        raise NotImplementedError(
            "the online MSM (scalars in: window combine kernel K7 and GLV) is "
            "ROADMAP.md slice 2; this slice runs the fixed-base digits= path")
    if c is None:
        raise ValueError("msm with digits= needs the window bits c")
    return msm_gpu(group, points_aff, digits, c)
