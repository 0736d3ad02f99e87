"""Multi-scalar multiplication entry point and signed-digit recoding.

Counterpart of ``constantine_tpu/ops/msm.py``. Both the online path (scalars
in, with the GLV split on G1 by default) and the fixed-base path (``digits=``,
as PrecomputedMSM calls it) run the kernel pipeline of ``msm_gpu.py``, on
either device: the reference's XLA flat formulation is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from .msm_gpu import msm_gpu


def _signed_digits(scalars: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(N, NL) canonical 32-bit scalar limbs -> (W, N) int32 signed digits in
    [-2^(c-1), 2^(c-1)]; bucket id = |digit|.

    Same digits as the reference: raw c-bit windows, then the carry chain
    carry_w = g_w | (p_w & carry_{w-1}) (g = raw > half, p = raw == half)
    resolved by a log-depth Kogge-Stone scan. Windows past the limbs read 0.
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


@functools.lru_cache(maxsize=None)
def _glv_for_group(group_name: str):
    """GLV context for an ECGroup named '<curve>.G1', else None. A G1 curve
    whose GLV fails to build raises (the reference swallows that)."""
    if not group_name.endswith(".G1"):
        return None
    from .glv import get_glv
    return get_glv(group_name[: -len(".G1")])


def _apply_glv(group, glv_ctx, points_aff, scalars):
    """N points x b-bit scalars -> 2N points x (b/2)-bit scalars."""
    k1, n1, k2, n2 = glv_ctx.decompose(scalars)
    px, py = points_aff
    P1 = group.aff_cneg(n1, (px, py))
    P2 = group.aff_cneg(n2, glv_ctx.endo((px, py)))
    pts = tuple(torch.cat([a, b]) for a, b in zip(P1, P2))
    return pts, torch.cat([k1, k2]), glv_ctx.mini_bits


def msm(group, points_aff, scalars, c: int = None, scalar_bits: int = None,
        digits=None, glv: bool = None):
    """sum_i scalars[i] * P_i. Returns a Jacobian point (batch ()).

    points_aff: (x, y) (N, NL) affine Montgomery coordinates; scalars: (N,
    NL_r) canonical limbs, or None with `digits` (W, N) precomputed signed
    c-bit digits. glv=None splits by the endomorphism on G1 when digits is
    None; scalar_bits bounds the scalars (default all their limbs' bits).
    """
    pts = tuple(points_aff)
    if glv is None:
        glv = digits is None
    if glv and digits is None and scalars is not None:
        glv_ctx = _glv_for_group(group.name)
        if glv_ctx is not None:
            pts, scalars, scalar_bits = _apply_glv(group, glv_ctx, pts, scalars)
    return msm_gpu(group, pts, scalars, c=c, scalar_bits=scalar_bits, digits=digits)
