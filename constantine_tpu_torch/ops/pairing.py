"""The BLS12-381 optimal-ate pairing (``constantine_tpu/ops/pairing.py``,
``BLSPairing``, and the engine API of ``ops/pallas_pairing.py``).

The Miller loop runs in K11 and the final exponentiation in K12
(``cuda_pairing.py``: the kernels on CUDA tensors, their plain versions on
CPU tensors); ``multi_pairing`` masks skipped pairs to one, multiplies the
Miller values in a log tree (Fp12 products through the K1 towers) and runs
one final exponentiation. BN254, ``MillerAccumulator`` and the reference's
padding of the batch to power-of-two buckets are not ported.
"""

from __future__ import annotations

import functools

import torch

from .cuda_pairing import CudaPairing
from .towers import build_tower


class BLSPairing:
    def __init__(self, ctx):
        p, x, r = ctx.p, ctx.params.x_param, ctx.r
        # the hard part computes f^(3h), h = (p^4 - p^2 + 1)/r, as
        # (x-1)^2 (x+p) (x^2+p^2-1) + 3 (gcd(3, r) = 1: checks are unaffected)
        if 3 * ((p**4 - p**2 + 1) // r) != (x - 1) ** 2 * (x + p) * (x**2 + p**2 - 1) + 3:
            raise ValueError(f"{ctx.name}: BLS12 final-exponentiation decomposition")
        self.ctx = ctx
        self.fp2, self.fp6, self.fp12 = build_tower(ctx)
        self.engine = CudaPairing(ctx)

    def miller_loop(self, p_aff, q_aff):
        """P ((B, NL) x 2), Q ((B, 2, NL) x 2) affine Montgomery -> (B, 12, NL)."""
        return self.engine.miller_loop(p_aff, q_aff)

    def final_exp(self, f):
        return self.engine.final_exp(f)

    def pairing(self, p_aff, q_aff):
        """e(P_i, Q_i) per lane, (B, 12, NL)."""
        return self.final_exp(self.miller_loop(p_aff, q_aff))

    def multi_pairing(self, p_aff, q_aff, skip_mask=None):
        """prod_i e(P_i, Q_i), (12, NL); skipped pairs contribute one."""
        fp12 = self.fp12
        fs = self.miller_loop(p_aff, q_aff)
        if skip_mask is not None:
            fs = fp12.cselect(skip_mask, fp12.one(fs.shape[:1], fs.device), fs)
        while fs.shape[0] > 1:
            h = fs.shape[0] // 2
            head = fp12.mul(fs[:h], fs[h:2 * h])
            fs = torch.cat([head, fs[2 * h:]]) if fs.shape[0] % 2 else head
        return self.final_exp(fs)[0]

    def pairing_check(self, p_aff, q_aff, skip_mask=None) -> bool:
        """prod_i e(P_i, Q_i) == 1."""
        gt = self.multi_pairing(p_aff, q_aff, skip_mask)
        return bool(self.fp12.eq(gt, self.fp12.one((), gt.device)))


@functools.lru_cache(maxsize=None)
def get_pairing(curve_name: str = "BLS12_381") -> BLSPairing:
    from ..named.precompute import get_curve
    return BLSPairing(get_curve(curve_name))
