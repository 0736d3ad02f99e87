"""Square roots over Fp and Fp2 (``constantine_tpu/ops/sqrt.py``), batched,
branch-free and without a host read.

``SqrtCtx`` is the reference's: x^((q+1)/4) where q = 3 mod 4 (BLS12-381's
Fp), else the constant-time Tonelli-Shanks of RFC 9380 appendix I.4 with
the same nonresidue and descent (BLS12-381's Fp2: q = p^2 = 9 mod 16,
s = 3), so it returns the reference's root, limb for limb, not merely a
root. Its products go through the field's multiply (K1 on CUDA tensors).

``pow_msb`` and ``sqrt_3mod4`` are K13's plain version (``ops/pallas_g1.py``):
square-and-multiply, most significant bit first, starting from a, over a
given multiply, so the kernel and the plain version make the same products.
"""

from __future__ import annotations

import functools

import torch

from ..utils import refmath as rm
from . import limbs as lb


def pow_msb(mul, a, e: int):
    """a^e (e >= 1), most significant bit first, acc starting at a."""
    acc = a
    for b in bin(e)[3:]:
        acc = mul(acc, acc)
        if b == "1":
            acc = mul(acc, a)
    return acc


def sqrt_3mod4(F, mul, a):
    """(y, is_square) with y = a^((p+1)/4): a root of a when one exists."""
    if F.p_int % 4 != 3:
        raise ValueError(f"{F.name}: p is not 3 mod 4")
    y = pow_msb(mul, a, (F.p_int + 1) // 4)
    return y, lb.eq(mul(y, y), a)


class SqrtCtx:
    """Square roots in a field F of order q: the prime field when q = 3 mod
    4, or the Fp2 tower level with the Tonelli-Shanks nonresidue (c0, c1)."""

    WINDOW = 4       # the Fp2 power's window (the table's products are one launch)

    def __init__(self, F, q: int, nonresidue=None):
        self.F = F
        self.q = q
        t, s = q - 1, 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.s, self.t = s, t
        self.is_3mod4 = q % 4 == 3
        if self.is_3mod4:
            return
        if getattr(F, "deg", 1) != 2:
            raise NotImplementedError("the port's Tonelli-Shanks is over Fp2")
        p, nr = F.F.p_int, -1
        if rm.fp2_pow(nonresidue, (q - 1) // 2, nr, p) == (1, 0):
            raise ValueError(f"{nonresidue} is a square in {F.name}")
        self._c = F.encode(list(rm.fp2_pow(nonresidue, t, nr, p)))
        self._cdev = {}

    def _c_on(self, device):
        device = torch.device(device)
        if device not in self._cdev:
            self._cdev[device] = self._c.to(device)
        return self._cdev[device]

    def sqrt(self, a):
        """(root, is_square) per lane; 0 gives (0, True). A non-square's
        root is whatever the same steps give, as in the reference."""
        F = self.F
        if self.is_3mod4:
            r = F.pow_const(a, (self.q + 1) // 4)
            return r, F.eq(F.square(r), a) | F.is_zero(a)
        z = F.pow_const(a, (self.t - 1) // 2, window=self.WINDOW)     # a^((t-1)/2)
        tt = F.mul(F.square(z), a)                                     # a^t
        z = F.mul(z, a)                                                # a^((t+1)/2)
        b = tt
        c = self._c_on(a.device).expand(a.shape)
        one = F.one(a.shape[:-2], a.device)
        for j in range(self.s - 1):
            bb = b
            for _ in range(self.s - j - 2):
                bb = F.square(bb)
            flag = ~F.eq(bb, one)
            zc, c = F.mul(torch.stack([z, c]), torch.stack([c, c])).unbind(0)
            z = F.cselect(flag, zc, z)
            tt = F.cselect(flag, F.mul(tt, c), tt)
            b = tt
        return z, F.eq(F.square(z), a) | F.is_zero(a)


@functools.lru_cache(maxsize=None)
def get_sqrt_fp(curve_name: str = "BLS12_381") -> SqrtCtx:
    from ..named.precompute import get_curve
    ctx = get_curve(curve_name)
    return SqrtCtx(ctx.fp, ctx.p)


# the reference's candidates for the Fp2 nonresidue, in its order
_FP2_CANDIDATES = ((1, 1), (2, 1), (1, 2), (0, 1), (2, 0), (3, 1))


@functools.lru_cache(maxsize=None)
def get_sqrt_fp2(curve_name: str = "BLS12_381") -> SqrtCtx:
    """Square roots in Fp2, with the reference's nonresidue: the first
    candidate that fails Euler's criterion."""
    from ..named.precompute import get_curve
    from .towers import build_tower
    ctx = get_curve(curve_name)
    p, nr = ctx.p, ctx.params.fp2_nonresidue
    q = p * p
    z = next(c for c in _FP2_CANDIDATES if rm.fp2_pow(c, (q - 1) // 2, nr, p) != (1, 0))
    return SqrtCtx(build_tower(ctx)[0], q, nonresidue=z)
