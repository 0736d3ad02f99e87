"""Square roots in Fp for p = 3 mod 4 (G1 part of
``constantine_tpu/ops/sqrt.py``): y = a^((p+1)/4) and the is-square check.

Written as K13's plain version sees it (``ops/pallas_g1.py``): the power is
square-and-multiply, most significant bit first, starting from a, over a
given multiply, so the kernel and this function make the same multiplies.
"""

from __future__ import annotations

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
