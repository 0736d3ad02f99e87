"""G1 subgroup membership (G1 part of ``constantine_tpu/ops/subgroups.py``):
Scott's test phi(P) == [-u^2]P, phi(x, y) = (beta x, y) with beta the cube
root of unity of eigenvalue -u^2 mod r (eprint 2021/1130).

Written as K13's plain version sees it (``ops/pallas_g1.py``): one
double-and-add ladder over the bits of u^2 after its leading one (the
reference's XLA form runs two |u| ladders; the points are the same), then
the Jacobian comparison of (beta x, y, 1) with -[u^2]P, cross-multiplied.
"""

from __future__ import annotations

import functools

from ..utils import refmath as rm
from . import limbs as lb
from .cuda_ec import ec_double, ec_madd


@functools.lru_cache(maxsize=None)
def scott_beta(p: int, r: int, u: int, g):
    """The cube root of unity beta in Fp with (beta gx, gy) == [-u^2 mod r]G."""
    from .glv import cube_roots_of_unity
    target = rm.ec_mul((-u * u) % r, g, 0, p)
    for beta in cube_roots_of_unity(p):
        if target == (beta * g[0] % p, g[1]):
            return beta
    raise ValueError("no cube root of unity has eigenvalue -u^2")


def ladder_u2(F, mul, x, y, u2: int):
    """[u2]P for affine P = (x, y) (Montgomery), Jacobian, MSB first."""
    one = F.broadcast_one(x.shape[:-1], x.device)
    T = (x, y, one)
    for b in bin(u2)[3:]:
        T = ec_double(F, mul, T)
        if b == "1":
            T = ec_madd(F, mul, T, (x, y))
    return T


def is_in_subgroup_g1(F, mul, beta_mont, x, y, u: int):
    """Bool mask: affine on-curve points (x, y) in G1."""
    X, Y, Z = ladder_u2(F, mul, x, y, u * u)
    Z2 = mul(Z, Z)
    ex = lb.eq(mul(mul(beta_mont.expand_as(x), x), Z2), X)
    ey = lb.eq(mul(mul(y, Z), Z2), F.neg(Y))
    return ex & ey & ~lb.is_zero(Z)
