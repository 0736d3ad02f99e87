"""Subgroup membership (``constantine_tpu/ops/subgroups.py``), Scott's tests
(eprint 2021/1130). G1: phi(P) == [-u^2]P, phi(x, y) = (beta x, y) with
beta the cube root of unity of eigenvalue -u^2 mod r. G2 (BLS12-381):
psi(Q) == [u]Q, psi the untwist-Frobenius-twist endomorphism of
``models/hash_to_curve.py``, over ``ladder_const`` and ``G2Group.eq``.
The scalars are public curve constants.

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


def ladder_const(group, P, k: int):
    """[k]P for a public k >= 1: double-and-add from P, most significant bit
    first, an add only at the set bits (the reference's ``_ladder_const``)."""
    if k < 1:
        raise ValueError("ladder_const takes k >= 1")
    acc = P
    for b in bin(k)[3:]:
        acc = group.double(acc)
        if b == "1":
            acc = group.add(acc, P)
    return acc


def is_in_subgroup_g2(ctx, Q):
    """Bool mask: Jacobian on-curve G2 points Q in G2 (BLS12-381)."""
    from ..models.hash_to_curve import get_h2c
    if ctx.name != "BLS12_381":
        raise NotImplementedError("the port's G2 check is BLS12-381's")
    group, u = ctx.g2, ctx.params.x_param
    t = ladder_const(group, Q, abs(u))
    if u < 0:
        t = group.neg(t)
    return group.eq(get_h2c().psi(Q), t)
