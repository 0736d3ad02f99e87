"""Host reference math over python ints (own copy of the G1 part of
``constantine_tpu/utils/refmath.py``).

Slow and plainly correct: used to validate constants, to decompress the
trusted setup on the host, and as the oracle of the tests. Never on the
device path. Points are affine (x, y) tuples, or None for infinity.
"""

from __future__ import annotations


def inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def sqrt_mod(a: int, p: int):
    """A square root of a mod p (Tonelli-Shanks), or None for a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    s, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def ec_add(P, Q, a: int, p: int):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) * inv_mod(2 * y1, p) % p
    else:
        lam = (y2 - y1) * inv_mod(x2 - x1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_double(P, a: int, p: int):
    return ec_add(P, P, a, p)


def ec_mul(k: int, P, a: int, p: int):
    R = None
    Q = P
    while k:
        if k & 1:
            R = ec_add(R, Q, a, p)
        Q = ec_add(Q, Q, a, p)
        k >>= 1
    return R


def ec_neg(P, p: int):
    return None if P is None else (P[0], (-P[1]) % p)


def ec_is_on_curve(P, a: int, b: int, p: int) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - (x * x * x + a * x + b)) % p == 0
