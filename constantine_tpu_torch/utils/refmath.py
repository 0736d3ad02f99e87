"""Host reference math over python ints (own copy of the G1, Fp2 and G2
parts of ``constantine_tpu/utils/refmath.py``).

Slow and plainly correct: used to validate constants, to decompress the
trusted setup on the host, to build the verifier's fixed-base tables, and as
the oracle of the tests. Never on the device path. Points are affine (x, y)
tuples, or None for infinity; an Fp2 element is a pair (c0, c1) = c0 + c1*u
with u^2 = nr.
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


# -- GF(p^2) as pairs (c0, c1) with u^2 = nr -----------------------------------


def fp2_mul(x, y, nr: int, p: int):
    a0, a1 = x
    b0, b1 = y
    return ((a0 * b0 + nr * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)


def fp2_add(x, y, p: int):
    return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)


def fp2_sub(x, y, p: int):
    return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)


def fp2_neg(x, p: int):
    return ((-x[0]) % p, (-x[1]) % p)


def fp2_inv(x, nr: int, p: int):
    a0, a1 = x
    di = inv_mod((a0 * a0 - nr * a1 * a1) % p, p)
    return (a0 * di % p, (-a1) * di % p)


def fp2_pow(x, e: int, nr: int, p: int):
    r, b = (1, 0), x
    while e:
        if e & 1:
            r = fp2_mul(r, b, nr, p)
        b = fp2_mul(b, b, nr, p)
        e >>= 1
    return r


def fp2_sqrt(v, nr: int, p: int):
    """A square root of v in Fp2 (u^2 = nr), or None for a non-square:
    y0^2 = (c0 + sqrt(norm)) / 2, y1 = c1 / (2 y0)."""
    c0, c1 = v[0] % p, v[1] % p
    if c1 == 0:
        y0 = sqrt_mod(c0, p)
        if y0 is not None:
            return (y0, 0)
        y1 = sqrt_mod(c0 * inv_mod(nr % p, p) % p, p)
        return None if y1 is None else (0, y1)
    sn = sqrt_mod((c0 * c0 - nr * c1 * c1) % p, p)
    if sn is None:
        return None
    inv2 = inv_mod(2, p)
    for s in (sn, p - sn):
        y0 = sqrt_mod((c0 + s) * inv2 % p, p)
        if y0:
            y = (y0, c1 * inv_mod(2 * y0, p) % p)
            if fp2_mul(y, y, nr, p) == (c0, c1):
                return y
    return None


# -- the group law over GF(p^2) (G2 on the twist) -------------------------------


def ec2_add(P, Q, a2, nr: int, p: int):
    """Affine P + Q over GF(p^2); a2 is the curve's Fp2 'a' coefficient."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if fp2_add(y1, y2, p) == (0, 0):
            return None
        num = fp2_add(fp2_mul((3, 0), fp2_mul(x1, x1, nr, p), nr, p), a2, p)
        den = fp2_mul((2, 0), y1, nr, p)
    else:
        num = fp2_sub(y2, y1, p)
        den = fp2_sub(x2, x1, p)
    lam = fp2_mul(num, fp2_inv(den, nr, p), nr, p)
    x3 = fp2_sub(fp2_sub(fp2_mul(lam, lam, nr, p), x1, p), x2, p)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3, p), nr, p), y1, p)
    return (x3, y3)


def ec2_mul(k: int, P, a2, nr: int, p: int):
    R = None
    Q = P
    while k:
        if k & 1:
            R = ec2_add(R, Q, a2, nr, p)
        Q = ec2_add(Q, Q, a2, nr, p)
        k >>= 1
    return R


def ec2_neg(P, p: int):
    return None if P is None else (P[0], fp2_neg(P[1], p))


def ec2_is_on_curve(P, b2, nr: int, p: int) -> bool:
    """y^2 == x^3 + b2 over GF(p^2) (a = 0)."""
    if P is None:
        return True
    x, y = P
    return fp2_mul(y, y, nr, p) == fp2_add(fp2_mul(x, fp2_mul(x, x, nr, p), nr, p), b2, p)
