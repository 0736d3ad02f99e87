"""A host big-int oracle for the port's hash-to-curve and BLS signatures
(RFC 9380, python ints over ``constantine_tpu_torch.utils.refmath``).

hash_to_g1 and hash_to_g2 as the RFC writes them: SSWU on E' with its sgn0,
the isogeny, and cofactor clearing by a multiplication by h_eff (section
8.8), not by the Budroni-Pintore formula the port uses; compressed pubkeys
and signatures from refmath ladders. The tests and ``chip_smoke.py`` hold
the port against it. It imports no test framework and changes no global
state on import.
"""

from constantine_tpu_torch.models.hash_to_curve import hash_to_field
from constantine_tpu_torch.named import h2c_constants as HC
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.utils import refmath as rm
from constantine_tpu_torch.utils.serialization import g1_compress_affine

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
NR = -1
INF_G1 = bytes([0xC0]) + bytes(47)
INF_G2 = bytes([0xC0]) + bytes(95)
# RFC 9380 section 8.8: the effective cofactors of BLS12-381 G1 and G2
H_EFF_G1 = 0xd201000000010001
H_EFF_G2 = int(
    "bc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe1329c2f178731db956d82bf015"
    "d1212b02ec0ec69d7477c1ae954cbc06689f6a359894c0adebbf6b4e8020005aaa95551", 16)


def sgn0(v) -> int:
    """RFC 9380 sgn0 of an int (m = 1) or an (c0, c1) pair (m = 2)."""
    if isinstance(v, int):
        return v & 1
    return (v[0] & 1) | (int(v[0] == 0) & (v[1] & 1))


class HostFp:
    def __init__(self, p):
        self.p = p

    def mul(self, a, b):
        return a * b % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def neg(self, a):
        return -a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def sqrt(self, a):
        return rm.sqrt_mod(a, self.p)


class HostFp2(HostFp):
    def mul(self, a, b):
        return rm.fp2_mul(a, b, NR, self.p)

    def add(self, a, b):
        return rm.fp2_add(a, b, self.p)

    def neg(self, a):
        return rm.fp2_neg(a, self.p)

    def inv(self, a):
        return rm.fp2_inv(a, NR, self.p)

    def sqrt(self, a):
        return rm.fp2_sqrt(a, NR, self.p)


def map_to_curve_host(H, u, A, B, Z, maps):
    """Simplified SWU (RFC 9380 6.6.2) onto E', then the isogeny to E."""
    one = 1 if isinstance(u, int) else (1, 0)
    zero = 0 if isinstance(u, int) else (0, 0)
    Zu2 = H.mul(Z, H.mul(u, u))
    den = H.add(H.mul(Zu2, Zu2), Zu2)
    if den == zero:
        x1 = H.mul(B, H.inv(H.mul(Z, A)))
    else:
        x1 = H.mul(H.neg(H.mul(B, H.inv(A))), H.add(one, H.inv(den)))

    def g(x):
        return H.add(H.add(H.mul(H.mul(x, x), x), H.mul(A, x)), B)

    x, y = x1, H.sqrt(g(x1))
    if y is None:
        x = H.mul(Zu2, x1)
        y = H.sqrt(g(x))
    if sgn0(u) != sgn0(y):
        y = H.neg(y)

    def horner(cs):
        acc = cs[-1]
        for c in reversed(cs[:-1]):
            acc = H.add(H.mul(acc, x), c)
        return acc

    xn, xd, yn, yd = (horner(c) for c in maps)
    return H.mul(xn, H.inv(xd)), H.mul(y, H.mul(yn, H.inv(yd)))


def oracle_hash_to_g2(msg: bytes, dst: bytes = DST):
    """hash_to_curve for BLS12381G2_XMD:SHA-256_SSWU_RO_: affine ((x0, x1),
    (y0, y1)), cleared by [h_eff]."""
    p = get_curve("BLS12_381").p
    us = hash_to_field([msg], dst, 2, 2, p)[0]
    maps = (HC.G2_ISO_XNUM, HC.G2_ISO_XDEN, HC.G2_ISO_YNUM, HC.G2_ISO_YDEN)
    Q0, Q1 = (map_to_curve_host(HostFp2(p), tuple(u), HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z, maps)
              for u in us)
    return rm.ec2_mul(H_EFF_G2, rm.ec2_add(Q0, Q1, (0, 0), NR, p), (0, 0), NR, p)


def oracle_hash_to_g1(msg: bytes, dst: bytes):
    p = get_curve("BLS12_381").p
    us = hash_to_field([msg], dst, 2, 1, p)[0]
    maps = (HC.G1_ISO_XNUM, HC.G1_ISO_XDEN, HC.G1_ISO_YNUM, HC.G1_ISO_YDEN)
    Q0, Q1 = (map_to_curve_host(HostFp(p), u[0], HC.G1_SSWU_A, HC.G1_SSWU_B, HC.G1_SSWU_Z, maps)
              for u in us)
    return rm.ec_mul(H_EFF_G1, rm.ec_add(Q0, Q1, 0, p), 0, p)


def g2_compress_host(P) -> bytes:
    """Host affine G2 point (or None) -> 96 compressed bytes (x.c1 || x.c0)."""
    if P is None:
        return INF_G2
    p = get_curve("BLS12_381").p
    (x0, x1), (y0, y1) = P
    big = (y1 if y1 else y0) >= (p + 1) // 2
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if big else 0)
    return bytes(out)


def host_pubkeys(sks) -> bytes:
    ctx = get_curve("BLS12_381")
    return b"".join(g1_compress_affine(rm.ec_mul(k, ctx.g, 0, ctx.p)) for k in sks)


def host_sign(sks, msgs) -> bytes:
    ctx = get_curve("BLS12_381")
    return b"".join(g2_compress_host(rm.ec2_mul(k, oracle_hash_to_g2(m), (0, 0), NR, ctx.p))
                    for k, m in zip(sks, msgs))


# ---------------------------------------------------------------------------
# EIP-2537 (BLS12-381 precompiles) on the host: the EIP's encodings and
# checks, the group law, MSMs and maps over refmath, [h_eff] clearing. Bytes
# in, bytes out, None where the EIP reverts.
# ---------------------------------------------------------------------------


def _fp(chunk: bytes):
    p = get_curve("BLS12_381").p
    if len(chunk) != 64 or any(chunk[:16]):
        return None
    v = int.from_bytes(chunk[16:], "big")
    return v if v < p else None


def fp_bytes(v: int) -> bytes:
    return bytes(16) + v.to_bytes(48, "big")


def g1_bytes(P) -> bytes:
    return bytes(128) if P is None else fp_bytes(P[0]) + fp_bytes(P[1])


def g2_bytes(Q) -> bytes:
    if Q is None:
        return bytes(256)
    (x0, x1), (y0, y1) = Q
    return fp_bytes(x0) + fp_bytes(x1) + fp_bytes(y0) + fp_bytes(y1)


def _g1(data: bytes, subgroup: bool):
    """128 bytes -> (ok, point or None for infinity)."""
    ctx = get_curve("BLS12_381")
    x, y = _fp(data[:64]), _fp(data[64:128])
    if x is None or y is None:
        return False, None
    if x == 0 and y == 0:
        return True, None
    P = (x, y)
    if not rm.ec_is_on_curve(P, 0, ctx.b, ctx.p):
        return False, None
    if subgroup and rm.ec_mul(ctx.r, P, 0, ctx.p) is not None:
        return False, None
    return True, P


def _g2(data: bytes, subgroup: bool):
    ctx = get_curve("BLS12_381")
    vals = [_fp(data[64 * i:64 * (i + 1)]) for i in range(4)]
    if any(v is None for v in vals):
        return False, None
    if not any(vals):
        return True, None
    Q = ((vals[0], vals[1]), (vals[2], vals[3]))
    if not rm.ec2_is_on_curve(Q, ctx.g2_b(), NR, ctx.p):
        return False, None
    if subgroup and rm.ec2_mul(ctx.r, Q, (0, 0), NR, ctx.p) is not None:
        return False, None
    return True, Q


def oracle_g1add(data: bytes):
    p = get_curve("BLS12_381").p
    if len(data) != 256:
        return None
    (ok1, P), (ok2, Q) = _g1(data[:128], False), _g1(data[128:], False)
    return g1_bytes(rm.ec_add(P, Q, 0, p)) if ok1 and ok2 else None


def oracle_g2add(data: bytes):
    p = get_curve("BLS12_381").p
    if len(data) != 512:
        return None
    (ok1, P), (ok2, Q) = _g2(data[:256], False), _g2(data[256:], False)
    return g2_bytes(rm.ec2_add(P, Q, (0, 0), NR, p)) if ok1 and ok2 else None


def oracle_g1msm(data: bytes):
    p = get_curve("BLS12_381").p
    if not data or len(data) % 160:
        return None
    acc = None
    for i in range(0, len(data), 160):
        ok, P = _g1(data[i:i + 128], True)
        if not ok:
            return None
        k = int.from_bytes(data[i + 128:i + 160], "big")
        acc = rm.ec_add(acc, None if P is None else rm.ec_mul(k, P, 0, p), 0, p)
    return g1_bytes(acc)


def oracle_g2msm(data: bytes):
    p = get_curve("BLS12_381").p
    if not data or len(data) % 288:
        return None
    acc = None
    for i in range(0, len(data), 288):
        ok, Q = _g2(data[i:i + 256], True)
        if not ok:
            return None
        k = int.from_bytes(data[i + 256:i + 288], "big")
        acc = rm.ec2_add(acc, None if Q is None else rm.ec2_mul(k, Q, (0, 0), NR, p),
                         (0, 0), NR, p)
    return g2_bytes(acc)


def oracle_pairing_inputs_ok(data: bytes) -> bool:
    """The pairing check's input checks (the product itself has no host
    oracle here: the tests build inputs whose product they know)."""
    if not data or len(data) % 384:
        return False
    return all(_g1(data[i:i + 128], True)[0] and _g2(data[i + 128:i + 384], True)[0]
               for i in range(0, len(data), 384))


def oracle_map_fp_to_g1(data: bytes):
    p = get_curve("BLS12_381").p
    u = _fp(data) if len(data) == 64 else None
    if u is None:
        return None
    maps = (HC.G1_ISO_XNUM, HC.G1_ISO_XDEN, HC.G1_ISO_YNUM, HC.G1_ISO_YDEN)
    P = map_to_curve_host(HostFp(p), u, HC.G1_SSWU_A, HC.G1_SSWU_B, HC.G1_SSWU_Z, maps)
    return g1_bytes(rm.ec_mul(H_EFF_G1, P, 0, p))


def oracle_map_fp2_to_g2(data: bytes):
    p = get_curve("BLS12_381").p
    u = (_fp(data[:64]), _fp(data[64:])) if len(data) == 128 else (None, None)
    if None in u:
        return None
    maps = (HC.G2_ISO_XNUM, HC.G2_ISO_XDEN, HC.G2_ISO_YNUM, HC.G2_ISO_YDEN)
    Q = map_to_curve_host(HostFp2(p), u, HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z, maps)
    return g2_bytes(rm.ec2_mul(H_EFF_G2, Q, (0, 0), NR, p))
