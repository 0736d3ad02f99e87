"""Hash-to-curve for BLS12-381 (RFC 9380): expand_message_xmd, the SSWU maps
with their isogenies, and cofactor clearing, batched over messages.

Counterpart of ``constantine_tpu/models/hash_to_curve.py`` (the BLS12-381
G1 and G2 suites; the SVDW map and BN254 wait). Message expansion runs on
the host with ``hashlib`` for every batch size (the reference's batched
JAX SHA-256 is not ported); the field work runs batched on the device, its
products K1 launches on CUDA tensors and its inversions K9. hash_to_g2
maps the 2n field elements of n messages in one batch, as the reference
does. G2 cofactor clearing is Budroni-Pintore, P -> [x^2 - x - 1]P +
[x - 1]psi(P) + psi^2([2]P), which equals the RFC's [h_eff]P.

The ladders by |x| run over a public constant: on G1 one ``ec_scalar_mul``
launch, on G2 double-and-add over the set bits of |x| with the public
form of ``G2Group.add``. Their Jacobian limbs differ from the reference's
constant-time ladder; the affine points are the same.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from ..named import h2c_constants as HC
from ..named.precompute import get_curve
from ..ops.sqrt import get_sqrt_fp, get_sqrt_fp2
from ..ops.subgroups import ladder_const
from ..ops.towers import build_tower
from ..utils import refmath as rm
from ..utils.hashes import sha256


# ---------------------------------------------------------------------------
# expand_message_xmd and hash_to_field (host, RFC 9380 section 5)
# ---------------------------------------------------------------------------


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        raise ValueError("DST longer than 255 bytes")
    ell = -(-len_in_bytes // 32)
    if ell > 255:
        raise ValueError("expand_message_xmd: len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    msg_prime = bytes(64) + msg + len_in_bytes.to_bytes(2, "big") + b"\x00" + dst_prime
    b0 = sha256(msg_prime)
    bs = [sha256(b0 + b"\x01" + dst_prime)]
    for i in range(2, ell + 1):
        bs.append(sha256(bytes(a ^ b for a, b in zip(b0, bs[-1])) + bytes([i]) + dst_prime))
    return b"".join(bs)[:len_in_bytes]


def hash_to_field(msgs, dst: bytes, count: int, m: int, p: int):
    """For each message, `count` elements of GF(p^m) as nested python ints
    [n_msgs][count][m] (L = 64 bytes an Fp coefficient)."""
    L = 64
    out = []
    for msg in msgs:
        uniform = expand_message_xmd(msg, dst, count * m * L)
        out.append([[int.from_bytes(uniform[L * (j + i * m):L * (j + i * m + 1)], "big") % p
                     for j in range(m)] for i in range(count)])
    return out


# ---------------------------------------------------------------------------
# host arithmetic of the map constants
# ---------------------------------------------------------------------------


class _HostFp:
    def __init__(self, p):
        self.p = p

    def mul(self, a, b):
        return a * b % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def neg(self, a):
        return -a % self.p

    def inv(self, a):
        return rm.inv_mod(a, self.p)

    def sqrt(self, a):
        return rm.sqrt_mod(a, self.p)


class _HostFp2:
    def __init__(self, p, nr):
        self.p, self.nr = p, nr

    def mul(self, a, b):
        return rm.fp2_mul(a, b, self.nr, self.p)

    def add(self, a, b):
        return rm.fp2_add(a, b, self.p)

    def neg(self, a):
        return rm.fp2_neg(a, self.p)

    def inv(self, a):
        return rm.fp2_inv(a, self.nr, self.p)

    def sqrt(self, a):
        return rm.fp2_sqrt(a, self.nr, self.p)


def _horner_host(H, coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = H.add(H.mul(acc, x), c)
    return acc


def _check_isogeny(H, A, B, b_target, maps, x0):
    """Host check that the isogeny sends points of E': y^2 = x^3 + A x + B
    onto E: y^2 = x^3 + b: the first two points of E' from x0 upward."""
    xnum, xden, ynum, yden = maps
    found, x = 0, x0
    while found < 2:
        rhs = H.add(H.add(H.mul(H.mul(x, x), x), H.mul(A, x)), B)
        y = H.sqrt(rhs)
        if y is not None:
            X = H.mul(_horner_host(H, xnum, x), H.inv(_horner_host(H, xden, x)))
            Y = H.mul(y, H.mul(_horner_host(H, ynum, x), H.inv(_horner_host(H, yden, x))))
            if H.mul(Y, Y) != H.add(H.mul(H.mul(X, X), X), b_target):
                raise ValueError("the isogeny does not map E' onto E")
            found += 1
        x = H.add(x, x0)


# ---------------------------------------------------------------------------
# SSWU + isogeny over Fp or Fp2
# ---------------------------------------------------------------------------


class SSWUMap:
    """Simplified SWU onto the isogenous curve E', then the isogeny to E.

    F: the Field (Fp) or the Fp2 tower level; H: the host arithmetic of
    the same field; constants as host values (ints, or (c0, c1) pairs).
    """

    def __init__(self, F, sqrt_ctx, H, A, B, Z, iso_xnum, iso_xden, iso_ynum, iso_yden,
                 b_target):
        self.F = F
        self.sq = sqrt_ctx
        self.deg = getattr(F, "deg", 1)
        maps = (iso_xnum, iso_xden, iso_ynum, iso_yden)
        _check_isogeny(H, A, B, b_target, maps, (1 if self.deg == 1 else (1, 1)))
        mBdivA = H.neg(H.mul(B, H.inv(A)))
        BdivZA = H.mul(B, H.inv(H.mul(Z, A)))
        zero = 0 if self.deg == 1 else (0, 0)
        top = max(len(c) for c in maps)
        # the four isogeny polynomials' coefficients, padded to one degree with
        # leading zeros, highest degree first: (top, 4, [2,] NL)
        rows = [[c[k] if k < len(c) else zero for c in maps] for k in range(top - 1, -1, -1)]
        self._host = {"A": self._enc(A), "B": self._enc(B), "Z": self._enc(Z),
                      "mBdivA": self._enc(mBdivA), "BdivZA": self._enc(BdivZA),
                      "iso": torch.stack([torch.stack([self._enc(v) for v in row])
                                          for row in rows])}
        self._dev = {}

    def _enc(self, v):
        if self.deg == 1:
            return self.F.encode(v)
        return self.F.encode(list(v))

    def consts(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {k: v.to(device) for k, v in self._host.items()}
        return self._dev[device]

    def _inv(self, a):
        F = self.F
        return F.batch_inv(a) if self.deg == 1 else F.inv(a)

    def _one(self, a):
        F = self.F
        if self.deg == 1:
            return F.broadcast_one(a.shape[:-1], a.device)
        return F.one(a.shape[:-2], a.device)

    def sgn0(self, v):
        """RFC 9380 sgn0 of Montgomery elements (m = 1 or 2)."""
        c = self.F.from_mont(v) if self.deg == 1 else self.F.F.from_mont(v)
        if self.deg == 1:
            return (c[..., 0] & 1).bool()
        s0 = (c[..., 0, 0] & 1).bool()
        z0 = (c[..., 0, :] == 0).all(-1)
        return s0 | (z0 & (c[..., 1, 0] & 1).bool())

    def map_to_curve(self, u):
        """SSWU (RFC 9380 F.2) and the isogeny: Montgomery u (n, [2,] NL) ->
        affine (x, y) on E (never infinity)."""
        F = self.F
        c = self.consts(u.device)
        like = lambda name: c[name].expand_as(u)          # noqa: E731
        Zu2 = F.mul(like("Z"), F.square(u))
        tv1 = self._inv(F.add(F.square(Zu2), Zu2))       # 0 where Z^2 u^4 + Z u^2 = 0
        x1 = F.mul(like("mBdivA"), F.add(self._one(u), tv1))
        x1 = F.cselect(F.is_zero(tv1), like("BdivZA"), x1)
        xx1, x2 = F.mul(torch.stack([x1, Zu2]), torch.stack([x1, x1])).unbind(0)
        xs = torch.stack([x1, x2])
        sq = torch.stack([xx1, F.square(x2)])
        gx = F.add(F.mul(F.add(sq, like("A").expand_as(sq)), xs), like("B").expand_as(sq))
        y12, ok12 = self.sq.sqrt(gx)                     # both candidates, one root chain
        x = F.cselect(ok12[0], x1, x2)
        y = F.cselect(ok12[0], y12[0], y12[1])
        s = self.sgn0(torch.stack([u, y]))
        y = F.cselect(s[0] != s[1], F.neg(y), y)
        return self._isogeny(x, y)

    def _isogeny(self, x, y):
        """(x', y') on E' -> (xnum/xden, y' ynum/yden): the four polynomials
        by Horner side by side, one batched inversion of both denominators."""
        F = self.F
        iso = self.consts(x.device)["iso"]
        shape = (4,) + x.shape
        xs = x.expand(shape)
        acc = iso[0][(slice(None),) + (None,) * (x.dim() - iso.dim() + 2)].expand(shape)
        acc = acc.contiguous()                  # a product factor: no broadcast mid-batch
        for k in range(1, iso.shape[0]):
            coef = iso[k][(slice(None),) + (None,) * (x.dim() - iso.dim() + 2)].expand(shape)
            acc = F.add(F.mul(acc, xs), coef)
        xn, xd, yn, yd = acc.unbind(0)
        inv = self._inv(torch.stack([xd, yd]))
        xo, yr = F.mul(torch.stack([xn, yn]), inv).unbind(0)
        return xo, F.mul(y, yr)


# ---------------------------------------------------------------------------
# BLS12-381 G1 and G2 with cofactor clearing
# ---------------------------------------------------------------------------


class HashToCurveBLS12381:
    def __init__(self):
        ctx = get_curve("BLS12_381")
        self.ctx = ctx
        self.fp = ctx.fp
        self.fp2 = build_tower(ctx)[0]
        p, nr = ctx.p, ctx.params.fp2_nonresidue
        self.g1_map = SSWUMap(self.fp, get_sqrt_fp("BLS12_381"), _HostFp(p),
                              HC.G1_SSWU_A, HC.G1_SSWU_B, HC.G1_SSWU_Z,
                              HC.G1_ISO_XNUM, HC.G1_ISO_XDEN, HC.G1_ISO_YNUM, HC.G1_ISO_YDEN,
                              ctx.b)
        self.g2_map = SSWUMap(self.fp2, get_sqrt_fp2("BLS12_381"), _HostFp2(p, nr),
                              HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z,
                              HC.G2_ISO_XNUM, HC.G2_ISO_XDEN, HC.G2_ISO_YNUM, HC.G2_ISO_YDEN,
                              ctx.g2_b())
        # psi(x, y) = (conj(x) / gamma_{1,2}, conj(y) / gamma_{1,3}),
        # gamma_{1,k} = xi^(k (p - 1) / 6)
        xi = ctx.params.fp6_nonresidue
        g12 = rm.fp2_pow(xi, 2 * (p - 1) // 6, nr, p)
        g13 = rm.fp2_pow(xi, 3 * (p - 1) // 6, nr, p)
        self.psi_x = self.fp2.encode(list(rm.fp2_inv(g12, nr, p)))
        self.psi_y = self.fp2.encode(list(rm.fp2_inv(g13, nr, p)))
        self.x_abs = abs(ctx.params.x_param)
        self._psi_dev = {}

    def _psi_consts(self, device):
        device = torch.device(device)
        if device not in self._psi_dev:
            self._psi_dev[device] = torch.stack([self.psi_x, self.psi_y]).to(device)
        return self._psi_dev[device]

    # -- the endomorphism and cofactor clearing -------------------------------

    def psi_xy(self, x, y):
        """psi on two Fp2 coordinates: (conj(x) psi_x, conj(y) psi_y), one
        product launch."""
        fp2 = self.fp2
        c = self._psi_consts(x.device)
        xy = fp2.conj(torch.stack([x, y]))
        out = fp2.mul(xy, c[(slice(None),) + (None,) * (x.dim() - 2)].expand_as(xy))
        return out[0], out[1]

    def psi(self, P):
        """The untwist-Frobenius-twist endomorphism on Jacobian G2 points."""
        X, Y, Z = P
        x, y = self.psi_xy(X, Y)
        return (x, y, self.fp2.conj(Z))

    def _mul_by_abs_x_g2(self, P):
        return ladder_const(self.ctx.g2, P, self.x_abs)

    def _clear_g1(self, P):
        """[1 - x]P = P + [|x|]P for x < 0 (Wahby-Boneh)."""
        g1 = self.ctx.g1
        n = P[0].shape[0]
        k = self.ctx.scalars_to_limbs([self.x_abs], P[0].device).expand(n, -1)
        return g1.add(P, g1.scalar_mul(k, P, scalar_bits=self.x_abs.bit_length()))

    def _clear_g2(self, P):
        """[x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P) (Budroni-Pintore)."""
        g2 = self.ctx.g2
        xP = g2.neg(self._mul_by_abs_x_g2(P))            # [x]P (x < 0)
        x2P = g2.neg(self._mul_by_abs_x_g2(xP))          # [x^2]P
        t = g2.add(x2P, g2.neg(g2.add(xP, P)))           # [x^2 - x - 1]P
        u = self.psi(g2.add(xP, g2.neg(P)))              # psi([x - 1]P)
        v = self.psi(self.psi(g2.double(P)))             # psi^2([2]P)
        return g2.add(g2.add(t, u), v)

    # -- public API --------------------------------------------------------------

    def hash_to_g1(self, msgs, dst: bytes, device="cuda"):
        """Messages -> Jacobian G1 points (n, NL) x 3 on `device`."""
        device = resolve_device(device)
        us = hash_to_field(msgs, dst, count=2, m=1, p=self.ctx.p)
        u = self.fp.encode([e[0] for msg_u in us for e in msg_u], device)
        x, y = self.g1_map.map_to_curve(u)
        g1 = self.ctx.g1
        Q = g1.add(g1.from_affine((x[0::2].contiguous(), y[0::2].contiguous())),
                   g1.from_affine((x[1::2].contiguous(), y[1::2].contiguous())))
        return self._clear_g1(Q)

    def hash_to_g2(self, msgs, dst: bytes, device="cuda"):
        """Messages -> Jacobian G2 points (n, 2, NL) x 3 on `device`: the 2n
        field elements in one batch (the signatures' hot path)."""
        device = resolve_device(device)
        us = hash_to_field(msgs, dst, count=2, m=2, p=self.ctx.p)
        flat = [c for msg_u in us for e in msg_u for c in e]
        u = self.fp.encode(flat, device).reshape(-1, 2, self.fp.NL)
        x, y = self.g2_map.map_to_curve(u)
        g2 = self.ctx.g2
        Q = g2.add(g2.from_affine((x[0::2], y[0::2])), g2.from_affine((x[1::2], y[1::2])))
        return self._clear_g2(Q)


@functools.lru_cache(maxsize=None)
def get_h2c() -> HashToCurveBLS12381:
    return HashToCurveBLS12381()
