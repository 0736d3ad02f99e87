"""GLV endomorphism scalar decomposition for G1 (a = 0 curves).

Counterpart of the degree-2 part of ``constantine_tpu/ops/glv.py`` (``GLV``,
``get_glv``; GLS-4 and ``scalar_mul_glv`` are not ported). phi(x, y) =
(beta*x, y) equals [lambda]P, with beta and lambda cube roots of unity in Fp
and Fr. The constructor finds them, the Gauss-reduced lattice basis and the
Babai rounding constants with host ints, as the reference does.

``decompose`` runs the reference's digit algorithm on int64 tensors of
16-bit digits (converted from and back to the port's 32-bit limbs), so the
mini-scalars are bit-identical: a Barrett product with a 2^384-scaled
constant for the rounding, then two's complement mod 2^(16*LM) with the top
digit masked, then magnitudes and sign masks. It is torch glue on either
device (XLA in the reference), not a kernel; its carry loops synchronise the
host with the card a few dozen times per call.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch

from . import limbs as lb
from ..utils import refmath as rm

DIGIT_BITS = lb.DIGIT_BITS
DIGIT_MASK = lb.DIGIT_MASK
_BARRETT_BITS = 384                  # scale of the rounding constants
_BARRETT_DIGITS = _BARRETT_BITS // DIGIT_BITS


def _num_digits(bits: int) -> int:
    return -(-bits // DIGIT_BITS)


def _int_to_digits(x: int, n: int) -> np.ndarray:
    """Python int -> (n,) int64 little-endian 16-bit digits."""
    if x < 0 or x >> (DIGIT_BITS * n):
        raise ValueError("integer does not fit in digits")
    return np.array([(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(n)], np.int64)


def _gauss_reduce(u, v):
    """Gauss lattice reduction of a 2D basis (python ints): a reduced
    (shortest) basis of the same lattice."""
    def norm2(w):
        return w[0] * w[0] + w[1] * w[1]
    if norm2(u) < norm2(v):
        u, v = v, u
    while True:
        num = u[0] * v[0] + u[1] * v[1]
        den = norm2(v)
        m = (2 * num + den) // (2 * den)  # round-half-up for positives
        u = (u[0] - m * v[0], u[1] - m * v[1])
        if norm2(u) >= norm2(v):
            return v, u
        u, v = v, u


def cube_roots_of_unity(m: int):
    """Non-trivial cube roots of unity mod m (needs m = 1 mod 3), or None."""
    if m % 3 != 1:
        return None
    s = rm.sqrt_mod((-3) % m, m)
    if s is None:
        return None
    inv2 = rm.inv_mod(2, m)
    return (m - 1 + s) * inv2 % m, (m - 1 - s) * inv2 % m


class GLV:
    """Degree-2 GLV decomposition context of a curve context (ops on its G1).

    Raises ValueError if the curve has no usable endomorphism or a constant
    fails its check."""

    def __init__(self, ctx):
        if ctx.a != 0:
            raise ValueError(f"{ctx.name}: GLV needs j-invariant 0 (a = 0)")
        lams = cube_roots_of_unity(ctx.r)
        betas = cube_roots_of_unity(ctx.p)
        if lams is None or betas is None:
            raise ValueError(f"{ctx.name}: no cube roots of unity")
        self.ctx = ctx
        r = ctx.r

        # match beta <-> lambda on the generator: (beta*gx, gy) == [lam]G
        gx, gy = ctx.g
        self.lam = self.beta = None
        for lam in lams:
            target = rm.ec_mul(lam, ctx.g, 0, ctx.p)
            for beta in betas:
                if target == (beta * gx % ctx.p, gy):
                    self.lam, self.beta = lam, beta
        if self.lam is None:
            raise ValueError(f"{ctx.name}: beta/lambda mismatch")

        # short basis of {(a, b): a + b*lam = 0 mod r}, det normalised to +r
        v1, v2 = _gauss_reduce((r, 0), ((-self.lam) % r, 1))
        (a1, b1), (a2, b2) = v1, v2
        det = a1 * b2 - a2 * b1
        if abs(det) != r:
            raise ValueError(f"{ctx.name}: basis does not span the GLV lattice")
        if det < 0:
            a2, b2 = -a2, -b2
        self.basis = ((a1, b1), (a2, b2))

        # Babai rounding: c1 = round(k*b2/r), c2 = round(-k*b1/r), as a
        # product with 2^384-scaled constants; the signs of b1, b2 are folded
        # into the two's-complement update constants below.
        B = 1 << _BARRETT_BITS
        self.w1 = (abs(b2) * B + r // 2) // r
        self.s1 = -1 if b2 < 0 else 1
        self.w2 = (abs(b1) * B + r // 2) // r
        self.s2 = 1 if b1 < 0 else -1

        # mini-scalar bound, one bit of slack for the rounding; one spare digit
        maxv = max(abs(x) for x in (a1, b1, a2, b2))
        self.mini_bits = maxv.bit_length() + 2
        self.LM = _num_digits(self.mini_bits + DIGIT_BITS)
        Wm = 1 << (DIGIT_BITS * self.LM)
        #   k1 = k - c1*(s1*a1) - c2*(s2*a2);  k2 = -c1*(s1*b1) - c2*(s2*b2)
        self.m_a1 = _int_to_digits((self.s1 * a1) % Wm, self.LM)
        self.m_a2 = _int_to_digits((self.s2 * a2) % Wm, self.LM)
        self.m_b1 = _int_to_digits((self.s1 * b1) % Wm, self.LM)
        self.m_b2 = _int_to_digits((self.s2 * b2) % Wm, self.LM)
        self.w1_digits = _int_to_digits(self.w1, _num_digits(self.w1.bit_length()))
        self.w2_digits = _int_to_digits(self.w2, _num_digits(self.w2.bit_length()))
        self.beta_mont = ctx.fp.encode(self.beta)
        self._validate()

    def _validate(self):
        rng = random.Random(0x61F5)
        r = self.ctx.r
        for _ in range(64):
            k = rng.randrange(r)
            k1, k2 = self._decompose_host(k)
            if (k1 + k2 * self.lam - k) % r != 0:
                raise ValueError("GLV decomposition broken")
            if max(abs(k1), abs(k2)) >= (1 << self.mini_bits):
                raise ValueError("GLV mini-scalar exceeds its bound")

    def _decompose_host(self, k: int):
        """The decomposition with python ints (same rounding as decompose)."""
        B = 1 << _BARRETT_BITS
        c1 = (k * self.w1 + B // 2) >> _BARRETT_BITS
        c2 = (k * self.w2 + B // 2) >> _BARRETT_BITS
        (a1, b1), (a2, b2) = self.basis
        k1 = k - c1 * (self.s1 * a1) - c2 * (self.s2 * a2)
        k2 = -c1 * (self.s1 * b1) - c2 * (self.s2 * b2)
        return k1, k2

    def decompose(self, scalars: torch.Tensor):
        """(N, NL) canonical int32 scalar limbs -> (k1, neg1, k2, neg2).

        k1, k2: (N, LM/2) int32 limb magnitudes (< 2^mini_bits); neg1, neg2:
        (N,) bool masks, folded into point negation by the MSM."""
        d = lb.to_digits(scalars)
        c1 = _mul_const_shift(d, self.w1_digits, _BARRETT_DIGITS, self.LM)
        c2 = _mul_const_shift(d, self.w2_digits, _BARRETT_DIGITS, self.LM)
        k_mod = _truncate_mod(d, self.LM)
        s = _mask_top(_add_mod(_mul_const_low(c1, self.m_a1), _mul_const_low(c2, self.m_a2)))
        k1_raw = _sub_mod(k_mod, s)
        u = _mask_top(_add_mod(_mul_const_low(c1, self.m_b1), _mul_const_low(c2, self.m_b2)))
        k2_raw = _sub_mod(torch.zeros_like(u), u)
        k1, n1 = _abs_sign(k1_raw)
        k2, n2 = _abs_sign(k2_raw)
        return _to_limbs(k1), n1, _to_limbs(k2), n2

    def endo(self, pts_aff):
        """phi(x, y) = (beta * x, y) on batched affine points."""
        x, y = pts_aff
        return (self.ctx.fp.mul(x, self.beta_mont.to(x.device)), y)


# -- 16-bit digit helpers (int64 tensors, the reference's two's complement) ---


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Canonical digits with the final carry folded into the top digit, as
    the reference's limbs.normalize (t non-negative)."""
    d, carry = lb.normalize(t, DIGIT_BITS)
    return torch.cat([d[..., :-1], d[..., -1:] + (carry << DIGIT_BITS)[..., None]], -1)


def _mul_const_full(a: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """(N, La) canonical digits x host constant digits (Lw,) -> the product
    as unnormalised columns (N, La+Lw+1)."""
    La = a.shape[-1]
    Lw = w.shape[0]
    t = torch.zeros(a.shape[:-1] + (La + Lw + 1,), dtype=torch.int64, device=a.device)
    for j in range(Lw):
        wj = int(w[j])
        if wj == 0:
            continue
        prod = a * wj                                # exact: both < 2^16
        t[..., j:j + La] += prod & DIGIT_MASK
        t[..., j + 1:j + 1 + La] += prod >> DIGIT_BITS
    return t


def _mul_const_shift(a, w, shift: int, lout: int):
    """floor((a*w + 2^(16*shift - 1)) / 2^(16*shift)) as lout digits: the
    Barrett step."""
    t = _mul_const_full(a, w)
    t[..., shift - 1] += 1 << (DIGIT_BITS - 1)
    out = _normalize(t)[..., shift:shift + lout]
    if out.shape[-1] < lout:
        out = torch.nn.functional.pad(out, (0, lout - out.shape[-1]))
    return out


def _mul_const_low(a, w):
    """(a * w) mod 2^(16*Lw) as canonical digits (N, Lw)."""
    Lw = w.shape[0]
    t = _mul_const_full(a[..., :Lw], w)[..., :Lw + 1]
    return _mask_top(_normalize(t)[..., :Lw])


def _truncate_mod(a, L: int):
    """Value mod 2^(16*L) as (N, L) digits."""
    if a.shape[-1] >= L:
        return a[..., :L]
    return torch.nn.functional.pad(a, (0, L - a.shape[-1]))


def _mask_top(t):
    return torch.cat([t[..., :-1], t[..., -1:] & DIGIT_MASK], -1)


def _add_mod(a, b):
    """(a + b) mod 2^(16*L), canonical digits."""
    return lb.normalize(a + b, DIGIT_BITS)[0]


def _sub_mod(a, b):
    """(a - b) mod 2^(16*L), canonical digits."""
    return lb.normalize(a - b, DIGIT_BITS)[0]


def _abs_sign(raw):
    """Two's complement (N, LM) digits -> (magnitude digits, neg mask)."""
    neg = ((raw[..., -1] >> (DIGIT_BITS - 1)) & 1).bool()
    return torch.where(neg[..., None], _sub_mod(torch.zeros_like(raw), raw), raw), neg


def _to_limbs(d):
    """(N, L) canonical 16-bit digits -> (N, ceil(L/2)) int32 limbs."""
    if d.shape[-1] % 2:
        d = torch.nn.functional.pad(d, (0, 1))
    return lb.from_digits(d)


@functools.lru_cache(maxsize=None)
def get_glv(curve_name: str) -> GLV:
    from ..named.precompute import get_curve
    return GLV(get_curve(curve_name))
