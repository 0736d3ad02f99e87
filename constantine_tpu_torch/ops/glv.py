"""GLV endomorphism scalar decomposition for G1 (a = 0 curves), and GLS-4
for BLS12 G2.

Counterpart of ``constantine_tpu/ops/glv.py``: ``GLV``, ``get_glv``,
``GLS4``, ``get_gls4``, ``scalar_mul_gls4_g2`` and ``msm_gls4_g2``
(``scalar_mul_glv`` is not ported). phi(x, y) =
(beta*x, y) equals [lambda]P, with beta and lambda cube roots of unity in Fp
and Fr. The constructor finds them, the Gauss-reduced lattice basis and the
Babai rounding constants with host ints, as the reference does.

``decompose`` runs the reference's digit algorithm on int64 tensors of
16-bit digits (converted from and back to the port's 32-bit limbs), so the
mini-scalars are bit-identical: a Barrett product with a 2^384-scaled
constant for the rounding, then two's complement mod 2^(16*LM) with the top
digit masked, then magnitudes and sign masks. It is torch glue on either
device (XLA in the reference), not a kernel. GLV's scalars are public (the
MSM's), so its carry loops end on a host read, a few dozen a call, the
cheaper form on the online MSM of 2^16. GLS-4's are secret keys in
``sign``, so its carries (``ct=True``) are a fixed sequence of torch ops:
one carry round, then ``limbs.ripple``; they read nothing back to the host
and branch on no digit.
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


def _normalize(t: torch.Tensor, ct: bool = False) -> torch.Tensor:
    """Canonical digits with the final carry folded into the top digit, as
    the reference's limbs.normalize (t: column sums in [0, 2^32)). With ct,
    one carry round leaves every digit below 2^17 - 1, so ``ripple`` ends
    the carry without a host read."""
    if ct:
        c = t >> DIGIT_BITS
        y = t & DIGIT_MASK
        y[..., 1:] += c[..., :-1]
        d, carry = lb.ripple(y, DIGIT_BITS)
        carry = carry + c[..., -1]
    else:
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


def _mul_const_shift(a, w, shift: int, lout: int, ct: bool = False):
    """floor((a*w + 2^(16*shift - 1)) / 2^(16*shift)) as lout digits: the
    Barrett step."""
    t = _mul_const_full(a, w)
    t[..., shift - 1] += 1 << (DIGIT_BITS - 1)
    out = _normalize(t, ct)[..., shift:shift + lout]
    if out.shape[-1] < lout:
        out = torch.nn.functional.pad(out, (0, lout - out.shape[-1]))
    return out


def _mul_const_low(a, w, ct: bool = False):
    """(a * w) mod 2^(16*Lw) as canonical digits (N, Lw)."""
    Lw = w.shape[0]
    t = _mul_const_full(a[..., :Lw], w)[..., :Lw + 1]
    return _mask_top(_normalize(t, ct)[..., :Lw])


def _truncate_mod(a, L: int):
    """Value mod 2^(16*L) as (N, L) digits."""
    if a.shape[-1] >= L:
        return a[..., :L]
    return torch.nn.functional.pad(a, (0, L - a.shape[-1]))


def _mask_top(t):
    return torch.cat([t[..., :-1], t[..., -1:] & DIGIT_MASK], -1)


def _add_mod(a, b, ct: bool = False):
    """(a + b) mod 2^(16*L) of canonical digits."""
    if ct:
        return lb.ripple(a + b, DIGIT_BITS)[0]
    return lb.normalize(a + b, DIGIT_BITS)[0]


def _sub_mod(a, b, ct: bool = False):
    """(a - b) mod 2^(16*L) of canonical digits (with ct: a + ~b + 1)."""
    if ct:
        ones = lb.arange_on(a.shape[-1], a.device, 0, DIGIT_MASK, first=1)
        return lb.ripple(a - b + ones, DIGIT_BITS)[0]
    return lb.normalize(a - b, DIGIT_BITS)[0]


def _abs_sign(raw, ct: bool = False):
    """Two's complement (N, LM) digits -> (magnitude digits, neg mask)."""
    neg = ((raw[..., -1] >> (DIGIT_BITS - 1)) & 1).bool()
    return torch.where(neg[..., None], _sub_mod(torch.zeros_like(raw), raw, ct), raw), neg


def _to_limbs(d):
    """(N, L) canonical 16-bit digits -> (N, ceil(L/2)) int32 limbs."""
    if d.shape[-1] % 2:
        d = torch.nn.functional.pad(d, (0, 1))
    return lb.from_digits(d)


# -- GLS-4: the 4-dimensional split for BLS12 G2 (psi acts as [u] there) -------


def _det3(a):
    return (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
            - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))


def _cofactor4(m, i: int, j: int) -> int:
    minor = [[m[r][c] for c in range(4) if c != j] for r in range(4) if r != i]
    return (-1) ** (i + j) * _det3(minor)


def _det4(m) -> int:
    return sum(m[0][j] * _cofactor4(m, 0, j) for j in range(4))


class GLS4:
    """k = k0 + k1 L + k2 L^2 + k3 L^3 (mod r) with L = u, the curve
    parameter (psi(Q) = [u]Q on G2).

    The reference's construction: the lattice rows (u, -1, 0, 0), (0, u,
    -1, 0), (0, 0, u, -1), (1, 0, -1, u) annihilate (1, L, L^2, L^3) mod r
    with determinant +-r; Babai rounding by four Barrett products with
    2^384-scaled adjugate constants; mini-scalars as magnitudes and sign
    masks. ``decompose`` is the reference's digit algorithm over int64 16-bit
    digits, so the digits are bit-identical. Like the ladder after it, it
    reads nothing back to the host (the scalars are secret keys in
    ``sign``)."""

    def __init__(self, ctx):
        u, r = ctx.params.x_param, ctx.r
        lam = u % r
        Bm = [[u, -1, 0, 0], [0, u, -1, 0], [0, 0, u, -1], [1, 0, -1, u]]
        for row in Bm:
            if sum(c * pow(lam, i, r) for i, c in enumerate(row)) % r:
                raise ValueError(f"{ctx.name}: a GLS-4 basis row is not in the lattice")
        det = _det4(Bm)
        if abs(det) != r:
            raise ValueError(f"{ctx.name}: the GLS-4 basis does not span the lattice")
        self.ctx = ctx
        self.lam = lam
        self.basis = Bm
        # c = (k, 0, 0, 0) B^-1: c_i = k * C[i][0] / det (the adjugate)
        w = [_cofactor4(Bm, i, 0) * (1 if det > 0 else -1) for i in range(4)]
        B = 1 << _BARRETT_BITS
        self.w_sign = [-1 if wi < 0 else 1 for wi in w]
        self.w_scaled = [(abs(wi) * B + r // 2) // r for wi in w]
        self.w_digits = [_int_to_digits(v, _num_digits(max(1, v.bit_length())))
                         for v in self.w_scaled]
        self.mini_bits = max(abs(x) for row in Bm for x in row).bit_length() + 3
        self.LM = _num_digits(self.mini_bits + DIGIT_BITS)
        Wm = 1 << (DIGIT_BITS * self.LM)
        # k_j = [j == 0] k - sum_i c_i (s_i B[i][j])
        self.m_consts = [[_int_to_digits((self.w_sign[i] * Bm[i][j]) % Wm, self.LM)
                          for j in range(4)] for i in range(4)]
        self._validate()

    def _decompose_host(self, k: int):
        cs = [(k * wv + (1 << (_BARRETT_BITS - 1))) >> _BARRETT_BITS for wv in self.w_scaled]
        return [(k if j == 0 else 0) - sum(cs[i] * self.w_sign[i] * self.basis[i][j]
                                           for i in range(4)) for j in range(4)]

    def _validate(self):
        rng = random.Random(0xA7C4)
        r, lam = self.ctx.r, self.lam
        for _ in range(64):
            k = rng.randrange(r)
            ks = self._decompose_host(k)
            if (sum(ki * pow(lam, i, r) for i, ki in enumerate(ks)) - k) % r:
                raise ValueError("GLS-4 decomposition broken")
            if max(abs(x) for x in ks) >= 1 << self.mini_bits:
                raise ValueError("a GLS-4 mini-scalar exceeds its bound")

    def decompose(self, scalars: torch.Tensor):
        """(N, NL) canonical int32 scalar limbs -> [(k_i (N, LM/2) int32 limb
        magnitudes, neg_i (N,) bool)] for i = 0..3."""
        d = lb.to_digits(scalars)
        cs = [_mul_const_shift(d, wd, _BARRETT_DIGITS, self.LM, ct=True)
              for wd in self.w_digits]
        k_mod = _truncate_mod(d, self.LM)
        outs = []
        for j in range(4):
            s = None
            for i in range(4):
                t = _mul_const_low(cs[i], self.m_consts[i][j], ct=True)
                s = t if s is None else _add_mod(s, t, ct=True)
            raw = _sub_mod(k_mod if j == 0 else torch.zeros_like(k_mod), s, ct=True)
            k, neg = _abs_sign(raw, ct=True)
            outs.append((_to_limbs(k), neg))
        return outs


@functools.lru_cache(maxsize=None)
def get_gls4(curve_name: str = "BLS12_381") -> GLS4:
    from ..named.precompute import get_curve
    return GLS4(get_curve(curve_name))


def _psi_affine(xy):
    """psi on affine G2 points (the hash-to-curve endomorphism)."""
    from ..models.hash_to_curve import get_h2c
    return get_h2c().psi_xy(*xy)


def gls4_split(ctx, scalars, Q_aff):
    """The GLS-4 ladder's inputs: the decomposed scalars (4N, LM/2) and the
    points [+-]psi^i(Q) stacked (4N, 2, NL) x 2, i = 0..3."""
    g2 = ctx.g2
    pts, ks, cur = [], [], Q_aff
    for i, (ki, neg) in enumerate(get_gls4(ctx.name).decompose(scalars)):
        pts.append(g2.aff_cneg(neg, cur))
        ks.append(ki)
        if i < 3:
            cur = _psi_affine(cur)
    return (torch.cat(ks), (torch.cat([q[0] for q in pts]), torch.cat([q[1] for q in pts])))


def gls4_combine(ctx, acc, n: int):
    """sum_i of the four ladders' lanes (4N -> N), constant-time adds."""
    g2 = ctx.g2
    part = [tuple(t[i * n:(i + 1) * n] for t in acc) for i in range(4)]
    return g2.add(g2.add(part[0], part[1], ct=True), g2.add(part[2], part[3], ct=True),
                  ct=True)


def scalar_mul_gls4_g2(ctx, scalars, Q_aff):
    """[k]Q on affine G2 points: [k]Q = sum_i [k_i] psi^i(Q), the four
    ~67-bit ladders as one batch of 4N lanes of ``G2Group.scalar_mul``, then
    two levels of constant-time adds (``scalarMulEndo`` m = 4)."""
    kk, pts = gls4_split(ctx, scalars, Q_aff)
    g2 = ctx.g2
    acc = g2.scalar_mul(kk, g2.from_affine(pts), scalar_bits=get_gls4(ctx.name).mini_bits)
    return gls4_combine(ctx, acc, Q_aff[0].shape[0])


def msm_gls4_g2(ctx, points_aff, scalars, c: int = None):
    """G2 MSM with the GLS-4 pre-split (applyEndomorphism m = 4): N points
    and 255-bit scalars -> 4N points [+-]psi^i(Q) and ~67-bit scalars,
    through the flat route."""
    from .msm import msm
    kk, pts = gls4_split(ctx, scalars, points_aff)
    return msm(ctx.g2, pts, kk, c=c, scalar_bits=get_gls4(ctx.name).mini_bits, glv=False)


@functools.lru_cache(maxsize=None)
def get_glv(curve_name: str) -> GLV:
    from ..named.precompute import get_curve
    return GLV(get_curve(curve_name))
