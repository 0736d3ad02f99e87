"""Extension-field towers Fp2, Fp6, Fp12 over BLS12-381 Fp, batched.

Counterpart of ``constantine_tpu/ops/towers.py`` (``build_tower``) and of
the Frobenius, conjugation and cyclotomic-square helpers of
``constantine_tpu/ops/pairing.py`` (``PairingBase``), with the same
representation, so the two packages' values are bit-identical:

- an element is an int32 tensor (..., k, NL), k = 2, 6 or 12 Fp coefficients
  in Montgomery form;
- Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi) with xi = 1 + u,
  Fp12 = Fp6[w]/(w^2 - v); an Fp12 element is (c0, c1) over Fp6, so its six
  Fp2 components have w-degrees (0, 2, 4, 1, 3, 5).

Linear ops (add, sub, neg) run on the whole tensor through the prime field.
A product stacks all its sub-products into one batched Fp multiply
(recursively), so an Fp12 mul is one multiply call: the K1 kernel on CUDA
tensors by default. A tower built with ``mul=`` another multiply (the plain
``mont_mul_plain``) is what the pairing kernels' plain versions use; its Fp
inversion is then Fermat over that multiply, as the kernels do it.
"""

from __future__ import annotations

import functools

import torch

from . import limbs as lb
from .sqrt import pow_msb


class PrimeLevel:
    """Fp as the base of a tower: (..., NL) elements, a chosen multiply, and
    the additions that read nothing back to the host (``Field.add_ct``):
    the tower carries the G2 ladders over secret scalars."""

    deg = 1

    def __init__(self, F, mul=None):
        self.F = F
        self._plain = mul is not None
        self.mul = mul if mul is not None else F.mul
        self.add, self.sub, self.neg = F.add_ct, F.sub_ct, F.neg_ct

    def inv(self, a):
        """Inverse (0 gives 0): Field.batch_inv (K9 on CUDA tensors) for the
        default tower, x^(p-2) over the plain multiply otherwise."""
        if not self._plain:
            return self.F.batch_inv(a)
        return pow_msb(self.mul, a, self.F.p_int - 2)


class ExtField:
    """A quadratic or cubic extension of a tower level."""

    arity = 0

    def __init__(self, base, nr_mul, name: str):
        self.base = base
        self.prime = base if isinstance(base, PrimeLevel) else base.prime
        self.F = self.prime.F
        self.sub_deg = base.deg
        self.deg = self.arity * self.sub_deg
        self.nr_mul = nr_mul                     # x -> nonresidue * x on the base
        self.name = name

    # -- component access ------------------------------------------------------

    def split(self, x):
        k = self.sub_deg
        if k == 1:
            return tuple(x[..., i, :] for i in range(self.arity))
        return tuple(x[..., i * k:(i + 1) * k, :] for i in range(self.arity))

    def join(self, comps):
        if self.sub_deg == 1:
            return torch.stack(comps, -2)
        return torch.cat(comps, -2)

    # -- linear ops on the flat tensor ---------------------------------------------

    def add(self, a, b):
        return self.prime.add(a, b)

    def sub(self, a, b):
        return self.prime.sub(a, b)

    def neg(self, a):
        return self.prime.neg(a)

    def double(self, a):
        return self.prime.add(a, a)

    def cselect(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1).all(-1)

    def one(self, batch_shape, device):
        out = torch.zeros(tuple(batch_shape) + (self.deg, self.F.NL), dtype=torch.int32,
                          device=device)
        out[..., 0, :] = self.F.consts(device)["one"]
        return out

    def zero(self, batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (self.deg, self.F.NL), dtype=torch.int32,
                           device=device)

    def encode(self, coeffs, device="cpu"):
        """`deg` python ints (Fp coefficients, low first) -> (deg, NL)."""
        if len(coeffs) != self.deg:
            raise ValueError(f"{self.name} takes {self.deg} coefficients")
        return self.F.encode(list(coeffs), device)

    def decode(self, a):
        """(..., deg, NL) -> flat list of python ints, coefficient order."""
        return self.F.decode(a.reshape(-1, self.F.NL))

    def square(self, a):
        return self.mul(a, a)

    def pow_const(self, a, e: int, window: int = 2):
        """a^e for a host-known e >= 0: fixed windows, most significant
        first (the reference's ``ExtField.pow_const``). The exponent is
        public, so a zero window skips its product; the value is the same."""
        if e == 0:
            return self.one(a.shape[:-2], a.device)
        table = [None, a]
        for _ in range(2, 1 << window):
            table.append(self.mul(table[-1], a))
        nwin = -(-e.bit_length() // window)
        digits = [(e >> (window * i)) & ((1 << window) - 1) for i in range(nwin - 1, -1, -1)]
        res = table[digits[0]]
        for dig in digits[1:]:
            for _ in range(window):
                res = self.square(res)
            if dig:
                res = self.mul(res, table[dig])
        return res

    def _stack_mul(self, lhs, rhs):
        """One base multiply over stacked operands."""
        return self.base.mul(torch.stack(lhs), torch.stack(rhs))


class QuadraticExt(ExtField):
    """a0 + a1*t with t^2 = nonresidue (nr_mul)."""

    arity = 2

    def mul(self, a, b):
        B = self.base
        a0, a1 = self.split(a)
        b0, b1 = self.split(b)
        s = B.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        v0, v1, v01 = self._stack_mul([a0, a1, s[0]], [b0, b1, s[1]])
        c = B.add(torch.stack([v0, v0]), torch.stack([self.nr_mul(v1), v1]))
        return self.join((c[0], B.sub(v01, c[1])))

    def square(self, a):
        B = self.base
        a0, a1 = self.split(a)
        v = self._stack_mul([a0, B.add(a0, a1)], [a1, B.add(a0, self.nr_mul(a1))])
        c0 = B.sub(B.sub(v[1], v[0]), self.nr_mul(v[0]))
        return self.join((c0, B.add(v[0], v[0])))

    def inv(self, a):
        B = self.base
        a0, a1 = self.split(a)
        sq = self._stack_mul([a0, a1], [a0, a1])
        ninv = B.inv(B.sub(sq[0], self.nr_mul(sq[1])))
        prods = self._stack_mul([a0, a1], [ninv, ninv])
        return self.join((prods[0], B.neg(prods[1])))


class Fp2(QuadraticExt):
    """Fp2 = Fp[u]/(u^2 + 1) over the prime level: the same canonical values
    as QuadraticExt with fewer field additions, which cost more torch ops
    than a product launch. mul: schoolbook, (a0 b0 - a1 b1, a0 b1 + a1 b0);
    square: ((a0 + a1)(a0 - a1), (2 a0) a1). Either is one stacked base
    multiply (one K1 launch) and two field additions."""

    def mul(self, a, b):
        B = self.base
        a0, a1 = self.split(a)
        b0, b1 = self.split(b)
        v = self._stack_mul([a0, a0, a1, a1], [b0, b1, b1, b0])
        return self.join((B.sub(v[0], v[2]), B.add(v[1], v[3])))

    def square(self, a):
        B = self.base
        a0, a1 = self.split(a)
        s = B.add(torch.stack([a0, a0]), torch.stack([a1, a0]))       # a0 + a1, 2 a0
        v = self._stack_mul([s[0], s[1]], [B.sub(a0, a1), a1])
        return self.join((v[0], v[1]))

    def pow_const(self, a, e: int, window: int = 2):
        """a^e for a host-known e: the value of ``ExtField.pow_const``. An
        exponent of p or more splits as e = e1 p + e0, and a^(e1 p) =
        conj(a)^e1 (the Frobenius), so a^e0 conj(a)^e1 is one joint ladder
        of half the squarings over a table of a^i conj(a)^j (its (2^w - 1)^2
        mixed products one stacked multiply)."""
        p = self.F.p_int
        e1, e0 = divmod(e, p)
        if e1 == 0 or e1 >= p:
            return super().pow_const(a, e, window)
        k = 1 << window
        pw = [None, a]
        for _ in range(2, k):
            pw.append(self.mul(pw[-1], a))
        cj = [None] + [self.conj(x) for x in pw[1:]]
        pairs = [(i, j) for i in range(1, k) for j in range(1, k)]
        mixed = self.mul(torch.stack([pw[i] for i, _ in pairs]),
                         torch.stack([cj[j] for _, j in pairs]))
        table = {(i, j): mixed[n] for n, (i, j) in enumerate(pairs)}
        table.update({(i, 0): pw[i] for i in range(1, k)})
        table.update({(0, j): cj[j] for j in range(1, k)})
        nwin = -(-max(e0.bit_length(), e1.bit_length()) // window)
        res = None
        for w in range(nwin - 1, -1, -1):
            if res is not None:
                for _ in range(window):
                    res = self.square(res)
            t = table.get(((e0 >> (window * w)) & (k - 1), (e1 >> (window * w)) & (k - 1)))
            if t is not None:
                res = t if res is None else self.mul(res, t)
        return res

    def conj(self, a):
        """a0 - a1 u (the Frobenius of Fp2)."""
        return torch.stack([a[..., 0, :], self.base.neg(a[..., 1, :])], -2)


class CubicExt(ExtField):
    """a0 + a1*t + a2*t^2 with t^3 = nonresidue: Karatsuba mul, norm-based
    inversion."""

    arity = 3

    def mul(self, a, b):
        B = self.base
        a0, a1, a2 = self.split(a)
        b0, b1, b2 = self.split(b)
        s = B.add(torch.stack([a1, a0, a0, b1, b0, b0]), torch.stack([a2, a1, a2, b2, b1, b2]))
        v0, v1, v2, m12, m01, m02 = self._stack_mul([a0, a1, a2, s[0], s[1], s[2]],
                                                    [b0, b1, b2, s[3], s[4], s[5]])
        t0, t1, t2 = B.sub(B.sub(torch.stack([m12, m01, m02]), torch.stack([v1, v0, v0])),
                           torch.stack([v2, v1, v2]))
        x = self.nr_mul(torch.stack([t0, v2]))
        c = B.add(torch.stack([v0, t1, t2]), torch.stack([x[0], x[1], v1]))
        return self.join(tuple(c))

    def inv(self, a):
        B = self.base
        a0, a1, a2 = self.split(a)
        a0a0, a1a2, a2a2, a0a1, a1a1, a0a2 = self._stack_mul([a0, a1, a2, a0, a1, a0],
                                                             [a0, a2, a2, a1, a1, a2])
        v0 = B.sub(a0a0, self.nr_mul(a1a2))
        v1 = B.sub(self.nr_mul(a2a2), a0a1)
        v2 = B.sub(a1a1, a0a2)
        fv = self._stack_mul([a0, a2, a1], [v0, v1, v2])
        finv = B.inv(B.add(fv[0], self.nr_mul(B.add(fv[1], fv[2]))))
        out = self._stack_mul([v0, v1, v2], [finv, finv, finv])
        return self.join(tuple(out))


class Fp12(QuadraticExt):
    """Fp12 = Fp6[w]/(w^2 - v) with the pairing's Frobenius, conjugation and
    cyclotomic squaring (``PairingBase.frobenius``, ``conj12``,
    ``cyclotomic_square``)."""

    def __init__(self, fp6, nr_mul, gammas, name):
        super().__init__(fp6, nr_mul, name)
        self.fp2 = fp6.base
        self._gammas = gammas                  # power -> (6, 2, NL) int32, CPU
        self._gdev = {}

    def gamma(self, power: int, device):
        key = (power, torch.device(device))
        if key not in self._gdev:
            self._gdev[key] = self._gammas[power].to(device)
        return self._gdev[key]

    def components(self, f):
        """(..., 12, NL) -> six Fp2 (..., 2, NL), coefficient order."""
        return [f[..., 2 * i:2 * i + 2, :] for i in range(6)]

    def conj12(self, f):
        """f^(p^6): negate the w-odd half c1."""
        return torch.cat([f[..., :6, :], self.prime.neg(f[..., 6:, :])], -2)

    def frobenius(self, f, power: int):
        """f^(p^power), power 1 or 2: componentwise conjugation for odd
        powers, then each Fp2 component times its gamma."""
        fp2 = self.fp2
        c = f.reshape(f.shape[:-2] + (6, 2, self.F.NL))
        if power % 2:
            c = torch.cat([c[..., :1, :], self.prime.neg(c[..., 1:, :])], -2)
        g = self.gamma(power, f.device).expand(c.shape)
        return fp2.mul(c, g).reshape(f.shape)

    def cyclotomic_square(self, f):
        """Granger-Scott squaring of a unitary f: three Fp4 squarings."""
        fp2 = self.fp2
        b = self.components(f)
        x = torch.stack([b[0], b[3], b[1]])           # sq4 inputs (x, y) per lane
        y = torch.stack([b[4], b[2], b[5]])
        s = fp2.square(torch.stack([x, y, fp2.add(x, y)]))   # xx, yy, (x+y)^2
        xx, yy, xy2 = s[0], s[1], s[2]
        c0 = fp2.add(xx, mul_by_xi(self.prime, yy))
        c1 = fp2.sub(fp2.sub(xy2, xx), yy)
        # new b0..b2 = 3 v_k.c0 - 2 b_k; b3 = 3 xi v2.c1 + 2 b3, b4 = 3 v0.c1 + 2 b4,
        # b5 = 3 v1.c1 + 2 b5
        v = torch.cat([c0, torch.stack([mul_by_xi(self.prime, c1[2]), c1[0], c1[1]])])
        bb = torch.stack(b)
        t = torch.cat([fp2.sub(v[:3], bb[:3]), fp2.add(v[3:], bb[3:])])
        out = fp2.add(fp2.add(t, t), v)
        return torch.cat(list(out), -2)


def mul_by_xi(prime, x):
    """xi * x for x in Fp2, xi = 1 + u, u^2 = -1: (x0 - x1, x0 + x1)."""
    a0, a1 = x[..., 0, :], x[..., 1, :]
    return torch.stack([prime.sub(a0, a1), prime.add(a0, a1)], -2)


def mul_by_v(prime, x):
    """v * x for x in Fp6 (..., 6, NL): (xi*x2, x0, x1)."""
    return torch.cat([mul_by_xi(prime, x[..., 4:6, :]), x[..., 0:2, :], x[..., 2:4, :]], -2)


def frobenius_gammas(p: int, nr: int, xi, power: int):
    """Host gamma constants of f^(p^power): xi^(j (p^power - 1)/6) for the
    six Fp2 components in coefficient order (w-degrees 0, 2, 4, 1, 3, 5)."""
    from ..utils import refmath as rm
    e = (p ** power - 1) // 6
    return [rm.fp2_pow(xi, j * e, nr, p) for j in (0, 2, 4, 1, 3, 5)]


@functools.lru_cache(maxsize=None)
def _build(F, params, mul):
    if params.fp2_nonresidue != -1 or tuple(params.fp6_nonresidue) != (1, 1):
        raise NotImplementedError("the port's towers are BLS12-381's: u^2 = -1, xi = 1 + u")
    prime = PrimeLevel(F, mul)
    fp2 = Fp2(prime, prime.neg, f"Fp2[{params.name}]")
    fp6 = CubicExt(fp2, functools.partial(mul_by_xi, prime), f"Fp6[{params.name}]")
    gammas = {}
    for power in (1, 2):
        g = frobenius_gammas(F.p_int, params.fp2_nonresidue, params.fp6_nonresidue, power)
        gammas[power] = F.encode([c for pair in g for c in pair]).reshape(6, 2, F.NL)
    fp12 = Fp12(fp6, functools.partial(mul_by_v, prime), gammas, f"Fp12[{params.name}]")
    return fp2, fp6, fp12


def build_tower(ctx, mul=None):
    """(Fp2, Fp6, Fp12) of a curve context; `mul` is the Fp multiply the
    products use (default Field.mul: K1 on CUDA tensors)."""
    return _build(ctx.fp, ctx.params, mul)


def fp_div2(F, a):
    """a / 2 mod p on canonical limbs: (a + p*odd(a)) >> 1 (a + p < 2^(32 NL))."""
    p = F.consts(a.device)["p32"]
    v = lb.widen(a)
    odd = (v[..., :1] & 1).bool()
    s, _ = lb.add_carry(v, torch.where(odd, p, torch.zeros_like(p)))
    hi = torch.nn.functional.pad(s[..., 1:], (0, 1))
    return lb.narrow((s >> 1) | ((hi & 1) << (lb.LIMB_BITS - 1)))
