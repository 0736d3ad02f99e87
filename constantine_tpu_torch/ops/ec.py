"""Batched group laws (a = 0 short Weierstrass, Jacobian coordinates).

Counterpart of ``constantine_tpu/ops/ec.py`` (``ECGroup``). G1
(``ECGroup``): points are tuples of (..., NL) int32 field elements;
infinity is any point with Z == 0, built as (1, 1, 0) in Montgomery form.
``double``, ``double_k`` and ``add`` run the K3 kernels on CUDA tensors
(through the planar layout of ``cuda_ec``) and their plain versions on CPU
tensors;
``madd`` composes field ops (K1 on CUDA), as the reference's XLA group law
did. ``scalar_mul`` is the reference's scan of double, add and select over
the scalar bits; on CUDA tensors it is one ``ec_scalar_mul`` launch
(``csrc/ec_kernels.cu``), which walks every bit with the accumulator on
chip. At FK20's EC-FFT widths (64-128 lanes) that kernel is bound by its
chain of dependent multiplies, not by issue, so a team of threads shares
each lane and computes each level of a bit's independent products side by
side. G2 (``G2Group``, over the Fp2 tower): torch over the tower on either
device, as the reference's XLA G2, its products K1 launches on CUDA
tensors; its ``scalar_mul`` is the reference's constant-time ladder, which
reads nothing back to the host and branches on no data.
"""

from __future__ import annotations

import torch

from . import limbs as lb
from .cuda_ec import CudaEC, ec_madd


def _to_planar(P):
    """(..., NL) coords -> (NL, n) contiguous coords and the batch shape."""
    batch = P[0].shape[:-1]
    return tuple(v.reshape(-1, v.shape[-1]).T.contiguous() for v in P), batch


def _from_planar(P, batch):
    return tuple(v.T.reshape(tuple(batch) + (v.shape[0],)) for v in P)


class ECGroup:
    """y^2 = x^3 + b over a Field F (a = 0 only)."""

    def __init__(self, F, a_int, b_elem, name: str = "EC"):
        if a_int != 0:
            raise NotImplementedError("the port's group law is for a = 0 curves")
        self.F = F
        self.a_int = a_int
        self.b = b_elem
        self.name = name
        self.pec = CudaEC(F)

    # -- constructors ---------------------------------------------------------

    def infinity(self, batch_shape=(), device="cpu"):
        F = self.F
        one = F.broadcast_one(batch_shape, device).clone()
        return (one, one.clone(), F.broadcast_zero(batch_shape, device))

    def from_affine(self, xy, inf_mask=None):
        """(x, y) affine (+ optional inf mask) -> Jacobian."""
        x, y = xy
        F = self.F
        z = F.broadcast_one(x.shape[:-1], x.device).clone()
        if inf_mask is not None:
            z = F.cselect(inf_mask, torch.zeros_like(z), z)
        return (x, y, z)

    def to_affine(self, P, canonical: bool = False):
        """Jacobian -> ((x, y), inf_mask) with one batched inversion; x and
        y in Montgomery form, or canonical (from_mont's) with `canonical`."""
        X, Y, Z = P
        F = self.F
        zinv = F.batch_inv(Z)          # 0 stays 0 for points at infinity
        if canonical:
            # Z^-2 as a plain integer: a Montgomery product by it leaves the
            # Montgomery domain
            zc2 = F.prod(zinv, zinv, F.consts(Z.device)["one_canon"])
            return (F.mul(X, zc2), F.prod(Y, zinv, zc2)), F.is_zero(Z)
        return (F.prod(X, zinv, zinv), F.prod(Y, zinv, zinv, zinv)), F.is_zero(Z)

    def is_inf(self, P):
        return self.F.is_zero(P[2])

    # -- basic maps -----------------------------------------------------------

    def neg(self, P):
        X, Y, Z = P
        return (X, self.F.neg(Y), Z)

    def aff_cneg(self, cond, xy):
        """Conditional affine negation (for MSM signed digits)."""
        x, y = xy
        return (x, self.F.cselect(cond, self.F.neg(y), y))

    def cneg(self, cond, P):
        X, Y, Z = P
        return (X, self.F.cselect(cond, self.F.neg(Y), Y), Z)

    def select(self, cond, P, Q):
        """cond ? P : Q, lane-wise."""
        return tuple(self.F.cselect(cond, p, q) for p, q in zip(P, Q))

    # -- predicates -------------------------------------------------------------

    def is_on_curve(self, P):
        """Y^2 == X^3 + b Z^6 (Jacobian); infinity is on the curve."""
        F = self.F
        X, Y, Z = P
        Z2 = F.square(Z)
        rhs = F.add(F.prod(X, X, X), F.prod(self.b.to(Z.device).expand_as(Z), Z2, Z2, Z2))
        return F.eq(F.square(Y), rhs) | F.is_zero(Z)

    def eq(self, P, Q):
        """Group equality, cross-multiplied (both at infinity is equal)."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1, Z2Z2 = F.square(Z1), F.square(Z2)
        x_eq = F.eq(F.mul(X1, Z2Z2), F.mul(X2, Z1Z1))
        y_eq = F.eq(F.prod(Y1, Z2, Z2Z2), F.prod(Y2, Z1, Z1Z1))
        i1, i2 = F.is_zero(Z1), F.is_zero(Z2)
        return (x_eq & y_eq & ~(i1 ^ i2)) | (i1 & i2)

    # -- group law ------------------------------------------------------------

    def double(self, P):
        """Jacobian doubling (dbl-2009-l): K3 double on CUDA tensors."""
        return self.double_k(P, 1)

    def double_k(self, P, k: int):
        """k successive doublings: one K3 double launch on CUDA tensors, the
        plain doubling k times on CPU tensors."""
        Pp, batch = _to_planar(P)
        return _from_planar(self.pec.double_k(Pp, k), batch)

    def add(self, P, Q):
        """Complete Jacobian addition: K3 add on CUDA tensors."""
        pairs = [torch.broadcast_tensors(p, q) for p, q in zip(P, Q)]
        Pp, batch = _to_planar(tuple(p for p, _ in pairs))
        Qp, _ = _to_planar(tuple(q for _, q in pairs))
        return _from_planar(self.pec.add(Pp, Qp), batch)

    def madd(self, P, Q_aff):
        """Jacobian P + affine Q (madd-2007-bl, complete by selects)."""
        return ec_madd(self.F, self.F.mul, P, Q_aff)

    # -- scalar multiplication ------------------------------------------------

    def scalar_mul(self, scalar_limbs, P, scalar_bits: int = None):
        """[k]P per lane: constant-time double-and-add, most significant bit
        first, with a lane-wise select (the reference's scan).

        scalar_limbs: (..., NL_r) canonical 32-bit limbs (not Montgomery),
        broadcast against P's batch shape; scalar_bits bounds the scalars
        (default all their limbs' bits). On CUDA tensors the whole ladder is
        one ec_scalar_mul launch (the scalars expanded to every lane); on CPU
        tensors it is the per-bit loop of the plain double, add and select,
        which the kernel matches limb for limb.
        """
        batch = torch.broadcast_shapes(P[0].shape[:-1], scalar_limbs.shape[:-1])
        P = tuple(v.expand(batch + v.shape[-1:]) for v in P)
        ls = scalar_limbs.shape[-1]
        k = scalar_limbs.expand(batch + (ls,)).reshape(-1, ls).T.contiguous()
        Pp, _ = _to_planar(P)
        nbits = scalar_bits or lb.LIMB_BITS * ls
        return _from_planar(self.pec.scalar_mul(k, Pp, nbits), batch)


class G2Group:
    """y^2 = x^3 + b' over the Fp2 tower (a = 0), Jacobian coordinates.

    Counterpart of the reference's ``ECGroup`` over Fp2 (``ctx.g2``): the
    same complete add-2007-bl and dbl-2009-l with the degenerate-case
    selects, as torch over the tower, whose products go to K1 on CUDA
    tensors; the independent products of a formula are stacked into one
    multiply (one launch). Points are tuples of (..., 2, NL) Fp2
    coordinates; infinity has Z == 0.

    ``add`` checks on the host whether any lane doubles and computes the
    doubling only then: a read of the card and a branch on the points, fine
    where they are public; ``madd`` (the flat MSM's flush) does the same.
    ``add(..., ct=True)`` always computes the
    doubling beside the sum (its products stacked with the sum's, 5
    launches) and selects, as the reference's XLA does; ``scalar_mul``, a
    ladder over a secret scalar, uses only that form.
    """

    def __init__(self, fp2, b_elem, name: str = "G2"):
        self.F = fp2
        self.b = b_elem
        self.name = name
        self._bdev = {}

    def infinity(self, batch_shape=(), device="cpu"):
        F = self.F
        return (F.one(batch_shape, device), F.one(batch_shape, device),
                F.zero(batch_shape, device))

    def from_affine(self, xy, inf_mask=None):
        x, y = xy
        z = self.F.one(x.shape[:-2], x.device)
        if inf_mask is not None:
            z = self.F.cselect(inf_mask, torch.zeros_like(z), z)
        return (x, y, z)

    def to_affine(self, P):
        """Jacobian -> ((x, y), inf_mask); one Fp2 inversion (through the norm
        into Field.batch_inv) for the whole batch."""
        X, Y, Z = P
        F = self.F
        zinv = F.inv(Z)                     # 0 stays 0 for points at infinity
        zinv2 = F.square(zinv)
        x, zinv3 = F.mul(torch.stack([X, zinv]), torch.stack([zinv2, zinv2]))
        return (x, F.mul(Y, zinv3)), F.is_zero(Z)

    def is_inf(self, P):
        return self.F.is_zero(P[2])

    def neg(self, P):
        X, Y, Z = P
        return (X, self.F.neg(Y), Z)

    def cneg(self, cond, P):
        X, Y, Z = P
        return (X, self.F.cselect(cond, self.F.neg(Y), Y), Z)

    def aff_cneg(self, cond, xy):
        x, y = xy
        return (x, self.F.cselect(cond, self.F.neg(y), y))

    def select(self, cond, P, Q):
        """cond ? P : Q, lane-wise."""
        return tuple(self.F.cselect(cond, p, q) for p, q in zip(P, Q))

    def _b_on(self, device):
        device = torch.device(device)
        if device not in self._bdev:
            self._bdev[device] = self.b.to(device)
        return self._bdev[device]

    def is_on_curve(self, P):
        """Y^2 == X^3 + b' Z^6 (Jacobian); infinity is on the curve."""
        F = self.F
        X, Y, Z = P
        XX, Z2, YY = self._mul([X, Z, Y], [X, Z, Y])
        X3, Z4 = self._mul([XX, Z2], [X, Z2])
        bZ6 = F.mul(F.mul(Z4, Z2), self._b_on(Z.device).expand_as(Z))
        return F.eq(YY, F.add(X3, bZ6)) | F.is_zero(Z)

    def eq(self, P, Q):
        """Group equality, cross-multiplied (both at infinity is equal)."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1, Z2Z2, Y1Z2, Y2Z1 = self._mul([Z1, Z2, Y1, Y2], [Z1, Z2, Z2, Z1])
        u1, u2, s1, s2 = self._mul([X1, X2, Y1Z2, Y2Z1], [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
        i1, i2 = F.is_zero(Z1), F.is_zero(Z2)
        return (F.eq(u1, u2) & F.eq(s1, s2) & ~(i1 ^ i2)) | (i1 & i2)

    def _mul(self, lhs, rhs):
        return self.F.mul(torch.stack(lhs), torch.stack(rhs)).unbind(0)

    def _add2(self, a, b):
        """Two or more independent field additions as one (a stacked add)."""
        return self.F.add(torch.stack(a), torch.stack(b)).unbind(0)

    def double(self, P):
        """dbl-2009-l: Z = 0 in gives Z = 0 out. Independent additions share
        one stacked add: a field addition costs more torch ops than a
        product launch."""
        F = self.F
        X, Y, Z = P
        A, B, YZ = self._mul([X, Y, Y], [X, Y, Z])
        XB, A2, Z3 = self._add2([X, A, YZ], [B, A, YZ])
        C, t = self._mul([B, XB], [B, XB])
        AC, E = self._add2([A, A2], [C, A])
        D = F.double(F.sub(t, AC))                     # 2((X + B)^2 - A - C)
        D2, C2 = self._add2([D, C], [D, C])
        X3 = F.sub(F.square(E), D2)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.double(F.double(C2)))
        return (X3, Y3, Z3)

    def add(self, P, Q, ct: bool = False):
        """Complete P + Q: P == Q doubles, P == -Q gives infinity, and an
        infinity on either side gives the other point. ct: compute the
        doubling on every call, its products stacked with the sum's (no host
        read, no branch on the points)."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        ZZ = F.add(Z1, Z2)
        lhs, rhs = [Z1, Z2, Y1, Y2, ZZ], [Z1, Z2, Z2, Z1, ZZ]
        if ct:                                   # the doubling's own products ride along
            lhs, rhs = lhs + [X1, Y1, Y1], rhs + [X1, Y1, Z1]
        m = self._mul(lhs, rhs)
        Z1Z1, Z2Z2, Y1Z2, Y2Z1, ZZ2 = m[:5]
        lhs, rhs = [X1, X2, Y1Z2, Y2Z1], [Z2Z2, Z1Z1, Z2Z2, Z1Z1]
        if ct:
            A, B, YZ = m[5:]
            XB, A2, dZ3 = self._add2([X1, A, YZ], [B, A, YZ])
            lhs, rhs = lhs + [B, XB], rhs + [B, XB]
        m = self._mul(lhs, rhs)
        U1, U2, S1, S2 = m[:4]
        H, SS = F.sub(torch.stack([U2, S2]), torch.stack([U1, S1])).unbind(0)
        H2, R = self._add2([H, SS], [H, SS])
        lhs, rhs = [H2, R], [H2, R]
        if ct:
            C, t = m[4:]
            AC, E = self._add2([A, A2], [C, A])
            D = F.double(F.sub(t, AC))
            lhs, rhs = lhs + [E], rhs + [E]
        m = self._mul(lhs, rhs)
        I, RR = m[:2]
        lhs, rhs = [H, U1, F.sub(ZZ2, F.add(Z1Z1, Z2Z2))], [I, I, H]
        if ct:
            D2, C2 = self._add2([D, C], [D, C])
            dX3 = F.sub(m[2], D2)
            lhs, rhs = lhs + [E], rhs + [F.sub(D, dX3)]
        m = self._mul(lhs, rhs)
        J, V, Z3 = m[:3]
        X3 = F.sub(RR, F.add(J, F.double(V)))
        RV, SJ = self._mul([R, S1], [F.sub(V, X3), J])
        out = (X3, F.sub(RV, F.double(SJ)), Z3)
        p_inf, q_inf = F.is_zero(Z1), F.is_zero(Z2)
        h0, r0 = F.is_zero(H), F.is_zero(R)
        both = ~p_inf & ~q_inf
        is_dbl, is_opp = both & h0 & r0, both & h0 & ~r0
        if ct:
            dbl = (dX3, F.sub(m[3], F.double(F.double(C2))), dZ3)
            out = self.select(is_dbl, dbl, out)
        elif bool(is_dbl.any()):
            out = self.select(is_dbl, self.double(P), out)
        out = self.select(is_opp, self.infinity(out[0].shape[:-2], out[0].device), out)
        out = self.select(p_inf, Q, out)
        return self.select(q_inf, P, out)

    def madd(self, P, Q_aff):
        """Jacobian P + affine Q (madd-2007-bl), complete by the reference's
        selects: P = infinity gives Q, H = 0 and R = 0 doubles, H = 0 alone
        gives infinity. Five product launches; as in ``add``, a host read
        finds whether any lane doubles."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2 = Q_aff
        Z1Z1, Y2Z1 = self._mul([Z1, Y2], [Z1, Z1])
        U2, S2 = self._mul([X2, Y2Z1], [Z1Z1, Z1Z1])
        H, SY = F.sub(torch.stack([U2, S2]), torch.stack([X1, Y1])).unbind(0)
        R, ZH = self._add2([SY, Z1], [SY, H])
        HH, RR, ZH2 = self._mul([H, R, ZH], [H, R, ZH])
        I = F.double(F.double(HH))
        J, V = self._mul([H, X1], [I, I])
        X3 = F.sub(RR, F.add(J, F.double(V)))
        RV, YJ = self._mul([R, Y1], [F.sub(V, X3), J])
        out = (X3, F.sub(RV, F.double(YJ)), F.sub(ZH2, F.add(Z1Z1, HH)))
        p_inf = F.is_zero(Z1)
        h0, r0 = F.is_zero(H), F.is_zero(R)
        is_dbl, is_opp = ~p_inf & h0 & r0, ~p_inf & h0 & ~r0
        if bool(is_dbl.any()):
            out = self.select(is_dbl, self.double(P), out)
        out = self.select(is_opp, self.infinity(out[0].shape[:-2], out[0].device), out)
        return self.select(p_inf, self.from_affine(Q_aff), out)

    def scalar_mul(self, scalar_limbs, P, scalar_bits: int = None):
        """[k]P per lane: the reference's constant-time ladder. From
        infinity, every bit, most significant first: double, add (the
        ``ct`` form) and a lane-wise select on the bit. scalar_limbs: (...,
        L) canonical 32-bit limbs (not Montgomery) over P's batch;
        scalar_bits bounds the scalars (default all their limbs' bits). The
        bits are read on the device: no host read, no branch on the scalar."""
        nbits = scalar_bits or lb.LIMB_BITS * scalar_limbs.shape[-1]
        batch = P[0].shape[:-2]
        sh = lb.arange_on(lb.LIMB_BITS, P[0].device)
        bits = ((lb.widen(scalar_limbs)[..., None] >> sh) & 1).flatten(-2).bool()
        bits = bits.expand(batch + bits.shape[-1:])
        acc = self.infinity(batch, P[0].device)
        for i in range(nbits - 1, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[..., i], self.add(acc, P, ct=True), acc)
        return acc
