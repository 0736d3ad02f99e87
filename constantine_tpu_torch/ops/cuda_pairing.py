"""K11 Miller loop and K12 final exponentiation -- wrappers and plain versions.

Counterpart of ``constantine_tpu/ops/pallas_pairing.py`` (``PallasPairing``
``miller``/``final_exp``). On CUDA tensors ``miller_loop`` and ``final_exp``
launch ``csrc/miller_loop.cu`` and ``csrc/final_exp.cu``; on CPU tensors they run the plain
versions below, which repeat the kernels' formulas (the reference kernel's
``_dbl_step``, ``_add_step``, ``_emit_line``, ``f12sparse_line`` and hard-part
program) with the plain towers of ``ops/towers.py`` over ``mont_mul_plain``,
so the two agree limb for limb. Layouts are the reference's standard ones:
P (B, NL) x 2, Q (B, 2, NL) x 2, Fp12 (B, 12, NL), Montgomery form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build
from . import limbs as lb
from .cuda_field import _on_cuda, mont_mul_plain
from .cuda_g1 import exp_words
from .towers import build_tower, fp_div2, mul_by_v, mul_by_xi


class CudaPairing:
    """K11 and K12 for BLS12-381 (M-twist, x < 0)."""

    def __init__(self, ctx):
        if ctx.params.twist_kind != "M":
            raise NotImplementedError("the pairing kernels are for the M-twist")
        F = ctx.fp
        self.F = F
        x = ctx.params.x_param
        self.x_abs, self.x_neg = abs(x), x < 0
        self.x_bits = [int(b) for b in bin(self.x_abs)[2:]]       # MSB first
        self._plain_mul = functools.partial(mont_mul_plain, F=F)
        self.p2, self.p6, self.p12 = build_tower(ctx, mul=self._plain_mul)
        self._b2 = F.encode([4, 4])                                  # b' = 4(1 + u)
        g1 = self.p12.gamma(1, "cpu")
        g2 = self.p12.gamma(2, "cpu")
        # PairingConsts: Mod, gamma1, gamma2, p - 2, |x| low and high words,
        # its bit length, x < 0
        self._consts = np.concatenate([
            F.mod_words, lb.to_numpy(g1).ravel(), lb.to_numpy(g2).ravel(),
            exp_words(F.p_int - 2, F.NL),
            [self.x_abs & 0xFFFFFFFF, self.x_abs >> 32, self.x_abs.bit_length(),
             int(self.x_neg)]]).astype(np.uint32)
        self._checked = False

    def _check_layout(self):
        if not self._checked:
            fn = build.library("miller_loop").ctt_pairing_consts_size
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != self._consts.nbytes:
                raise RuntimeError(f"PairingConsts is {fn()} bytes, packed "
                                   f"{self._consts.nbytes}")
            self._checked = True

    # -- K11 ----------------------------------------------------------------------

    def miller_loop(self, p_aff, q_aff):
        """f_{|x|,Q}(P), conjugated for x < 0: (B, 12, NL)."""
        xP, yP = p_aff
        xQ, yQ = q_aff
        NL = self.F.NL
        B = xP.shape[0]
        if xP.shape != (B, NL) or yP.shape != (B, NL) or xQ.shape != (B, 2, NL) \
                or yQ.shape != (B, 2, NL):
            raise ValueError(f"miller_loop: P {tuple(xP.shape)}, {tuple(yP.shape)}; "
                             f"Q {tuple(xQ.shape)}, {tuple(yQ.shape)}")
        ins = [t.contiguous() for t in (xP, yP, xQ, yQ)]
        if not _on_cuda(*ins):
            return self._miller_loop_plain(xP, yP, xQ, yQ)
        self._check_layout()
        out = torch.empty((B, 12, NL), dtype=torch.int32, device=xP.device)
        build.KERNELS["miller_loop"](xP.device, ctypes.c_void_p(self._consts.ctypes.data),
                                     *map(build.ptr, ins), build.ptr(out), B)
        return out

    def _dbl_step(self, T):
        fp2, F = self.p2, self.F
        X, Y, Z = T
        add, sub = fp2.add, fp2.sub

        def triple(a):
            return add(add(a, a), a)

        YZ = add(Y, Z)
        B, C, XY, YZ2, XX = fp2.mul(torch.stack([Y, Z, X, YZ, X]),
                                    torch.stack([Y, Z, Y, YZ, X]))
        E = triple(fp2.mul(self._b2.to(X.device).expand_as(C), C))      # 3 b' Z^2
        F3 = triple(E)
        A = fp_div2(F, XY)                                              # XY/2
        G = fp_div2(F, add(B, F3))                                      # (B + 3E)/2
        H = sub(sub(YZ2, B), C)                                         # 2YZ
        XX3 = triple(XX)
        sA, c1, c2, c3, X3, GG, EE, Z3 = fp2.mul(
            torch.stack([H, XX3, add(B, B), XX3, A, G, E, B]),
            torch.stack([Z, X, Z, Z, sub(B, F3), G, E, H]))
        Y3 = sub(GG, triple(EE))
        return (X3, Y3, Z3), (sA, fp2.neg(c3), sub(c1, c2))

    def _add_step(self, T, Q):
        fp2 = self.p2
        X, Y, Z = T
        xQ, yQ = Q
        add, sub = fp2.add, fp2.sub
        yQZ, xQZ = fp2.mul(torch.stack([yQ, xQ]), torch.stack([Z, Z]))
        theta = sub(Y, yQZ)
        lam = sub(X, xQZ)
        t2, l2 = fp2.mul(torch.stack([theta, lam]), torch.stack([theta, lam]))
        l3c, t2Z, l2X = fp2.mul(torch.stack([l2, t2, l2]), torch.stack([lam, Z, X]))
        H = add(sub(t2Z, add(l2X, l2X)), l3c)
        X3, a, b, Z3, c, d = fp2.mul(torch.stack([lam, theta, Y, l3c, theta, lam]),
                                     torch.stack([H, sub(l2X, H), l3c, Z, xQ, yQ]))
        return (X3, sub(a, b), Z3), (lam, fp2.neg(theta), sub(c, d))

    def _mul_line(self, f, line, xP, yP):
        """f * line(P): lA = yP xi sA, lB = xP sB, lC = sC; the sparse
        product's 15 Fp2 multiplies as one stacked multiply."""
        fp2, fp6 = self.p2, self.p6
        prime = fp2.prime
        sA, sB, sC = line
        lA, lB = self._plain_mul(torch.stack([mul_by_xi(prime, sA), sB]),
                                 torch.stack([yP, xP])[:, :, None, :])
        lC = sC
        a0, a1, a2 = fp6.split(f[..., :6, :])
        b0, b1, b2 = fp6.split(f[..., 6:, :])
        g0, g1, g2 = fp2.add(a0, b0), fp2.add(a1, b1), fp2.add(a2, b2)
        lhs = [a0, a1, a2,                                   # v0 = f.c0 * lA
               b0, b0, b1, b1, b2, b2,                       # v1 = f.c1 * (lC v + lB v^2)
               g0, g1, g2, fp2.add(g1, g2), fp2.add(g0, g1), fp2.add(g0, g2)]
        s12, s01, s02 = fp2.add(lC, lB), fp2.add(lA, lC), fp2.add(lA, lB)
        rhs = [lA, lA, lA, lC, lB, lC, lB, lC, lB, lA, lC, lB, s12, s01, s02]
        pr = fp2.mul(torch.stack(lhs), torch.stack(rhs))
        v0 = torch.cat([pr[0], pr[1], pr[2]], -2)
        p01, p02, p11, p12, p21, p22 = pr[3:9]
        v1 = torch.cat([mul_by_xi(prime, fp2.add(p12, p21)),
                        fp2.add(p01, mul_by_xi(prime, p22)), fp2.add(p02, p11)], -2)
        w0, w1, w2, m12, m01, m02 = pr[9:15]
        t = torch.cat([fp2.add(w0, mul_by_xi(prime, fp2.sub(fp2.sub(m12, w1), w2))),
                       fp2.add(fp2.sub(fp2.sub(m01, w0), w1), mul_by_xi(prime, w2)),
                       fp2.add(fp2.sub(fp2.sub(m02, w0), w2), w1)], -2)
        c0 = fp6.add(v0, mul_by_v(prime, v1))
        c1 = fp6.sub(fp6.sub(t, v0), v1)
        return torch.cat([c0, c1], -2)

    def _miller_loop_plain(self, xP, yP, xQ, yQ):
        p12 = self.p12
        f = p12.one(xP.shape[:1], xP.device)
        T = (xQ, yQ, self.p2.one(xP.shape[:1], xP.device))
        for bit in self.x_bits[1:]:
            f = p12.square(f)
            T, line = self._dbl_step(T)
            f = self._mul_line(f, line, xP, yP)
            if bit:
                T, line = self._add_step(T, (xQ, yQ))
                f = self._mul_line(f, line, xP, yP)
        return p12.conj12(f) if self.x_neg else f

    # -- K12 ----------------------------------------------------------------------

    def final_exp(self, f):
        """f^(3 (p^12 - 1)/r) per lane: (B, 12, NL) -> (B, 12, NL)."""
        NL = self.F.NL
        if f.dim() != 3 or f.shape[1:] != (12, NL):
            raise ValueError(f"final_exp: {tuple(f.shape)} is not (B, 12, {NL})")
        f = f.contiguous()
        if not _on_cuda(f):
            return self._final_exp_plain(f)
        self._check_layout()
        out = torch.empty_like(f)
        build.KERNELS["final_exp"](f.device, ctypes.c_void_p(self._consts.ctypes.data),
                                   build.ptr(f), build.ptr(out), f.shape[0])
        return out

    def _pow_x(self, f):
        p12 = self.p12
        acc = f
        for bit in self.x_bits[1:]:
            acc = p12.cyclotomic_square(acc)
            if bit:
                acc = p12.mul(acc, f)
        return p12.conj12(acc) if self.x_neg else acc

    def _final_exp_plain(self, f):
        """The easy part, then (x-1)^2 (x+p) (x^2+p^2-1) + 3 as the TPU
        kernel's program computes it."""
        p12 = self.p12
        g = p12.mul(p12.conj12(f), p12.inv(f))                       # f^(p^6 - 1)
        g = p12.mul(p12.frobenius(g, 2), g)                           # ^(p^2 + 1)
        t1 = p12.mul(self._pow_x(g), p12.conj12(g))
        t1 = p12.mul(self._pow_x(t1), p12.conj12(t1))
        t2 = p12.mul(self._pow_x(t1), p12.frobenius(t1, 1))
        acc = self._pow_x(self._pow_x(t2))
        acc = p12.mul(acc, p12.frobenius(t2, 2))
        acc = p12.mul(acc, p12.conj12(t2))
        acc = p12.mul(acc, p12.cyclotomic_square(g))
        return p12.mul(acc, g)
