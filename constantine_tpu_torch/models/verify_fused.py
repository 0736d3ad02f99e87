"""EIP-4844 verification on the card: decompression, fixed-base scalar
multiplications, the fold and the pairing check.

Counterpart of ``constantine_tpu/models/verify_fused.py``. The reference
traces each verify into one XLA program; the port runs the same structure
eagerly: G1 decompression with the subgroup check in K13
(``ops/cuda_g1.py``), [y]G1 and [z]G2 from windowed tables built on the
host (``FixedBaseTable``), the batch fold as two online MSMs, and the
2-pair check through the Miller loop K11 and the final exponentiation K12
(``ops/pairing.py``). It is the one verify route of the port, on both
devices (CPU tensors run the kernels' plain versions).

The batch fold masks the rhs MSM's scalars where the *proof* is infinity.
The reference masks them where the commitment is (its lines 230 and 236),
so it accepts a crafted batch with C = infinity and P = [y/z]G1 that the
port rejects.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import limbs as lb
from ..ops.cuda_g1 import get_cuda_g1
from ..ops.msm import msm
from ..ops.pairing import get_pairing
from ..utils import refmath as rm


class FixedBaseTable:
    """[d 2^(c j)] B for a host-known base B: W = 32 windows of 2^c = 256
    entries (the reference's c = 8 over 256 bits; c divides the 32-bit
    limb), built on the host with python ints (G1, or G2 with g2=True) and
    encoded once."""

    c = 8
    W = 32

    def __init__(self, ctx, base, device, g2: bool = False):
        self.ctx = ctx
        c = self.c
        self.g2 = g2
        p = ctx.p
        if g2:
            nr = ctx.params.fp2_nonresidue
            add = functools.partial(rm.ec2_add, a2=(0, 0), nr=nr, p=p)
        else:
            add = functools.partial(rm.ec_add, a=0, p=p)
        entries = []
        for _ in range(self.W):
            row = [None]
            for _ in range((1 << c) - 1):
                row.append(add(row[-1], base))
            entries.extend(row)
            for _ in range(c):
                base = add(base, base)
        fp = ctx.fp
        zero = (0, 0) if g2 else 0
        shape = (self.W, 1 << c) + ((2, fp.NL) if g2 else (fp.NL,))

        def coords(k):
            vals = [e[k] if e is not None else zero for e in entries]
            flat = [v for pair in vals for v in pair] if g2 else vals
            return fp.encode(flat, device).reshape(shape)

        self.tx, self.ty = coords(0), coords(1)
        self.tinf = torch.tensor([e is None for e in entries], device=device).reshape(shape[:2])

    def mul(self, scalar_limbs):
        """[k]B for one canonical scalar (NL_r,) of 32-bit limbs: W gathers,
        then a log-depth tree of complete additions. Jacobian, batch (1,)."""
        group = self.ctx.g2 if self.g2 else self.ctx.g1
        dev = self.tx.device
        bit0 = torch.arange(self.W, device=dev) * self.c
        limbs = lb.widen(scalar_limbs.to(dev))
        digits = (limbs[bit0 // lb.LIMB_BITS] >> (bit0 % lb.LIMB_BITS)) & ((1 << self.c) - 1)
        rows = torch.arange(self.W, device=dev)
        P = group.from_affine((self.tx[rows, digits], self.ty[rows, digits]),
                              inf_mask=self.tinf[rows, digits])
        while P[0].shape[0] > 1:
            h = P[0].shape[0] // 2
            P = group.add(tuple(t[:h] for t in P), tuple(t[h:2 * h] for t in P))
        return P


def _field_sum(F, arr):
    """Sum of (n, NL) field elements, log depth, any n >= 1."""
    while arr.shape[0] > 1:
        h = arr.shape[0] // 2
        head = F.add(arr[:h], arr[h:2 * h])
        arr = torch.cat([head, arr[2 * h:]]) if arr.shape[0] % 2 else head
    return arr[0]


class FusedVerifier:
    """The verify pipelines over a KZG context (its device, roots and G2
    setup points)."""

    def __init__(self, kzg):
        self.kzg = kzg
        self.ctx = ctx = kzg.ctx
        self.device = kzg.device
        self.fr = ctx.fr
        self.g1dec = get_cuda_g1(ctx.name)
        self.pairing = get_pairing(ctx.name)
        self.T1 = FixedBaseTable(ctx, ctx.g, self.device)
        self.T2 = FixedBaseTable(ctx, ctx.g2_aff, self.device, g2=True)
        g2x, g2y = kzg.s.g2_monomial
        self._g2_gen_aff = (g2x[0:1], g2y[0:1])
        self._tau_g2_aff = (g2x[1:2], g2y[1:2])

    def decompress(self, x_canon, sign, inf):
        """Device half of G1 decompression on (N, NL) canonical x: K13 for
        the square root, sign and subgroup; infinity lanes are valid here
        (their host flags were checked). Returns ((x, y) Montgomery, ok)."""
        dev = self.device
        (xm, y), ok = self.g1dec.decompress(lb.to_tensor(x_canon, dev),
                                            torch.as_tensor(sign, device=dev))
        inf = torch.as_tensor(inf, device=dev)
        return (xm, y), ok | inf

    def core_pairs(self, C, cinf, Pr, pinf, z_l, y_l):
        """The single check's pairs: P = (C - [y]G1, proof), Q = (G2, [z]G2 -
        [tau]G2), affine, and the skip mask of the pairs with an infinity. C
        and Pr are Montgomery affine (1, NL) pairs, z_l and y_l canonical Fr
        limbs."""
        g1, g2 = self.ctx.g1, self.ctx.g2
        yG1 = self.T1.mul(y_l)
        zG2 = self.T2.mul(z_l)
        lhs1 = g1.add(g1.from_affine(C, inf_mask=cinf), g1.neg(yG1))
        rhs2 = g2.add(zG2, g2.neg(g2.from_affine(self._tau_g2_aff)))
        proof = g1.from_affine(Pr, inf_mask=pinf)
        (px, py), p_inf = g1.to_affine(tuple(torch.cat([a, b]) for a, b in zip(lhs1, proof)))
        (qx, qy), q_inf = g2.to_affine(rhs2)
        Q = (torch.cat([self._g2_gen_aff[0], qx]), torch.cat([self._g2_gen_aff[1], qy]))
        return (px, py), Q, torch.cat([p_inf[:1], p_inf[1:] | q_inf])

    def _verify_core(self, C, cinf, Pr, pinf, z_l, y_l) -> bool:
        """e(C - [y]G1, G2) * e(proof, [z]G2 - [tau]G2) == 1."""
        return self.pairing.pairing_check(*self.core_pairs(C, cinf, Pr, pinf, z_l, y_l))

    def _verify_points(self, c_parsed, p_parsed, z_l, y_l):
        (cx, csign, cinf, _), (px, psign, pinf, _) = c_parsed, p_parsed
        (xm, ym), ok = self.decompress(np.concatenate([cx, px]),
                                       np.concatenate([csign, psign]),
                                       np.concatenate([cinf, pinf]))
        if not bool(ok.all()):
            return None
        dev = self.device
        return self._verify_core((xm[:1], ym[:1]), torch.as_tensor(cinf, device=dev),
                                 (xm[1:], ym[1:]), torch.as_tensor(pinf, device=dev), z_l, y_l)

    def verify(self, c_parsed, p_parsed, z_l, y_l):
        """verify_kzg_proof after host parsing: True/False, or None if a
        point is not a valid G1 encoding. z_l, y_l: canonical (8,) limbs."""
        dev = self.device
        return self._verify_points(c_parsed, p_parsed, lb.to_tensor(z_l, dev),
                                   lb.to_tensor(y_l, dev))

    def verify_blob(self, poly, c_parsed, p_parsed, z_l):
        """verify_blob_kzg_proof: y = p(z) by the barycentric sum, then the
        single-proof check."""
        fr, dev = self.fr, self.device
        z = lb.to_tensor(z_l, dev)
        y, _, _ = self.kzg.eval_at(fr.to_mont(lb.to_tensor(poly, dev)), fr.to_mont(z))
        return self._verify_points(c_parsed, p_parsed, z, fr.from_mont(y))

    def verify_batch(self, polys, zs, c_parsed, p_parsed, r_powers):
        """verify_blob_kzg_proof_batch: the random linear combination of the
        n openings as one 2-pair check,
            e(sum r_i (C_i - [y_i]G1 + [z_i] P_i), G2) == e(sum r_i P_i, [tau]G2),
        the left sum one MSM over 2n + 1 points, the right one over n."""
        ctx, fr, dev = self.ctx, self.fr, self.device
        g1 = ctx.g1
        n = len(zs)
        (cx, csign, cinf, _), (px, psign, pinf, _) = c_parsed, p_parsed
        (xm, ym), ok = self.decompress(np.concatenate([cx, px]),
                                       np.concatenate([csign, psign]),
                                       np.concatenate([cinf, pinf]))
        if not bool(ok.all()):
            return None
        zs_m = fr.to_mont(lb.to_tensor(np.stack(zs), dev))
        ys, _, _ = self.kzg.eval_at(fr.to_mont(lb.to_tensor(np.stack(polys), dev)), zs_m)
        r_m = fr.encode([int(v) for v in r_powers], dev)
        r_l = fr.from_int([int(v) for v in r_powers], dev)
        # canonical r z and -sum r y: a product by the canonical one leaves
        # the Montgomery domain, and the sum and negation commute with it
        one_c = fr.consts(dev)["one_canon"]
        rz_l = fr.prod(r_m, zs_m, one_c)
        s_ry = fr.neg(_field_sum(fr, fr.prod(r_m, ys, one_c)))[None]
        c_inf = torch.as_tensor(cinf, device=dev)[:, None]
        p_inf = torch.as_tensor(pinf, device=dev)[:, None]
        zero = torch.zeros_like(r_l)
        r_c = torch.where(c_inf, zero, r_l)
        r_p = torch.where(p_inf, zero, r_l)           # the proof's mask (F1)
        rz_l = torch.where(p_inf, zero, rz_l)
        gx, gy = (t.to(dev) for t in ctx.g1_gen)
        lhs = msm(g1, (torch.cat([xm, gx]), torch.cat([ym, gy])),
                  torch.cat([r_c, rz_l, s_ry]), scalar_bits=255)
        rhs = g1.neg(msm(g1, (xm[n:], ym[n:]), r_p, scalar_bits=255))
        (px_, py_), inf = g1.to_affine(tuple(torch.stack([a, b]) for a, b in zip(lhs, rhs)))
        Q = (torch.cat([self._g2_gen_aff[0], self._tau_g2_aff[0]]),
             torch.cat([self._g2_gen_aff[1], self._tau_g2_aff[1]]))
        return self.pairing.pairing_check((px_, py_), Q, skip_mask=inf)


@functools.lru_cache(maxsize=None)
def get_verifier(kzg) -> FusedVerifier:
    return FusedVerifier(kzg)
