"""K3-K7: G1 point kernels -- wrappers and plain versions.

Counterpart of ``constantine_tpu/ops/pallas_ec.py`` (``PallasEC``). Public
methods take the reference's planar layout: a coordinate is an int32 tensor
(NL, n) with the lane axis contiguous; streams are (K, NL, M). On CUDA
tensors each method launches its kernel from ``csrc/ec_kernels.cu``; on CPU
tensors it runs the plain version below, which repeats the kernel's
formulas with torch ops (``ec_double``, ``ec_madd``, ``ec_add``: the
reference's ``_KF`` group law, selects in the same order). ``scalar_mul``
is K3 as ``ECGroup.scalar_mul`` drives it: the whole double-add-select
ladder in one ``ec_scalar_mul`` launch, whose plain version is that ladder
over the plain ``ec_double`` and ``ec_add``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from . import limbs as lb
from .cuda_field import _on_cuda, mont_mul_plain

# ---------------------------------------------------------------------------
# Group law on standard-layout (n, NL) coordinates (a = 0, Jacobian)
# ---------------------------------------------------------------------------


def _muls(mul, lhs, rhs):
    """Independent products as one multiply over stacked operands."""
    return mul(torch.stack(lhs), torch.stack(rhs)).unbind(0)


def ec_double(F, mul, P):
    """dbl-2009-l. Z = 0 in gives Z = 0 out; Y = 0 gives infinity."""
    X, Y, Z = P
    add, sub, dbl = F.add, F.sub, F.double
    A, B, YZ = _muls(mul, [X, Y, Y], [X, Y, Z])
    t = add(X, B)
    C, t = _muls(mul, [B, t], [B, t])
    D = dbl(sub(sub(t, A), C))
    E = add(dbl(A), A)
    X3 = sub(mul(E, E), dbl(D))
    Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))))
    return X3, Y3, dbl(YZ)


def _finish(F, mul, P, cond_dbl, cond_opp, out):
    """The shared degenerate-case selects: doubling, then P == -Q. The
    doubling is computed only when a lane takes it, as the reference
    kernel's ``@pl.when(jnp.any(is_dbl))``."""
    if bool(cond_dbl.any()):
        out = tuple(F.cselect(cond_dbl, d, o) for d, o in zip(ec_double(F, mul, P), out))
    one = F.broadcast_one(out[0].shape[:-1], out[0].device)
    zero = torch.zeros_like(out[2])
    return tuple(F.cselect(cond_opp, v, o) for v, o in zip((one, one, zero), out))


def ec_madd(F, mul, P, Q):
    """Jacobian P + affine Q (madd-2007-bl, complete by selects; Q != inf)."""
    X1, Y1, Z1 = P
    X2, Y2 = Q
    add, sub, dbl = F.add, F.sub, F.double
    Z1Z1, Y2Z1 = _muls(mul, [Z1, Y2], [Z1, Z1])
    U2, S2 = _muls(mul, [X2, Y2Z1], [Z1Z1, Z1Z1])
    H = sub(U2, X1)
    R = dbl(sub(S2, Y1))
    ZH = add(Z1, H)
    HH, R2, ZH2 = _muls(mul, [H, R, ZH], [H, R, ZH])
    I = dbl(dbl(HH))
    J, V = _muls(mul, [H, X1], [I, I])
    X3 = sub(sub(R2, J), dbl(V))
    RV, YJ = _muls(mul, [R, Y1], [sub(V, X3), J])
    Y3 = sub(RV, dbl(YJ))
    Z3 = sub(sub(ZH2, Z1Z1), HH)
    p_inf = F.is_zero(Z1)
    h0 = F.is_zero(H)
    r0 = F.is_zero(R)
    is_dbl = ~p_inf & h0 & r0
    is_opp = ~p_inf & h0 & ~r0
    out = _finish(F, mul, P, is_dbl, is_opp, (X3, Y3, Z3))
    one = F.broadcast_one(X1.shape[:-1], X1.device)
    return tuple(F.cselect(p_inf, q, o) for q, o in zip((X2, Y2, one), out))


def ec_add(F, mul, P, Q):
    """Complete Jacobian P + Q (add-2007-bl, complete by selects)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    add, sub, dbl = F.add, F.sub, F.double
    ZZ = add(Z1, Z2)
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, ZZ2 = _muls(mul, [Z1, Z2, Y1, Y2, ZZ], [Z1, Z2, Z2, Z1, ZZ])
    U1, U2, S1, S2 = _muls(mul, [X1, X2, Y1Z2, Y2Z1], [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
    H = sub(U2, U1)
    R = dbl(sub(S2, S1))
    H2 = dbl(H)
    I, RR = _muls(mul, [H2, R], [H2, R])
    J, V, Z3 = _muls(mul, [H, U1, sub(sub(ZZ2, Z1Z1), Z2Z2)], [I, I, H])
    X3 = sub(sub(RR, J), dbl(V))
    RV, SJ = _muls(mul, [R, S1], [sub(V, X3), J])
    Y3 = sub(RV, dbl(SJ))
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    h0 = F.is_zero(H)
    r0 = F.is_zero(R)
    both = ~p_inf & ~q_inf
    out = _finish(F, mul, P, both & h0 & r0, both & h0 & ~r0, (X3, Y3, Z3))
    out = tuple(F.cselect(p_inf, q, o) for q, o in zip(Q, out))
    return tuple(F.cselect(q_inf, p, o) for p, o in zip(P, out))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _std(v):
    """(NL, n) planar -> (n, NL) standard layout."""
    return v.transpose(-1, -2)


def _planar(v):
    return v.transpose(-1, -2).contiguous()


class CudaEC:
    """Point kernels for an a = 0 short-Weierstrass group over F (NL = 12)."""

    def __init__(self, field):
        if field.NL != 12:
            raise ValueError("the point kernels are built for 12-limb Fp")
        self.F = field
        self.NL = field.NL
        self._mod = ctypes.c_void_p(field.mod_words.ctypes.data)

    def _mul_plain(self, a, b):
        return mont_mul_plain(a, b, self.F)

    # -- K3: elementwise ------------------------------------------------------

    def _check_coords(self, coords):
        shape = coords[0].shape
        if len(shape) != 2 or shape[0] != self.NL or any(c.shape != shape for c in coords):
            raise ValueError(f"point kernels take (NL={self.NL}, n) coordinates, "
                             f"got {[tuple(c.shape) for c in coords]}")

    def add(self, P, Q):
        """(X, Y, Z) + (X, Y, Z), all (NL, n). Returns (NL, n) x 3."""
        self._check_coords((*P, *Q))
        if not _on_cuda(*P, *Q):
            out = ec_add(self.F, self._mul_plain, tuple(map(_std, P)),
                         tuple(map(_std, Q)))
            return tuple(map(_planar, out))
        n = P[0].shape[1]
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        build.KERNELS["ec_add"](P[0].device, self._mod,
                                *map(build.ptr, (*P, *Q, *out)), n)
        return out

    def double_k(self, P, k: int):
        """k >= 0 successive doublings of (NL, n) points. The kernel runs all
        k in one launch, a team of threads a lane over the doubling in 3
        levels of products (``csrc/ec.cuh`` ``double_k_lane``): the plain
        doubling's limbs."""
        self._check_coords(P)
        if k < 0:
            raise ValueError(f"double_k: k = {k} doublings")
        if not _on_cuda(*P):
            out = tuple(map(_std, P))
            for _ in range(k):
                out = ec_double(self.F, self._mul_plain, out)
            return tuple(map(_planar, out))
        n = P[0].shape[1]
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        build.KERNELS["ec_double_k"](P[0].device, self._mod,
                                     *map(build.ptr, (*P, *out)), n, k)
        return out

    def double(self, P):
        return self.double_k(P, 1)

    # -- [k]P in one launch (K3 as scalar_mul drives it) ----------------------------

    def scalar_mul(self, k, P, nbits: int):
        """[k]P per lane by the constant-time ladder: nbits bits of k from the
        top, each a double, an add of P and a select on the bit.

        k: (Ls, n) int32 canonical (not Montgomery) 32-bit scalar limbs, lane
        axis contiguous; P: (NL, n) x 3. Returns (NL, n) x 3, limb for limb the
        per-bit loop of ec_double, ec_add and the select.
        """
        self._check_coords(P)
        n = P[0].shape[1]
        if (k.dtype != torch.int32 or not k.is_contiguous() or k.dim() != 2
                or k.shape[1] != n or not 0 < nbits <= lb.LIMB_BITS * k.shape[0]):
            raise ValueError(f"scalar_mul: {k.dtype} scalars {tuple(k.shape)} "
                             f"(contiguous: {k.is_contiguous()}) with nbits={nbits} for {n} lanes")
        if not _on_cuda(k, *P):
            return self._scalar_mul_plain(k, P, nbits)
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        build.KERNELS["ec_scalar_mul"](P[0].device, self._mod,
                                       *map(build.ptr, (k, *P, *out)), n, nbits)
        return out

    def _scalar_mul_plain(self, k, P, nbits):
        F = self.F
        kw = lb.widen(k)
        idx = torch.arange(nbits - 1, -1, -1, device=k.device)
        bits = ((kw[idx // lb.LIMB_BITS] >> (idx % lb.LIMB_BITS)[:, None]) & 1).bool()  # (nbits, n)
        Q = tuple(map(_std, P))
        one = F.broadcast_one((k.shape[1],), k.device)
        acc = (one, one, torch.zeros_like(one))
        for bit in bits:
            acc = ec_double(F, self._mul_plain, acc)
            added = ec_add(F, self._mul_plain, acc, Q)
            acc = tuple(torch.where(bit[:, None], a2, a1) for a2, a1 in zip(added, acc))
        return tuple(map(_planar, acc))

    # -- K4: flush scan ---------------------------------------------------------

    def flush_scan(self, keys, xy):
        """Bucket-accumulation scan over a key-sorted stream.

        keys (K, M) int32; xy (K, 2*NL, M): rows 0..NL-1 the x limbs and
        NL..2NL-1 the (pre-negated) y limbs of each affine entry -- the
        reference's packed stream, whose u32 words are these limbs. Lane m
        sweeps keys[:, m]; slot (k, m) of the returned (ex, ey, ez)
        (K, NL, M) holds its accumulator after entry k, restarting at the
        entry whenever the key changes.
        """
        K, M = keys.shape
        NL = self.NL
        if xy.shape != (K, 2 * NL, M):
            raise ValueError(f"flush_scan: stream {tuple(xy.shape)} for keys {K}x{M}")
        if not _on_cuda(keys, xy):
            return self._flush_scan_plain(keys, xy)
        out = tuple(torch.empty((K, NL, M), dtype=torch.int32, device=keys.device)
                    for _ in range(3))
        build.KERNELS["flush_scan"](keys.device, self._mod,
                                    *map(build.ptr, (keys, xy, *out)), K, M)
        return out

    def _flush_scan_plain(self, keys, xy):
        F, NL = self.F, self.NL
        K, M = keys.shape
        one = F.broadcast_one((M,), keys.device)
        acc = (one, one, torch.zeros_like(one))
        cur = torch.full((M,), -1, dtype=keys.dtype, device=keys.device)
        outs = []
        for k in range(K):
            kk = keys[k]
            X2, Y2 = _std(xy[k, :NL]), _std(xy[k, NL:])
            g = ec_madd(F, self._mul_plain, acc, (X2, Y2))
            same = kk == cur
            acc = tuple(F.cselect(same, gv, fv) for gv, fv in zip(g, (X2, Y2, one)))
            outs.append(acc)
            cur = kk
        return tuple(torch.stack([_std(o[i]) for o in outs]).contiguous()
                     for i in range(3))

    # -- K5: merge scan ---------------------------------------------------------

    def merge_scan(self, keys, qx, qy, qz):
        """Like flush_scan over Jacobian partial sums (K, NL, M); entries
        with key <= 0 are neutral padding."""
        K, M = keys.shape
        NL = self.NL
        for q in (qx, qy, qz):
            if q.shape != (K, NL, M):
                raise ValueError(f"merge_scan: {tuple(q.shape)} for keys {K}x{M}")
        if not _on_cuda(keys, qx, qy, qz):
            return self._merge_scan_plain(keys, qx, qy, qz)
        out = tuple(torch.empty_like(qx) for _ in range(3))
        build.KERNELS["merge_scan"](keys.device, self._mod,
                                    *map(build.ptr, (keys, qx, qy, qz, *out)), K, M)
        return out

    def _merge_scan_plain(self, keys, qx, qy, qz):
        F = self.F
        K, M = keys.shape
        one = F.broadcast_one((M,), keys.device)
        acc = (one, one, torch.zeros_like(one))
        cur = torch.full((M,), -1, dtype=keys.dtype, device=keys.device)
        outs = []
        for k in range(K):
            kk = keys[k]
            Q = (_std(qx[k]), _std(qy[k]), _std(qz[k]))
            Q = (Q[0], Q[1], F.cselect(kk <= 0, torch.zeros_like(Q[2]), Q[2]))
            g = ec_add(F, self._mul_plain, acc, Q)
            same = kk == cur
            acc = tuple(F.cselect(same, gv, qv) for gv, qv in zip(g, Q))
            outs.append(acc)
            cur = kk
        return tuple(torch.stack([_std(o[i]) for o in outs]).contiguous()
                     for i in range(3))

    # -- K6: weighted bucket reduction -------------------------------------------

    def bucket_reduce(self, bx, by, bz, T: int):
        """Inputs (T, NL, C) bucket sums, T >= 1. Per lane c: run = sum_t
        B[t, c] and wsum = sum_t (T-1-t) B[t, c], by the reference's loop
        (wsum += run, then run += B[t]). Returns ((run), (wsum)), each (NL, C)
        x 3. The kernel runs a step's two adds side by side, two teams of
        threads a lane (``csrc/ec.cuh`` ``bucket_lane``)."""
        Tn, NL, C = bx.shape
        if (Tn != T or T < 1 or NL != self.NL or by.shape != bx.shape
                or bz.shape != bx.shape):
            raise ValueError(f"bucket_reduce: {tuple(bx.shape)} with T={T}")
        if not _on_cuda(bx, by, bz):
            return self._bucket_reduce_plain(bx, by, bz, T)
        out = torch.empty((6, NL, C), dtype=torch.int32, device=bx.device).unbind(0)
        build.KERNELS["bucket_reduce"](bx.device, self._mod,
                                       *map(build.ptr, (bx, by, bz, *out)), T, C)
        return out[:3], out[3:]

    def _bucket_reduce_plain(self, bx, by, bz, T):
        F = self.F
        C = bx.shape[2]
        one = F.broadcast_one((C,), bx.device)
        run = (one, one, torch.zeros_like(one))
        wsum = run
        for t in range(T):
            B = (_std(bx[t]), _std(by[t]), _std(bz[t]))
            wsum = ec_add(F, self._mul_plain, wsum, run)
            run = ec_add(F, self._mul_plain, run, B)
        return tuple(map(_planar, run)), tuple(map(_planar, wsum))

    # -- K7: window combine ---------------------------------------------------------

    def scaled_doubles(self, P, c: int, Wn: int):
        """Lane w of the (NL, Wn) input becomes 2^(c*w) P_w. Returns P itself
        when no lane owes a doubling (Wn = 1 or c = 0)."""
        self._check_coords(P)
        if P[0].shape[1] != Wn:
            raise ValueError(f"scaled_doubles: {P[0].shape[1]} lanes for Wn={Wn}")
        if (Wn - 1) * c == 0:
            return P
        if not _on_cuda(*P):
            return self._scaled_doubles_plain(P, c, Wn)
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        build.KERNELS["scaled_doubles"](P[0].device, self._mod,
                                        *map(build.ptr, (*P, *out)), Wn, c)
        return out

    def _scaled_doubles_plain(self, P, c, Wn):
        """The reference's masked ladder: (Wn-1)*c doubling steps, step t
        applied to the lanes that still owe one (t < c*w), which are the
        lanes from t//c + 1 on."""
        acc = tuple(map(_std, P))
        for t in range((Wn - 1) * c):
            lo = t // c + 1
            d = ec_double(self.F, self._mul_plain, tuple(v[lo:] for v in acc))
            acc = tuple(torch.cat([v[:lo], dv]) for v, dv in zip(acc, d))
        return tuple(map(_planar, acc))
