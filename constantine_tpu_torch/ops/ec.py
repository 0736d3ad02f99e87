"""Batched G1 group law (a = 0 short Weierstrass, Jacobian coordinates).

Counterpart of ``constantine_tpu/ops/ec.py`` (``ECGroup``) for the base
field. Points are tuples of (..., NL) int32 field elements; infinity is any
point with Z == 0, built as (1, 1, 0) in Montgomery form. ``double`` and
``add`` run the K3 kernels on CUDA tensors (through the planar layout of
``cuda_ec``) and their plain versions on CPU tensors; ``madd`` composes
field ops (K1 on CUDA), as the reference's XLA group law did.
"""

from __future__ import annotations

import torch

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

    def to_affine(self, P):
        """Jacobian -> ((x, y), inf_mask) with one batched inversion."""
        X, Y, Z = P
        F = self.F
        zinv = F.batch_inv(Z)          # 0 stays 0 for points at infinity
        zinv2 = F.square(zinv)
        x = F.mul(X, zinv2)
        y = F.mul(Y, F.mul(zinv, zinv2))
        return (x, y), F.is_zero(Z)

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

    # -- group law ------------------------------------------------------------

    def double(self, P):
        """Jacobian doubling (dbl-2009-l): K3 double on CUDA tensors."""
        Pp, batch = _to_planar(P)
        return _from_planar(self.pec.double(Pp), batch)

    def add(self, P, Q):
        """Complete Jacobian addition: K3 add on CUDA tensors."""
        pairs = [torch.broadcast_tensors(p, q) for p, q in zip(P, Q)]
        Pp, batch = _to_planar(tuple(p for p, _ in pairs))
        Qp, _ = _to_planar(tuple(q for _, q in pairs))
        return _from_planar(self.pec.add(Pp, Qp), batch)

    def madd(self, P, Q_aff):
        """Jacobian P + affine Q (madd-2007-bl, complete by selects)."""
        return ec_madd(self.F, self.F.mul, P, Q_aff)
