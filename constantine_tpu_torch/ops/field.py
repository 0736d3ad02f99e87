"""Batched prime-field arithmetic in Montgomery form.

Counterpart of ``constantine_tpu/ops/field.py`` (``Field``). Elements are
int32 tensors (..., NL) of 32-bit limbs (see ``limbs.py``), canonical (< p),
in the Montgomery domain with R = 2^(32*NL) -- the reference's R -- unless a
method says otherwise. ``mul`` (and everything built on it) runs the K1
kernel on CUDA tensors, and ``batch_inv`` the K8-K10 kernels; add, sub and
the rest are plain torch ops on either device, as they were XLA ops in the
reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from .cuda_field import CudaAffine, mont_mul, mont_prod


class Field:
    """Prime field GF(p) with batched Montgomery-form arithmetic."""

    def __init__(self, p: int, name: str = "Fp"):
        self.p_int = int(p)
        self.name = name
        self.bits = self.p_int.bit_length()
        self.NL = lb.num_limbs(self.bits)
        self.R_int = 1 << (lb.LIMB_BITS * self.NL)
        if 2 * self.p_int >= self.R_int:
            raise ValueError("the CIOS kernels need p < R/2")
        NL = self.NL
        self.p = lb.int_to_limbs(self.p_int, NL)
        self.r2 = lb.int_to_limbs(self.R_int * self.R_int % self.p_int, NL)
        self.one = lb.int_to_limbs(self.R_int % self.p_int, NL)   # Montgomery 1
        # -p^-1 mod 2^32: the CIOS constant of the 32-bit-limb kernels
        self.m0ninv = (-pow(self.p_int, -1, 1 << 32)) % (1 << 32)
        # kernel argument: p limbs, m0, Montgomery one (csrc/ec.cuh Mod<N>)
        self.mod_words = np.concatenate(
            [self.p, np.array([self.m0ninv], np.uint32), self.one]).astype(np.uint32)
        self.mod_ptr = self.mod_words.ctypes.data        # the K1 launch's argument
        nprime = (-pow(self.p_int, -1, self.R_int)) % self.R_int
        D = 2 * NL                                  # 16-bit digits
        p16 = lb.unpack16(self.p).astype(np.int64)
        nprime16 = lb.unpack16(lb.int_to_limbs(nprime, NL)).astype(np.int64)
        self._host = {
            "p32": self.p.astype(np.int64),
            # ~p + 1 limb by limb: s + p_comp through limbs.add_limbs is s - p
            "p_comp": np.concatenate([[lb.LIMB_MASK - int(self.p[0]) + 1],
                                      lb.LIMB_MASK - self.p[1:].astype(np.int64)]).astype(np.int64),
            "p16": p16,
            "one": self.one.view(np.int32),
            "one_canon": lb.int_to_limbs(1, NL).view(np.int32),      # from_mont's factor
            "r2": self.r2.view(np.int32),
            # plain multiply: a*b column sums, and products with -p^-1 (mod R)
            # and with p as float64 matrices (see limbs.column_products)
            "diag": lb.diagonal_sum_matrix(D, D),
            "nprime_t": lb.toeplitz_matrix(nprime16, D, D),
            "p_t": lb.toeplitz_matrix(p16, D, 2 * D - 1),
        }
        self._dev = {}

    def consts(self, device) -> dict:
        """The field's constants as tensors on `device` (cached)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {k: torch.from_numpy(v.copy()).to(device)
                                 for k, v in self._host.items()}
        return self._dev[device]

    # -- host-side conversions ------------------------------------------------

    def from_int(self, x, device="cpu") -> torch.Tensor:
        """Python int(s) -> canonical (not Montgomery) limbs."""
        if isinstance(x, int):
            return lb.to_tensor(lb.int_to_limbs(x % self.p_int, self.NL), device)
        return lb.to_tensor(lb.ints_to_limbs([v % self.p_int for v in x], self.NL), device)

    def encode(self, x, device="cpu") -> torch.Tensor:
        """Python int(s) -> Montgomery-form limbs (host arithmetic)."""
        if isinstance(x, int):
            return self.from_int(x * self.R_int % self.p_int, device)
        return self.from_int([v * self.R_int % self.p_int for v in x], device)

    def decode(self, a):
        """Montgomery-form limbs -> python int(s)."""
        rinv = pow(self.R_int, -1, self.p_int)
        vals = [v * rinv % self.p_int for v in lb.limbs_to_ints(a)]
        return vals[0] if a.dim() == 1 else vals

    # -- shape helpers ---------------------------------------------------------

    def broadcast_zero(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.NL,), dtype=torch.int32, device=device)

    def broadcast_one(self, shape, device) -> torch.Tensor:
        return self.consts(device)["one"].expand(tuple(shape) + (self.NL,))

    # -- core modular ops --------------------------------------------------------

    def add(self, a, b):
        """a + b mod p: a + b and a + b - p carried in one pass (a + b < 2p
        < R needs no top carry), the second kept unless it went negative."""
        p = self.consts(a.device)["p32"]
        s = lb.widen(a) + lb.widen(b)
        v, c = lb.normalize(torch.stack([s, s - p]), lb.LIMB_BITS)
        return lb.narrow(lb.cselect(c[1] == 0, v[1], v[0]))

    def sub(self, a, b):
        """a - b mod p: a - b and a - b + p carried in one pass."""
        p = self.consts(a.device)["p32"]
        d = lb.widen(a) - lb.widen(b)
        v, c = lb.normalize(torch.stack([d, d + p]), lb.LIMB_BITS)
        return lb.narrow(lb.cselect(c[0] == 0, v[0], v[1]))

    def neg(self, a):
        p = self.consts(a.device)["p32"]
        d, _ = lb.sub_borrow(p, lb.widen(a))
        return torch.where(lb.is_zero(a)[..., None], a, lb.narrow(d))

    # add, sub and neg end their carry loop on a host read of the card (a
    # sync, and a branch on the data): the cheapest on the public glue of
    # the KZG paths. The _ct forms resolve carries with a fixed sequence of
    # torch ops (limbs.ripple, ~30 a call), for the towers' G2 ladders over
    # secret scalars; the values are the same.

    def add_ct(self, a, b):
        """a + b mod p without a host read: the sum, then the sum minus p
        kept unless it borrowed."""
        c = self.consts(a.device)
        s, _ = lb.add_limbs(lb.widen(a), lb.widen(b))      # a + b < 2p < R
        d, ge = lb.add_limbs(s, c["p_comp"])               # s - p
        return lb.narrow(torch.where(ge[..., None] == 1, d, s))

    def sub_ct(self, a, b):
        """a - b mod p without a host read: the difference, plus p where it
        borrowed."""
        c = self.consts(a.device)
        d, ge = lb.sub_limbs(lb.widen(a), lb.widen(b))
        dp, _ = lb.add_limbs(d, c["p32"])
        return lb.narrow(torch.where(ge[..., None] == 1, d, dp))

    def neg_ct(self, a):
        c = self.consts(a.device)
        d, _ = lb.sub_limbs(c["p32"], lb.widen(a))
        return torch.where(lb.is_zero(a)[..., None], a, lb.narrow(d))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (K1 on CUDA tensors)."""
        return mont_mul(a, b, self)

    def prod(self, *factors, squarings: int = 0):
        """(f0 * ... * f_{m-1})^(2^squarings), 1 <= m <= 4, in one K1 launch
        on CUDA tensors; a factor may be a periodic broadcast (mont_prod)."""
        return mont_prod(self, *factors, squarings=squarings)

    def square(self, a):
        return mont_prod(self, a, squarings=1)

    def to_mont(self, a):
        return self.mul(a, self.consts(a.device)["r2"])

    def from_mont(self, a):
        return self.mul(a, self.consts(a.device)["one_canon"])

    # -- exponentiation ---------------------------------------------------------

    def pow_const(self, a, e: int):
        """a^e for a host-known exponent, fixed 4-bit windows (most
        significant first), as in the reference."""
        window = 4
        if e == 0:
            return self.broadcast_one(a.shape[:-1], a.device).clone()
        nwin = -(-e.bit_length() // window)
        digits = [(e >> (window * i)) & ((1 << window) - 1)
                  for i in range(nwin - 1, -1, -1)]
        table = [self.broadcast_one(a.shape[:-1], a.device), a]
        for _ in range(2, 1 << window):
            table.append(self.mul(table[-1], a))
        res = self.broadcast_one(a.shape[:-1], a.device)
        for dig in digits:
            for _ in range(window):
                res = self.square(res)
            res = self.mul(res, table[dig])
        return res

    def inv(self, a):
        """Inverse by Fermat, a^(p-2); 0 maps to 0."""
        return self.pow_const(a, self.p_int - 2)

    @functools.cached_property
    def affine(self):
        """The batched-inversion kernels K8-K10 over this field."""
        return CudaAffine(self)

    def batch_inv(self, a, C: int = 32, block: int = 512):
        """Batch inversion over the flattened batch axes; zero entries give
        zero (they are masked to one first, then back to zero). The lanes go
        through CudaAffine.batch_inv_packed (chain kernels K8/K10 and the
        Fermat kernel K9, or their plain versions on CPU tensors); C and
        block are its chain length and block width."""
        batch_shape = a.shape[:-1]
        n = int(np.prod(batch_shape)) if batch_shape else 1
        flat = a.reshape(n, self.NL)
        zero_mask = lb.is_zero(flat)
        a_safe = lb.cselect(zero_mask, self.broadcast_one((n,), a.device), flat)
        out = self.affine.batch_inv_packed(a_safe.T.contiguous(), C, block).T
        out = lb.cselect(zero_mask, torch.zeros_like(out), out)
        return out.reshape(a.shape)

    # -- predicates --------------------------------------------------------------

    def is_zero(self, a):
        return lb.is_zero(a)

    def eq(self, a, b):
        return lb.eq(a, b)

    def cselect(self, cond, a, b):
        return lb.cselect(cond, a, b)
