"""K13, G1 decompression with the subgroup check -- wrapper and plain version.

Counterpart of ``constantine_tpu/ops/pallas_g1.py`` (``PallasG1``).
``decompress`` takes canonical x and the sign flags, encodes x to
Montgomery form (``Field.to_mont``: K1 on the card) and runs
``csrc/g1_kernels.cu:ctt_g1_decompress`` on CUDA tensors, or the plain
version below on CPU tensors: y = (x^3 + 4)^((p+1)/4) (``ops/sqrt.py``),
the lexicographic sign fix, and Scott's test (``ops/subgroups.py``), over
the plain multiply. Infinity lanes are the caller's business.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build
from . import limbs as lb
from .cuda_field import _on_cuda, mont_mul_plain
from .sqrt import sqrt_3mod4
from .subgroups import is_in_subgroup_g1, scott_beta


SQRT_WINDOWS = 96      # csrc/g1.cuh: 4-bit windows of an exponent < 2^384


def exp_words(e: int, NL: int) -> np.ndarray:
    """A host exponent as the kernels' FpExp: NL words, then the bit length."""
    return np.concatenate([lb.int_to_limbs(e, NL), [e.bit_length()]]).astype(np.uint32)


def window_words(e: int) -> np.ndarray:
    """e's 4-bit digits, least significant first, as G1DecompressConsts holds
    them: SQRT_WINDOWS bytes, then the count of windows (the top one not 0)."""
    nwin = -(-e.bit_length() // 4)
    if not 0 < nwin <= SQRT_WINDOWS:
        raise ValueError(f"an exponent of {e.bit_length()} bits has no {SQRT_WINDOWS} windows")
    digits = np.zeros(SQRT_WINDOWS, np.uint8)
    digits[:nwin] = [(e >> (4 * i)) & 15 for i in range(nwin)]
    return np.concatenate([digits.view(np.uint32), [nwin]]).astype(np.uint32)


class CudaG1:
    """K13 over a BLS12 curve context's Fp."""

    def __init__(self, ctx):
        F = ctx.fp
        self.F = F
        p, r, u = ctx.p, ctx.r, ctx.params.x_param
        self.u = u
        self.beta_mont = F.encode(scott_beta(p, r, u, ctx.g))
        self._half = F.from_int((p + 1) // 2)
        self._plain_mul = functools.partial(mont_mul_plain, F=F)
        # G1DecompressConsts: Mod, beta, (p+1)/2, (p+1)/4, u^2, (p+1)/4's digits
        self._consts = np.concatenate([
            F.mod_words, lb.to_numpy(self.beta_mont), lb.to_numpy(self._half),
            exp_words((p + 1) // 4, F.NL), exp_words(u * u, F.NL),
            window_words((p + 1) // 4)]).astype(np.uint32)
        self._checked = False

    def decompress(self, x_canon, sign_big):
        """(N, NL) canonical x + (N,) sign mask -> ((x_mont, y_mont), ok):
        ok is is-square AND in-subgroup."""
        xm = self.F.to_mont(x_canon)
        y, ok = self.decompress_mont(xm, sign_big)
        return (xm, y), ok

    def decompress_mont(self, xm, sign_big):
        """Montgomery x (N, NL) + sign (N,) -> (y (N, NL), ok (N,) bool)."""
        F = self.F
        if xm.dim() != 2 or xm.shape[1] != F.NL or sign_big.shape != xm.shape[:1]:
            raise ValueError(f"g1_decompress: x {tuple(xm.shape)}, sign "
                             f"{tuple(sign_big.shape)}")
        sign = sign_big.to(torch.int32)
        if not _on_cuda(xm.contiguous(), sign):
            return self._decompress_plain(xm, sign_big.bool())
        xm, sign = xm.contiguous(), sign.contiguous()
        self._check_layout()
        n = xm.shape[0]
        y = torch.empty_like(xm)
        ok = torch.empty((n,), dtype=torch.int32, device=xm.device)
        build.KERNELS["g1_decompress"](
            xm.device, ctypes.c_void_p(self._consts.ctypes.data),
            *map(build.ptr, (xm, sign, y, ok)), n)
        return y, ok.bool()

    def _check_layout(self):
        if not self._checked:
            fn = build.library("g1_kernels").ctt_g1_consts_size
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != self._consts.nbytes:
                raise RuntimeError(f"G1DecompressConsts is {fn()} bytes, packed "
                                   f"{self._consts.nbytes}")
            self._checked = True

    def _decompress_plain(self, xm, sign):
        F, mul = self.F, self._plain_mul
        four = F.encode(4, xm.device).expand_as(xm)
        rhs = F.add(mul(mul(xm, xm), xm), four)
        y, is_sq = sqrt_3mod4(F, mul, rhs)
        one = torch.zeros_like(y)
        one[..., 0] = 1
        big = lb.geq(mul(y, one), self._half.to(xm.device).expand_as(y))
        y = lb.cselect(big != sign, F.neg(y), y)
        in_sub = is_in_subgroup_g1(F, mul, self.beta_mont.to(xm.device), xm, y, self.u)
        return y, is_sq & in_sub


@functools.lru_cache(maxsize=None)
def get_cuda_g1(curve_name: str = "BLS12_381") -> CudaG1:
    from ..named.precompute import get_curve
    return CudaG1(get_curve(curve_name))
