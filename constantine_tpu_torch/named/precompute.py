"""Curve contexts: the BLS12-381 slice of ``constantine_tpu/named/precompute.py``
(``CurveCtx``, ``get_curve``), with constants checked against the host
reference math when the context is built."""

from __future__ import annotations

import functools

from ..ops import limbs as lb
from ..ops.field import Field
from ..utils import refmath as rm
from . import curves as curvedefs


class CurveCtx:
    """A named a = 0 curve with its Fp/Fr fields and G1 group."""

    def __init__(self, params: curvedefs.CurveParams):
        self.params = params
        self.name = params.name
        self.p = params.p
        self.r = params.r
        self.a = params.a % params.p
        self.b = params.b % params.p
        self.fp = Field(self.p, f"Fp[{self.name}]")
        self.fr = Field(self.r, f"Fr[{self.name}]")
        self.g = (params.gx, params.gy)
        x = params.x_param
        if self.r != x**4 - x**2 + 1 or self.p != ((x - 1) ** 2 * self.r) // 3 + x:
            raise ValueError(f"{self.name}: BLS12 parameter identities do not hold")
        if not rm.ec_is_on_curve(self.g, self.a, self.b, self.p):
            raise ValueError(f"{self.name}: generator off the curve")

    @functools.cached_property
    def g1(self):
        """Batched G1 group ops (ops.ec.ECGroup over Fp)."""
        from ..ops.ec import ECGroup
        return ECGroup(self.fp, self.params.a, self.fp.encode(self.b),
                       name=f"{self.name}.G1")

    @functools.cached_property
    def g1_gen(self):
        """G1 generator as Montgomery affine (x, y), batch shape (1,), CPU."""
        return (self.fp.encode([self.g[0]]), self.fp.encode([self.g[1]]))

    def scalars_to_limbs(self, ks, device="cpu"):
        """Python ints -> canonical (N, NL_r) scalar limbs (mod r)."""
        return lb.to_tensor(lb.ints_to_limbs([k % self.r for k in ks], self.fr.NL),
                            device)


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> CurveCtx:
    return CurveCtx(curvedefs.CURVES[name])
