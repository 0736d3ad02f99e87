"""Curve contexts: the BLS12-381 slice of ``constantine_tpu/named/precompute.py``
(``CurveCtx``, ``get_curve``): Fp, Fr, G1, the twist's G2 over Fp2, and
the roots of unity of Fr, with constants checked against the host reference
math when the context is built."""

from __future__ import annotations

import functools

from ..ops import limbs as lb
from ..ops.field import Field
from ..utils import refmath as rm
from . import curves as curvedefs


class CurveCtx:
    """A named a = 0 curve with its Fp/Fr fields, G1 and G2 groups."""

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
        self.g2_aff = (params.g2_gx, params.g2_gy)
        nr = params.fp2_nonresidue
        if not rm.ec2_is_on_curve(self.g2_aff, self.g2_b(), nr, self.p):
            raise ValueError(f"{self.name}: G2 generator off the twist")
        if rm.ec2_mul(self.r, self.g2_aff, (0, 0), nr, self.p) is not None:
            raise ValueError(f"{self.name}: G2 generator is not of order r")
        if pow(params.fr_generator, (self.r - 1) // 2, self.r) != self.r - 1:
            raise ValueError(f"{self.name}: the Fr generator is a square")

    def g2_b(self):
        """The twist's b' in Fp2: b * xi for an M-twist."""
        if self.params.twist_kind != "M":
            raise NotImplementedError("the port's twists are M-twists")
        return rm.fp2_mul((self.b, 0), self.params.fp6_nonresidue,
                          self.params.fp2_nonresidue, self.p)

    def root_of_unity(self, log_size: int) -> int:
        """Primitive 2^log_size-th root of unity of Fr: g^((r-1)/2^k), g the
        primitive root the Ethereum KZG spec pins (7 for BLS12-381)."""
        if (self.r - 1) % (1 << log_size):
            raise ValueError(f"{self.name}: 2^{log_size} does not divide r - 1")
        return pow(self.params.fr_generator, (self.r - 1) >> log_size, self.r)

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

    @functools.cached_property
    def g2(self):
        """Batched G2 group ops (ops.ec.G2Group over the Fp2 tower)."""
        from ..ops.ec import G2Group
        from ..ops.towers import build_tower
        fp2 = build_tower(self)[0]
        return G2Group(fp2, fp2.encode(list(self.g2_b())), name=f"{self.name}.G2")

    @functools.cached_property
    def g2_gen(self):
        """G2 generator as Montgomery affine (x, y), each (1, 2, NL), CPU."""
        return tuple(self.fp.encode(list(c)).reshape(1, 2, self.fp.NL) for c in self.g2_aff)

    def scalars_to_limbs(self, ks, device="cpu"):
        """Python ints -> canonical (N, NL_r) scalar limbs (mod r)."""
        return lb.to_tensor(lb.ints_to_limbs([k % self.r for k in ks], self.fr.NL),
                            device)


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> CurveCtx:
    return CurveCtx(curvedefs.CURVES[name])
