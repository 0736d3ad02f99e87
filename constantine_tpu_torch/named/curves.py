"""BLS12-381 constants (own copy of the port's slice of
``constantine_tpu/named/curves.py``; IETF pairing-friendly-curves draft,
x = -0xd201000000010000)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CurveParams:
    name: str
    p: int                 # base field modulus
    r: int                 # subgroup order (scalar field modulus)
    a: int                 # short-Weierstrass a
    b: int                 # short-Weierstrass b
    gx: int                # G1 generator
    gy: int
    x_param: int           # BLS12 x
    fr_generator: int      # primitive root of Fr* pinned by the Ethereum KZG spec


BLS12_381 = CurveParams(
    name="BLS12_381",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    a=0,
    b=4,
    gx=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gy=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    x_param=-0xD201000000010000,
    fr_generator=7,
)

CURVES = {BLS12_381.name: BLS12_381}
