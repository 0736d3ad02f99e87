"""BLS12-381 constants (own copy of the port's slice of
``constantine_tpu/named/curves.py``; IETF pairing-friendly-curves draft,
x = -0xd201000000010000), with the tower and G2 parameters the pairing
needs: Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - (1 + u)), the M-twist
E'/Fp2: y^2 = x^3 + 4(1 + u)."""

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
    fp2_nonresidue: int    # u^2 = fp2_nonresidue
    fp6_nonresidue: tuple  # xi = (c0, c1) in Fp2, v^3 = xi
    twist_kind: str        # "M": E'/Fp2 is y^2 = x^3 + b*xi
    g2_gx: tuple           # G2 generator (Fp2 coordinates as (c0, c1))
    g2_gy: tuple


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
    fp2_nonresidue=-1,
    fp6_nonresidue=(1, 1),
    twist_kind="M",
    g2_gx=(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    g2_gy=(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

CURVES = {BLS12_381.name: BLS12_381}
