"""Ethereum EVM precompiles: 0x02 SHA-256, 0x03 RIPEMD-160 and the EIP-2537
BLS12-381 precompiles (G1/G2 add, MSM, the pairing check and the two maps).

Counterpart of the BLS12-381 and hash part of
``constantine_tpu/models/evm_precompiles.py`` (BN254 and MODEXP are not
ported). Every entry point takes calldata bytes and returns the output
bytes, or None where the input is invalid (the EVM's revert), and takes
``device=`` (default the card; "cpu" runs every kernel's plain version).

Parsing and the choice of branch run on the host: the calldata is public.
The group work runs batched on the device, one call for all the points of
an input: the on-curve checks, the subgroup checks (G1 by Scott's test over
K1 products, G2 by psi(Q) == [u]Q), the adds (K3 on G1, K1 products on G2),
the MSMs (G1 through the kernel pipeline K3-K7, G2 through the GLS-4 split
and the flat route), the pairing check (K11, K12), the SSWU maps with
cofactor clearing, and every affine conversion (K9). The hashes run on the
host.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from ..named.precompute import get_curve
from ..ops import limbs as lb
from ..ops.glv import msm_gls4_g2
from ..ops.msm import msm
from ..ops.pairing import get_pairing
from ..ops.subgroups import is_in_subgroup_g1, is_in_subgroup_g2, scott_beta
from ..utils.hashes import ripemd160, sha256
from .hash_to_curve import get_h2c

_BLS = "BLS12_381"


# ---------------------------------------------------------------------------
# Batched device helpers: one device program over all the points of a call
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _g1_machine(curve: str, device: torch.device):
    """(ctx, add, validate) over G1 on `device`: add(px, py, inf1, qx, qy,
    inf2) -> (on-curve ok, canonical x, y, infinity); validate(px, py, inf,
    subgroup) -> ok (infinity lanes pass the subgroup check)."""
    ctx = get_curve(curve)
    g1, F = ctx.g1, ctx.fp
    beta = F.encode(scott_beta(ctx.p, ctx.r, ctx.params.x_param, ctx.g), device)

    def add(px, py, inf1, qx, qy, inf2):
        P = g1.from_affine((px, py), inf_mask=inf1)
        Q = g1.from_affine((qx, qy), inf_mask=inf2)
        ok = g1.is_on_curve(P) & g1.is_on_curve(Q)
        (x, y), rinf = g1.to_affine(g1.add(P, Q), canonical=True)
        return ok, x, y, rinf

    def validate(px, py, inf, subgroup: bool):
        ok = g1.is_on_curve(g1.from_affine((px, py), inf_mask=inf))
        if subgroup:
            ok = ok & (inf | is_in_subgroup_g1(F, F.mul, beta, px, py, ctx.params.x_param))
        return ok

    return ctx, add, validate


@functools.lru_cache(maxsize=None)
def _g2_machine(curve: str, device: torch.device):
    """(ctx, add, validate) over G2 on `device`, as ``_g1_machine``; add
    returns Montgomery x and y."""
    ctx = get_curve(curve)
    g2 = ctx.g2

    def add(px, py, inf1, qx, qy, inf2):
        P = g2.from_affine((px, py), inf_mask=inf1)
        Q = g2.from_affine((qx, qy), inf_mask=inf2)
        ok = g2.is_on_curve(P) & g2.is_on_curve(Q)
        (x, y), rinf = g2.to_affine(g2.add(P, Q))
        return ok, x, y, rinf

    def validate(px, py, inf, subgroup: bool):
        P = g2.from_affine((px, py), inf_mask=inf)
        ok = g2.is_on_curve(P)
        if subgroup:
            ok = ok & (inf | is_in_subgroup_g2(ctx, P))
        return ok

    return ctx, add, validate


# ---------------------------------------------------------------------------
# Hash precompiles (0x02 / 0x03), on the host
# ---------------------------------------------------------------------------


def eth_evm_sha256(data: bytes, device="cuda") -> bytes:
    resolve_device(device)
    return sha256(data)


def eth_evm_ripemd160(data: bytes, device="cuda") -> bytes:
    """The digest left-padded to 32 bytes."""
    resolve_device(device)
    return b"\x00" * 12 + ripemd160(data)


# ---------------------------------------------------------------------------
# EIP-2537: BLS12-381 (field elements as 64 bytes, the top 16 zero)
# ---------------------------------------------------------------------------


def _bls_parse_fp(chunk: bytes):
    """64 bytes: the top 16 must be zero and the value below p."""
    if chunk[:16] != b"\x00" * 16:
        return None
    v = int.from_bytes(chunk[16:64], "big")
    return None if v >= get_curve(_BLS).p else v


def _bls_fp_bytes(v: int) -> bytes:
    return b"\x00" * 16 + v.to_bytes(48, "big")


def _bls_parse_g1(data: bytes):
    """128 bytes (x, y) -> ((x, y), inf, ok) python ints: the encoding and
    the range only; the curve and subgroup checks run on the device."""
    x = _bls_parse_fp(data[:64])
    y = _bls_parse_fp(data[64:128])
    if x is None or y is None:
        return None, False, False
    if x == 0 and y == 0:
        return (0, 0), True, True
    return (x, y), False, True


def _bls_g1_bytes(pt, inf) -> bytes:
    if inf:
        return b"\x00" * 128
    return _bls_fp_bytes(pt[0]) + _bls_fp_bytes(pt[1])


def _bls_parse_g2(data: bytes):
    """256 bytes (x_c0, x_c1, y_c0, y_c1) -> (((x), (y)), inf, ok)."""
    vals = [_bls_parse_fp(data[i * 64:(i + 1) * 64]) for i in range(4)]
    if any(v is None for v in vals):
        return None, False, False
    if all(v == 0 for v in vals):
        return ((0, 0), (0, 0)), True, True
    return ((vals[0], vals[1]), (vals[2], vals[3])), False, True


def _bls_g2_bytes(pt, inf) -> bytes:
    if inf:
        return b"\x00" * 256
    (x, y) = pt
    return (_bls_fp_bytes(x[0]) + _bls_fp_bytes(x[1])
            + _bls_fp_bytes(y[0]) + _bls_fp_bytes(y[1]))


def _g2_out(fp2, x, y, inf) -> bytes:
    """A (1, 2, NL) Montgomery affine G2 point -> 256 bytes."""
    if bool(inf[0]):
        return b"\x00" * 256
    xv, yv = fp2.decode(x), fp2.decode(y)
    return _bls_g2_bytes(((xv[0], xv[1]), (yv[0], yv[1])), False)


def _g1_out(x, y, inf) -> bytes:
    """A (1, NL) canonical affine G1 point -> 128 bytes."""
    if bool(inf[0]):
        return b"\x00" * 128
    return _bls_g1_bytes((lb.limbs_to_ints(x)[0], lb.limbs_to_ints(y)[0]), False)


def _g2_encode(fp2, pts, dev):
    """Host affine G2 points -> Montgomery (n, 2, NL) x, y on dev."""
    return tuple(fp2.F.encode([c for q in pts for c in q[i]], dev).reshape(len(pts), 2, -1)
                 for i in (0, 1))


def eth_evm_bls12381_g1add(data: bytes, device="cuda"):
    """G1ADD: on-curve checks and the complete add (no subgroup check, as
    the EIP says)."""
    dev = resolve_device(device)
    if len(data) != 256:
        return None
    P, inf1, ok1 = _bls_parse_g1(data[:128])
    Q, inf2, ok2 = _bls_parse_g1(data[128:])
    if not (ok1 and ok2):
        return None
    ctx, addf, _ = _g1_machine(_BLS, dev)
    enc = ctx.fp.encode
    ok, x, y, rinf = addf(enc([P[0]], dev), enc([P[1]], dev), torch.tensor([inf1], device=dev),
                          enc([Q[0]], dev), enc([Q[1]], dev), torch.tensor([inf2], device=dev))
    if not bool(ok[0]):
        return None
    return _g1_out(x, y, rinf)


def eth_evm_bls12381_g1msm(data: bytes, device="cuda"):
    """G1MSM: k (128-byte point, 32-byte scalar) pairs; every point on the
    curve and in G1."""
    dev = resolve_device(device)
    if len(data) == 0 or len(data) % 160 != 0:
        return None
    ctx, _, g1val = _g1_machine(_BLS, dev)
    pts, scalars, infs = [], [], []
    for i in range(len(data) // 160):
        chunk = data[i * 160:(i + 1) * 160]
        P, inf, ok = _bls_parse_g1(chunk[:128])
        if not ok:
            return None
        pts.append(ctx.g if inf else P)          # infinity: the generator times 0
        scalars.append(0 if inf else int.from_bytes(chunk[128:160], "big"))
        infs.append(inf)
    px = ctx.fp.encode([q[0] for q in pts], dev)
    py = ctx.fp.encode([q[1] for q in pts], dev)
    if not bool(g1val(px, py, torch.tensor(infs, device=dev), True).all()):
        return None
    sl = ctx.scalars_to_limbs([s % ctx.r for s in scalars], dev)
    R = msm(ctx.g1, (px, py), sl, scalar_bits=255)
    (x, y), inf = ctx.g1.to_affine(tuple(t[None] for t in R), canonical=True)
    return _g1_out(x, y, inf)


def eth_evm_bls12381_g2add(data: bytes, device="cuda"):
    """G2ADD: on-curve checks and the complete Fp2 add."""
    dev = resolve_device(device)
    if len(data) != 512:
        return None
    P, inf1, ok1 = _bls_parse_g2(data[:256])
    Q, inf2, ok2 = _bls_parse_g2(data[256:])
    if not (ok1 and ok2):
        return None
    ctx, addf, _ = _g2_machine(_BLS, dev)
    fp2 = ctx.g2.F
    gen = ctx.g2_aff
    px, py = _g2_encode(fp2, [gen if inf1 else P], dev)
    qx, qy = _g2_encode(fp2, [gen if inf2 else Q], dev)
    ok, x, y, rinf = addf(px, py, torch.tensor([inf1], device=dev),
                          qx, qy, torch.tensor([inf2], device=dev))
    if not bool(ok[0]):
        return None
    return _g2_out(fp2, x, y, rinf)


def eth_evm_bls12381_g2msm(data: bytes, device="cuda"):
    """G2MSM: k (256-byte point, 32-byte scalar) pairs; every point on the
    twist and in G2. The MSM splits each scalar by GLS-4."""
    dev = resolve_device(device)
    if len(data) == 0 or len(data) % 288 != 0:
        return None
    ctx, _, g2val = _g2_machine(_BLS, dev)
    fp2 = ctx.g2.F
    pts, scalars, infs = [], [], []
    for i in range(len(data) // 288):
        chunk = data[i * 288:(i + 1) * 288]
        P, inf, ok = _bls_parse_g2(chunk[:256])
        if not ok:
            return None
        pts.append(ctx.g2_aff if inf else P)
        scalars.append(0 if inf else int.from_bytes(chunk[256:288], "big"))
        infs.append(inf)
    qx, qy = _g2_encode(fp2, pts, dev)
    if not bool(g2val(qx, qy, torch.tensor(infs, device=dev), True).all()):
        return None
    sl = ctx.scalars_to_limbs([s % ctx.r for s in scalars], dev)
    R = msm_gls4_g2(ctx, (qx, qy), sl)
    (x, y), inf = ctx.g2.to_affine(tuple(t[None] for t in R))
    return _g2_out(fp2, x, y, inf)


def eth_evm_bls12381_pairingcheck(data: bytes, device="cuda"):
    """k (128-byte G1, 256-byte G2) pairs -> 32 bytes, 1 when the product of
    the pairings is one. Every point on its curve and in its subgroup; a
    pair with a point at infinity contributes one."""
    dev = resolve_device(device)
    if len(data) == 0 or len(data) % 384 != 0:
        return None
    pr = get_pairing(_BLS)
    ctx = pr.ctx
    g1s, g2s, inf1s, inf2s = [], [], [], []
    for i in range(len(data) // 384):
        chunk = data[i * 384:(i + 1) * 384]
        P, inf1, ok1 = _bls_parse_g1(chunk[:128])
        Q, inf2, ok2 = _bls_parse_g2(chunk[128:384])
        if not (ok1 and ok2):
            return None
        inf1s.append(inf1)
        inf2s.append(inf2)
        g1s.append(ctx.g if inf1 else P)
        g2s.append(ctx.g2_aff if inf2 else Q)
    px = ctx.fp.encode([q[0] for q in g1s], dev)
    py = ctx.fp.encode([q[1] for q in g1s], dev)
    qx, qy = _g2_encode(pr.fp2, g2s, dev)
    i1 = torch.tensor(inf1s, device=dev)
    i2 = torch.tensor(inf2s, device=dev)
    _, _, g1val = _g1_machine(_BLS, dev)
    _, _, g2val = _g2_machine(_BLS, dev)
    if not bool((g1val(px, py, i1, True) & g2val(qx, qy, i2, True)).all()):
        return None
    ok = pr.pairing_check((px, py), (qx, qy), skip_mask=i1 | i2)
    return int(ok).to_bytes(32, "big")


def eth_evm_bls12381_map_fp_to_g1(data: bytes, device="cuda"):
    """64 bytes (an Fp element) -> 128 bytes: the SSWU map and [h_eff]
    clearing (RFC 9380's map_to_curve and clear_cofactor)."""
    dev = resolve_device(device)
    if len(data) != 64:
        return None
    v = _bls_parse_fp(data)
    if v is None:
        return None
    h2c = get_h2c()
    g1 = h2c.ctx.g1
    x, y = h2c.g1_map.map_to_curve(h2c.fp.encode([v], dev))
    (ax, ay), inf = g1.to_affine(h2c._clear_g1(g1.from_affine((x, y))), canonical=True)
    return _g1_out(ax, ay, inf)


def eth_evm_bls12381_map_fp2_to_g2(data: bytes, device="cuda"):
    """128 bytes (an Fp2 element c0, c1) -> 256 bytes: the SSWU map to the
    twist and [h_eff] clearing."""
    dev = resolve_device(device)
    if len(data) != 128:
        return None
    c0, c1 = _bls_parse_fp(data[:64]), _bls_parse_fp(data[64:])
    if c0 is None or c1 is None:
        return None
    h2c = get_h2c()
    g2 = h2c.ctx.g2
    x, y = h2c.g2_map.map_to_curve(h2c.fp2.encode([c0, c1], dev)[None])
    (ax, ay), inf = g2.to_affine(h2c._clear_g2(g2.from_affine((x, y))))
    return _g2_out(h2c.fp2, ax, ay, inf)
