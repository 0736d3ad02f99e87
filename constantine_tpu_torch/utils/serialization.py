"""BLS12-381 scalar, G1 and G2 codecs (ZCash compressed format).

Counterpart of the parts of ``constantine_tpu/utils/serialization.py`` the
EIP-4844 paths need: ``scalars_from_bytes``, ``g1_compress_canonical``, a
host big-int G1 decompression for the trusted setup (y = rhs^((p+1)/4)
since p = 3 mod 4, with the flag and sign rules of the reference's
``g1_decompress``; no subgroup check, as the reference's default setup
loading), a host G2 decompression for the setup's G2 points, and the host
halves of the verifier's parsing: ``parse_g1_host`` (the flag and range
rules of ``models/verify_fused.py:parse_g1_host``; K13 does the rest) and
``parse_scalar_host`` (``models/eip4844.py:_parse_scalar_host``).

Byte layout (48 bytes for G1, 96 for G2 as x.c1 || x.c0, big-endian): bit
7 of byte 0 is the compression flag (always 1 here), bit 6 infinity, bit 5
the sign (y lexicographically largest; for Fp2 by c1, or by c0 when c1 is
0).
"""

from __future__ import annotations

import numpy as np

from ..named.curves import BLS12_381
from ..ops import limbs as lb
from . import refmath as rm

_P = BLS12_381.p
_R = BLS12_381.r
_HALF_P = (_P + 1) // 2        # canonical y >= this is "big"
FR_LIMBS = lb.num_limbs(_R.bit_length())


def scalars_from_bytes(data: bytes):
    """(N*32,) bytes -> ((N, 8) canonical u32 limbs, valid mask: value < r)."""
    n = len(data) // 32
    limbs = lb.bytes_be_to_limbs(data, 32, FR_LIMBS)
    be = np.frombuffer(data, dtype=np.uint8).reshape(n, 32)
    r_be = np.frombuffer(_R.to_bytes(32, "big"), dtype=np.uint8)
    lt = np.zeros(n, dtype=np.bool_)
    decided = np.zeros(n, dtype=np.bool_)
    for i in range(32):
        lt |= (~decided) & (be[:, i] < r_be[i])
        decided |= be[:, i] != r_be[i]
    return limbs, lt


def g1_compress_canonical(x_canon, y_big, inf_mask=None) -> bytes:
    """Compressed bytes from canonical x limbs (N, 12) and the y-sign mask."""
    xc = np.asarray(x_canon, np.uint32)
    big = np.asarray(y_big, bool)
    n = xc.shape[0]
    out = np.array(np.frombuffer(lb.limbs_to_bytes_be(xc, 48), np.uint8).reshape(n, 48))
    inf = np.asarray(inf_mask, bool) if inf_mask is not None else np.zeros(n, bool)
    out[inf] = 0
    out[:, 0] |= 0x80
    out[inf, 0] |= 0x40
    out[~inf & big, 0] |= 0x20
    return out.tobytes()


def g1_compress_affine(P) -> bytes:
    """Host big-int affine point (or None) -> 48 compressed bytes."""
    if P is None:
        return bytes([0xC0]) + bytes(47)
    x, y = P
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y >= _HALF_P else 0)
    return bytes(out)


def g1_decompress_host(data: bytes):
    """(N*48,) compressed bytes -> (points, inf, valid) with python ints.

    points[i] is the affine (x, y) or None for infinity and invalid input.
    """
    if len(data) == 0 or len(data) % 48:
        raise ValueError(f"G1 compressed encoding length {len(data)} is not a "
                         "multiple of 48")
    n = len(data) // 48
    points, inf, valid = [], np.zeros(n, bool), np.zeros(n, bool)
    for i in range(n):
        chunk = data[48 * i: 48 * (i + 1)]
        flags = chunk[0]
        comp = bool(flags & 0x80)
        is_inf = bool(flags & 0x40)
        sign = bool(flags & 0x20)
        x = int.from_bytes(bytes([flags & 0x1F]) + chunk[1:], "big")
        inf[i] = is_inf
        if is_inf:
            valid[i] = comp and x == 0 and not sign
            points.append(None)
            continue
        rhs = (x * x * x + BLS12_381.b) % _P
        y = pow(rhs, (_P + 1) // 4, _P)
        ok = comp and x < _P and y * y % _P == rhs
        if (y >= _HALF_P) != sign:
            y = (-y) % _P
        valid[i] = ok
        points.append((x, y) if ok else None)
    return points, inf, valid


def _fp_from_be48(arr: np.ndarray):
    """(N, 48) uint8, flags cleared -> ((N, 12) canonical limbs, value < p)."""
    limbs = lb.bytes_be_to_limbs(arr.tobytes(), 48, lb.num_limbs(_P.bit_length()))
    p_be = np.frombuffer(_P.to_bytes(48, "big"), dtype=np.uint8)
    lt = np.zeros(arr.shape[0], dtype=np.bool_)
    decided = np.zeros(arr.shape[0], dtype=np.bool_)
    for i in range(48):
        lt |= (~decided) & (arr[:, i] < p_be[i])
        decided |= arr[:, i] != p_be[i]
    return limbs, lt


def parse_g1_host(data: bytes):
    """Host half of G1 decompression: (N*48) bytes -> (x canonical (N, 12)
    u32, sign (N,), inf (N,), host_ok (N,)). host_ok holds the flag and
    range rules: the compression bit set; infinity only as x = 0 without
    the sign bit; otherwise x < p. Is-square and the subgroup are K13's."""
    if len(data) == 0 or len(data) % 48:
        raise ValueError(f"G1 compressed encoding length {len(data)} is not a "
                         "multiple of 48")
    arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(-1, 48).copy()
    flags = arr[:, 0]
    comp = (flags & 0x80) != 0
    inf = (flags & 0x40) != 0
    sign = (flags & 0x20) != 0
    arr[:, 0] &= 0x1F
    x_canon, lt_p = _fp_from_be48(arr)
    x_zero = (x_canon == 0).all(axis=1)
    host_ok = np.where(inf, comp & x_zero & ~sign, comp & lt_p)
    return x_canon, sign, inf, host_ok


def parse_scalar_host(data: bytes):
    """32-byte big-endian scalar -> ((8,) canonical u32 limbs, value < r), or
    (None, False) for a wrong length."""
    if data is None or len(data) != 32:
        return None, False
    limbs, valid = scalars_from_bytes(data)
    return limbs[0], bool(valid.all())


def _fp2_is_big(y) -> bool:
    return (y[0] >= _HALF_P) if y[1] == 0 else (y[1] >= _HALF_P)


def g2_decompress_host(data: bytes, subgroup_check: bool = True):
    """(N*96) compressed bytes -> (points, inf, valid) with python ints:
    points[i] is ((x0, x1), (y0, y1)), or None for infinity and invalid
    input. The subgroup check is [r]Q == infinity."""
    if len(data) == 0 or len(data) % 96:
        raise ValueError(f"G2 compressed encoding length {len(data)} is not a "
                         "multiple of 96")
    nr = BLS12_381.fp2_nonresidue
    b2 = rm.fp2_mul((BLS12_381.b, 0), BLS12_381.fp6_nonresidue, nr, _P)
    n = len(data) // 96
    points, inf, valid = [], np.zeros(n, bool), np.zeros(n, bool)
    for i in range(n):
        chunk = data[96 * i: 96 * (i + 1)]
        flags = chunk[0]
        comp, is_inf, sign = bool(flags & 0x80), bool(flags & 0x40), bool(flags & 0x20)
        x1 = int.from_bytes(bytes([flags & 0x1F]) + chunk[1:48], "big")
        x0 = int.from_bytes(chunk[48:], "big")
        inf[i] = is_inf
        if is_inf:
            valid[i] = comp and x0 == 0 and x1 == 0 and not sign
            points.append(None)
            continue
        x = (x0, x1)
        y = None
        if comp and x0 < _P and x1 < _P:
            y = rm.fp2_sqrt(rm.fp2_add(rm.fp2_mul(x, rm.fp2_mul(x, x, nr, _P), nr, _P), b2, _P),
                            nr, _P)
        if y is not None and _fp2_is_big(y) != sign:
            y = rm.fp2_neg(y, _P)
        ok = y is not None and (not subgroup_check
                                or rm.ec2_mul(_R, (x, y), (0, 0), nr, _P) is None)
        valid[i] = ok
        points.append((x, y) if ok else None)
    return points, inf, valid
