"""BLS12-381 scalar and G1 codecs (ZCash compressed format).

Counterpart of the parts of ``constantine_tpu/utils/serialization.py`` the
commitment path needs: ``scalars_from_bytes``, ``g1_compress_canonical``,
and a host big-int G1 decompression for the trusted setup (y =
rhs^((p+1)/4) since p = 3 mod 4, with the flag and sign rules of the
reference's ``g1_decompress``; no subgroup check, as the reference's
default setup loading).

Byte layout (48 bytes, big-endian): bit 7 of byte 0 is the compression flag
(always 1 here), bit 6 infinity, bit 5 the sign (y lexicographically
largest).
"""

from __future__ import annotations

import numpy as np

from ..named.curves import BLS12_381
from ..ops import limbs as lb

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
