"""BLS12-381 scalar, G1 and G2 codecs (ZCash compressed format).

Counterpart of ``constantine_tpu/utils/serialization.py``. ``BLS12381Codec``
(``get_codec``) is the device codec of the signatures: ``g1_compress`` and
``g2_compress`` of Montgomery affine tensors, ``g1_decompress`` (the flags
on the host, then K13: root, sign and subgroup bit) and ``g2_decompress``
(the flags and both coordinates below p on the host, then the Fp2 root,
the sign rule, and psi(Q) == [u]Q on the device). Besides it, for the
EIP-4844 paths: ``scalars_from_bytes``, ``g1_compress_canonical``, a
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

import functools

import numpy as np
import torch

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


def _host_mask(m):
    """A bool mask (torch, numpy or None) as a numpy array (or None)."""
    if m is None:
        return None
    if isinstance(m, torch.Tensor):
        return m.cpu().numpy().astype(bool)
    return np.asarray(m, bool)


class BLS12381Codec:
    """Compressed G1 and G2 points <-> Montgomery affine tensors on a device.
    Every decompression returns ((x, y), inf, valid), inf and valid numpy
    bool masks: valid holds the flag rules, x < p, the square root and the
    subgroup check; infinity is valid only as the bare flag."""

    def __init__(self):
        from ..named.precompute import get_curve
        from ..ops.sqrt import get_sqrt_fp2
        from ..ops.towers import build_tower
        self.ctx = get_curve("BLS12_381")
        self.fp = self.ctx.fp
        self.fp2 = build_tower(self.ctx)[0]
        self._sq2 = get_sqrt_fp2("BLS12_381")
        self._half = self.fp.from_int(_HALF_P)                   # canonical y >= this is big
        self._b2 = self.fp2.encode(list(self.ctx.g2_b()))
        self._dev = {}

    def _consts(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (self._half.to(device), self._b2.to(device))
        return self._dev[device]

    def _is_big(self, yc):
        """Lexicographic sign of canonical y: y >= (p + 1) / 2."""
        half = self._consts(yc.device)[0]
        return lb.geq(yc, half.expand_as(yc))

    # -- G1 ---------------------------------------------------------------------

    def g1_compress(self, xy, inf_mask=None) -> bytes:
        """Montgomery affine (x, y) (N, NL) (+ inf mask) -> N*48 bytes."""
        x, y = xy
        c = self.fp.from_mont(torch.stack([x, y]))
        big = self._is_big(c[1])
        return g1_compress_canonical(lb.to_numpy(c[0]), big.cpu().numpy(), _host_mask(inf_mask))

    def g1_decompress(self, data: bytes, device):
        """N*48 bytes -> ((x, y) Montgomery (N, NL) on `device`, inf, valid):
        the flags on the host, then one K13 launch over every lane (x = 0 on
        infinity lanes)."""
        from ..ops.cuda_g1 import get_cuda_g1
        x_canon, sign, inf, host_ok = parse_g1_host(data)
        x_canon[inf] = 0
        (xm, y), ok = get_cuda_g1("BLS12_381").decompress(
            lb.to_tensor(x_canon, device), torch.from_numpy(sign).to(device))
        valid = host_ok & (inf | ok.cpu().numpy())
        return (xm, y), inf, valid

    # -- G2 ---------------------------------------------------------------------

    def g2_compress(self, xy, inf_mask=None) -> bytes:
        """Montgomery affine (x, y) (N, 2, NL) (+ inf mask) -> N*96 bytes,
        x as c1 || c0; the sign is c1's, or c0's where c1 = 0."""
        x, y = xy
        c = self.fp.from_mont(torch.stack([x, y]))
        yc = c[1]
        big = torch.where((yc[:, 1] == 0).all(-1), self._is_big(yc[:, 0]),
                          self._is_big(yc[:, 1])).cpu().numpy()
        xc = lb.to_numpy(c[0])
        n = xc.shape[0]
        b1 = np.frombuffer(lb.limbs_to_bytes_be(xc[:, 1], 48), np.uint8).reshape(n, 48)
        b0 = np.frombuffer(lb.limbs_to_bytes_be(xc[:, 0], 48), np.uint8).reshape(n, 48)
        out = np.concatenate([b1, b0], axis=1)
        inf = _host_mask(inf_mask) if inf_mask is not None else np.zeros(n, bool)
        out[inf] = 0
        out[:, 0] |= 0x80
        out[inf, 0] |= 0x40
        out[~inf & big, 0] |= 0x20
        return out.tobytes()

    def g2_decompress(self, data: bytes, device, subgroup_check: bool = True):
        """N*96 bytes -> ((x, y) Montgomery (N, 2, NL) on `device`, inf,
        valid). Raises ValueError on a length that is not a multiple of 96."""
        if len(data) == 0 or len(data) % 96:
            raise ValueError(f"G2 compressed encoding length {len(data)} is not a "
                             "multiple of 96")
        arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(-1, 96).copy()
        flags = arr[:, 0].copy()
        comp, inf, sign = (flags & 0x80) != 0, (flags & 0x40) != 0, (flags & 0x20) != 0
        arr[:, 0] &= 0x1F
        c1, lt1 = _fp_from_be48(arr[:, :48])
        c0, lt0 = _fp_from_be48(arr[:, 48:])
        x_canon = np.stack([c0, c1], axis=1)
        x_zero = (x_canon == 0).all(axis=(1, 2))
        fp, fp2 = self.fp, self.fp2
        xm = fp.to_mont(lb.to_tensor(x_canon, device))
        rhs = fp2.add(fp2.mul(fp2.square(xm), xm), self._consts(device)[1].expand_as(xm))
        y, is_sq = self._sq2.sqrt(rhs)
        yc = fp.from_mont(y)
        big = torch.where((yc[:, 1] == 0).all(-1), self._is_big(yc[:, 0]),
                          self._is_big(yc[:, 1]))
        y = fp2.cselect(big != torch.from_numpy(sign).to(device), fp2.neg(y), y)
        ok = is_sq
        if subgroup_check:
            from ..ops.subgroups import is_in_subgroup_g2
            ok = ok & is_in_subgroup_g2(self.ctx, self.ctx.g2.from_affine((xm, y)))
        valid = np.where(inf, comp & x_zero & ~sign, comp & lt0 & lt1 & ok.cpu().numpy())
        return (xm, y), inf, valid


@functools.lru_cache(maxsize=None)
def get_codec() -> BLS12381Codec:
    return BLS12381Codec()
