"""Limb layout of the port: host conversions and int64 carry handling.

Counterpart of ``constantine_tpu/ops/limbs.py``. The reference stores 16-bit
digits in u32 lanes; the port stores 32-bit limbs, as ``int32`` tensors that
hold the u32 bit patterns (torch has no usable unsigned 32-bit arithmetic on
the CPU). Limb i of the port is digits 2i (low half) and 2i+1 (high half) of
the reference, which is the reference's own ``_pack16``.

Plain (non-kernel) arithmetic runs in ``int64``: 32-bit limbs for add and
subtract, 16-bit digits for products, whose column sums then stay below 2^38.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
DIGIT_BITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1

# ---------------------------------------------------------------------------
# Host conversions (python int / bytes <-> u32 limb arrays)
# ---------------------------------------------------------------------------


def num_limbs(bits: int) -> int:
    """Number of 32-bit limbs for a `bits`-bit integer."""
    return -(-bits // LIMB_BITS)


def int_to_limbs(x: int, n: int) -> np.ndarray:
    """Python int -> (n,) uint32 little-endian 32-bit limbs."""
    if x < 0:
        raise ValueError("negative")
    if x >> (LIMB_BITS * n):
        raise ValueError("integer does not fit in limbs")
    return np.frombuffer(x.to_bytes(4 * n, "little"), dtype="<u4").astype(np.uint32)


def limbs_to_int(a) -> int:
    """(n,) limb array -> python int."""
    return int.from_bytes(np.asarray(a, dtype="<u4").tobytes(), "little")


def ints_to_limbs(xs, n: int) -> np.ndarray:
    """Iterable of python ints -> (N, n) uint32 limbs."""
    xs = list(xs)
    out = np.zeros((len(xs), n), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[j] = int_to_limbs(x, n)
    return out


def limbs_to_ints(a) -> list:
    """(..., n) limb array or int32 tensor -> python ints (flattened batch)."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.uint32)
    flat = a.reshape(-1, a.shape[-1])
    return [limbs_to_int(row) for row in flat]


def bytes_be_to_limbs(data: bytes, nbytes: int, n: int) -> np.ndarray:
    """N concatenated `nbytes`-wide big-endian integers -> (N, n) limbs."""
    if nbytes % 4:
        raise ValueError("nbytes must be a multiple of 4")
    cnt = len(data) // nbytes
    words = np.frombuffer(data, dtype=">u4").reshape(cnt, nbytes // 4)
    words = words[:, ::-1].astype(np.uint32)          # little-endian limbs
    if words.shape[1] < n:
        words = np.pad(words, ((0, 0), (0, n - words.shape[1])))
    return np.ascontiguousarray(words[:, :n])


def limbs_to_bytes_be(a, nbytes: int) -> bytes:
    """(N, n) limbs -> concatenated big-endian byte strings of width nbytes."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.uint32)
    if a.ndim == 1:
        a = a[None]
    return a[:, : nbytes // 4].astype(">u4")[:, ::-1].tobytes()


def pack16(d) -> np.ndarray:
    """(..., 2n) u32 16-bit digits -> (..., n) u32 limbs (reference _pack16)."""
    d = np.asarray(d, np.uint32)
    return d[..., 0::2] | (d[..., 1::2] << np.uint32(16))


def unpack16(a) -> np.ndarray:
    """(..., n) u32 limbs -> (..., 2n) u32 16-bit digits."""
    a = np.asarray(a, np.uint32)
    out = np.empty(a.shape[:-1] + (2 * a.shape[-1],), np.uint32)
    out[..., 0::2] = a & np.uint32(DIGIT_MASK)
    out[..., 1::2] = a >> np.uint32(16)
    return out


def to_tensor(a, device="cpu") -> torch.Tensor:
    """uint32 numpy limbs -> int32 tensor with the same bit patterns."""
    arr = np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array with the same bit patterns."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# int64 helpers for the plain (torch) arithmetic
# ---------------------------------------------------------------------------


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 limb values in [0, 2^32)."""
    return t.to(torch.int64) & LIMB_MASK


def narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 limb values in [0, 2^32) -> int32 bit patterns (the conversion
    keeps the low 32 bits, two's complement)."""
    return v.to(torch.int32)


def to_digits(t: torch.Tensor) -> torch.Tensor:
    """int32 (..., n) limbs -> int64 (..., 2n) 16-bit digits."""
    v = widen(t)
    return torch.stack([v & DIGIT_MASK, v >> DIGIT_BITS], -1).flatten(-2)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """int64 (..., 2n) canonical 16-bit digits -> int32 (..., n) limbs."""
    return narrow(d[..., 0::2] | (d[..., 1::2] << DIGIT_BITS))


def normalize(x: torch.Tensor, bits: int):
    """Propagate carries (or borrows) along the last axis.

    x: int64 (..., n) digits of any sign and size well below 2^62. Returns
    (digits in [0, 2^bits), signed carry out of the top digit). Loops until
    no digit carries, so a long ripple (0xFF..FF + 1) is resolved exactly.
    """
    mask = (1 << bits) - 1
    c = x >> bits
    x = x & mask                      # the first round needs no check: one
    out = c[..., -1].clone()          # host sync in the common case
    x[..., 1:] += c[..., :-1]
    while True:
        c = x >> bits
        if not bool(c.any()):
            return x, out
        x = x & mask
        out = out + c[..., -1]
        x[..., 1:] += c[..., :-1]


def carry_round(x: torch.Tensor, bits: int, keep_top: bool = False) -> torch.Tensor:
    """One carry round: every digit keeps its low `bits` and passes the rest
    one place up. The top digit's carry is dropped (the value is kept mod
    2^(bits*n)), or with keep_top stays in the top digit."""
    c = x >> bits
    y = x & ((1 << bits) - 1)
    y[..., 1:] += c[..., :-1]
    if keep_top:
        y[..., -1] += c[..., -1] << bits
    return y


def diagonal_sum_matrix(d1: int, d2: int) -> np.ndarray:
    """0/1 matrix S (d1*d2, d1+d2-1) with S[i*d2 + j, i+j] = 1: a flattened
    outer product times S gives the schoolbook column sums."""
    S = np.zeros((d1 * d2, d1 + d2 - 1), np.float64)
    i, j = np.divmod(np.arange(d1 * d2), d2)
    S[np.arange(d1 * d2), i + j] = 1
    return S


def toeplitz_matrix(digits, d1: int, width: int) -> np.ndarray:
    """(d1, width) matrix with row i holding the constant's digits from
    column i on: x @ T gives the column sums of x * constant."""
    T = np.zeros((d1, width), np.float64)
    for i in range(d1):
        n = min(len(digits), width - i)
        if n > 0:
            T[i, i:i + n] = digits[:n]
    return T


def column_products(x: torch.Tensor, y: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums c_k = sum_{i+j=k} x_i y_j of digit vectors
    x (B, D1), y (B, D2), with S = diagonal_sum_matrix(D1, D2).

    Computed in float64: every product is below 2^32 and every partial sum
    below 2^38, so each value is an integer float64 holds exactly, in any
    summation order.
    """
    B, D1 = x.shape
    xf, yf = x.to(torch.float64), y.to(torch.float64)
    if B < 1024:                      # one matmul: fewest ops for narrow batches
        return ((xf[:, :, None] * yf[:, None, :]).reshape(B, -1) @ S).to(torch.int64)
    out = torch.zeros((B, S.shape[1]), dtype=torch.float64, device=x.device)
    for i in range(D1):               # D1 shifted rows: less work on wide ones
        out[:, i:i + yf.shape[1]] += xf[:, i:i + 1] * yf
    return out.to(torch.int64)


_ARANGE = {}


def arange_on(n: int, device, scale: int = 1, offset: int = 0, first: int = 0) -> torch.Tensor:
    """scale * i + offset for i < n, plus `first` at i = 0, int64 on
    `device`, made there (no copy from the host) and cached."""
    key = (n, torch.device(device), scale, offset, first)
    if key not in _ARANGE:
        i = torch.arange(n, dtype=torch.int64, device=device)
        _ARANGE[key] = scale * i + offset + first * (i == 0)
    return _ARANGE[key]


def ripple(s: torch.Tensor, bits: int = LIMB_BITS):
    """Carry a vector of limb sums along the last axis without a host read.

    s: int64 (..., n) limb sums in [0, 2^(bits+1) - 1), so each limb sends
    at most one carry up. Limb i passes its carry-in on iff s_i = 2^bits - 1,
    so the carry out of limb i is that of the last limb j <= i that does not
    pass, s_j >> bits (0 if none): a running max of the key
    2j + 2 + (s_j >> bits) (0 where the limb passes), low bit. Returns (limbs
    in [0, 2^bits), carry out of the top limb)."""
    mask = (1 << bits) - 1
    base = arange_on(s.shape[-1], s.device, 2, 2)
    key = torch.where(s == mask, 0, base + (s >> bits))
    cout = torch.cummax(key, -1).values & 1
    cin = torch.nn.functional.pad(cout[..., :-1], (1, 0))
    return (s + cin) & mask, cout[..., -1]


def add_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a + b) on int64 limb values whose limb sums stay below 2^33, no host
    read: (limbs mod 2^(32n), carry 0/1)."""
    return ripple(a + b)


def sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) on int64 32-bit limb values, no host read: a + ~b + 1 (the
    complement limb by limb, +1 on limb 0) carried, as (limbs mod
    2^(32n), 1 where a >= b)."""
    return ripple(a - b + arange_on(a.shape[-1], a.device, 0, LIMB_MASK, first=1))


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """(a - b) on int64 32-bit limb values: (limbs mod 2^(32n), borrow 0/1)."""
    d, c = normalize(a - b, LIMB_BITS)
    return d, -c


def add_carry(a: torch.Tensor, b: torch.Tensor):
    """(a + b) on int64 32-bit limb values: (limbs mod 2^(32n), carry 0/1)."""
    return normalize(a + b, LIMB_BITS)


def cselect(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, broadcasting cond over the limb axis."""
    return torch.where(cond[..., None], a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b as (...,) bool, int32 canonical limbs."""
    _, borrow = sub_borrow(widen(a), widen(b))
    return borrow == 0
