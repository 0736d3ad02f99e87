"""K1: batched Montgomery multiply -- kernel wrapper and plain version.

Counterpart of ``constantine_tpu/ops/pallas_field.py`` (``PallasMontMul``).
``mont_mul`` launches ``csrc/field_kernels.cu:ctt_mont_mul`` on CUDA
tensors and runs ``mont_mul_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from . import limbs as lb


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, F) -> torch.Tensor:
    """a * b * R^-1 mod p in torch int64 ops, on any device.

    One-shot Montgomery reduction over 16-bit digits (D per element):

    1. T = a*b as column sums (< 2^37, see limbs.column_products);
    2. m = (T mod R) * (-p^-1) mod R, from T's low columns after one carry
       round (digits < 2^22, so these column sums stay below 2^42);
    3. S = T + m*p = 0 mod R. Three carry rounds leave every digit <= 2^16
       + 1, so S's low half is worth exactly 0 or R: it carries 1 into the
       high half iff a low digit is non-zero;
    4. the high half, < 2p, then one conditional -p.
    """
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    c = F.consts(a.device)
    D = 2 * F.NL
    x = lb.to_digits(a.reshape(-1, F.NL))
    y = lb.to_digits(b.reshape(-1, F.NL))
    t = lb.column_products(x, y, c["diag"])                          # (B, 2D-1)
    t_lo = lb.carry_round(t[:, :D], lb.DIGIT_BITS)                   # = T mod R
    m, _ = lb.normalize((t_lo.to(torch.float64) @ c["nprime_t"]).to(torch.int64),
                        lb.DIGIT_BITS)                               # exact, mod R
    s = torch.nn.functional.pad(t + (m.to(torch.float64) @ c["p_t"]).to(torch.int64),
                                (0, 2))                              # (B, 2D+1)
    for _ in range(3):
        s = lb.carry_round(s, lb.DIGIT_BITS, keep_top=True)
    r = s[:, D:2 * D].clone()
    r[:, 0] += (s[:, :D] != 0).any(-1)
    r[:, -1] += s[:, 2 * D] << lb.DIGIT_BITS
    r, _ = lb.normalize(r, lb.DIGIT_BITS)
    d, borrow = lb.normalize(r - c["p16"], lb.DIGIT_BITS)
    out = torch.where((borrow == 0)[:, None], d, r)
    return lb.from_digits(out).reshape(shape)


def mont_mul(a: torch.Tensor, b: torch.Tensor, F) -> torch.Tensor:
    """Field.mul: the K1 kernel on CUDA tensors, the plain version on CPU."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b, F)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul takes int32 limb tensors")
    a, b = torch.broadcast_tensors(a, b)
    if a.shape[-1] != F.NL:
        raise ValueError(f"mont_mul: last axis {a.shape[-1]} != {F.NL} limbs")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // F.NL
    build.KERNELS["mont_mul"](
        a.device, F.NL, ctypes.c_void_p(F.mod_words.ctypes.data),
        build.ptr(a), build.ptr(b), build.ptr(out), n)
    return out
