"""Field kernels -- wrappers and plain versions.

K1, the batched Montgomery multiply: counterpart of
``constantine_tpu/ops/pallas_field.py`` (``PallasMontMul``). ``mont_prod``
computes a chain (f0 * ... * f_{m-1})^(2^k) of up to four factors and any
squarings in one launch of ``csrc/field_kernels.cu:ctt_mont_prod`` on CUDA
tensors, reading a broadcast factor in place, and runs ``mont_prod_plain``
(a chain of ``mont_mul_plain``) on CPU tensors; ``mont_mul`` is its m = 2,
k = 0 case.

K8-K10, batched inversion: ``CudaAffine``, counterpart of
``constantine_tpu/ops/pallas_ec.py`` (``PallasAffine``), for 12-limb Fp and
8-limb Fr.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from . import limbs as lb

CHAIN_MAX_C = 32    # csrc/chain.cuh: K8's and K10's links a chain, one block row each


def _on_cuda(*ts) -> bool:
    """True if every tensor is on one CUDA device, False if all on the CPU."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("kernels take contiguous int32 limb tensors")
    return True


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


def _rows(t: torch.Tensor, batch: torch.Size):
    """t as a factor of a product over the batch shape `batch`: (core,
    period), where element i of the flattened batch reads row i mod period
    of core (..., NL). t's leading axes may be missing, of size 1 or
    broadcast (stride 0); the rest must be batch's last axes. Any other
    broadcast raises: the kernel reads a factor where it lies."""
    core = t
    while core.dim() > 1 and (core.shape[0] == 1 or core.stride(0) == 0):
        core = core[0]
    tail = core.shape[:-1]
    if (len(tail) > len(batch) or tuple(batch[len(batch) - len(tail):]) != tuple(tail)
            or any(st == 0 and sz > 1 for sz, st in zip(core.shape, core.stride()))):
        raise ValueError(f"mont_prod: a factor of shape {tuple(t.shape)} is not a periodic "
                         f"broadcast over {tuple(batch)}")
    return core, max(1, core.numel() // core.shape[-1])


def mont_prod_plain(F, *factors, squarings: int = 0) -> torch.Tensor:
    """(f0 * ... * f_{m-1})^(2^squarings), products left to right, as a chain
    of mont_mul_plain; broadcasts like torch."""
    _check_chain(len(factors), squarings)
    acc = factors[0]
    for f in factors[1:]:
        acc = mont_mul_plain(acc, f, F)
    for _ in range(squarings):
        acc = mont_mul_plain(acc, acc, F)
    return acc


def _check_chain(m: int, squarings: int):
    if not 1 <= m <= 4 or squarings < 0 or m - 1 + squarings < 1:
        raise ValueError(f"mont_prod takes 1-4 factors and k >= 0 squarings, at least one "
                         f"product (got m = {m}, k = {squarings})")


def mont_prod(F, *factors, squarings: int = 0) -> torch.Tensor:
    """(f0 * ... * f_{m-1})^(2^squarings) in Montgomery form, 1 <= m <= 4:
    one K1 launch on CUDA tensors, mont_prod_plain on CPU tensors.

    The factors broadcast against each other as in torch, but only
    periodically: each factor is its own rows repeated down the batch
    (_rows), so a constant, a row of the batch's last axes or an
    ``expand`` of either is read in place, never copied. On the card every
    factor's rows start 16-byte aligned (the kernel moves 16-byte words)."""
    _check_chain(len(factors), squarings)
    f0 = factors[0]
    dev, shape = f0.device, f0.shape
    uniform = True
    for f in factors:
        if f.device != dev:
            raise ValueError(f"mont_prod: operands on {f.device} and {dev}")
        uniform = uniform and f.shape == shape and f.is_contiguous()
    if not uniform:
        shape = torch.broadcast_shapes(*(f.shape for f in factors))
    if shape[-1] != F.NL:
        raise ValueError(f"mont_prod: last axis {shape[-1]} != {F.NL} limbs")
    if uniform:
        rows = [(f, None) for f in factors]             # every factor full, in place
    else:
        rows = [_rows(f, shape[:-1]) for f in factors]
    if dev.type == "cpu":
        return mont_prod_plain(F, *factors, squarings=squarings)
    if dev.type != "cuda":
        raise ValueError(f"mont_prod: unsupported device {dev}")
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel() // F.NL
    if n == 0:
        return out
    ptrs, periods = [0] * 4, [1] * 4
    for j, (core, period) in enumerate(rows):
        if core.dtype != torch.int32:
            raise TypeError("mont_prod takes int32 limb tensors")
        if not core.is_contiguous():
            # a strided layout, not a broadcast; held in `rows` until the launch
            core = core.contiguous()
            rows[j] = core, period
        ptrs[j], periods[j] = core.data_ptr(), period or n
        if ptrs[j] % 16:
            raise ValueError("mont_prod: a factor's rows are not 16-byte aligned")
    build.KERNELS["mont_mul"](dev, F.NL, F.mod_ptr, len(factors), squarings, *ptrs, *periods,
                              out.data_ptr(), n)
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor, F) -> torch.Tensor:
    """Field.mul: a * b * R^-1 mod p, mont_prod's m = 2, k = 0 case."""
    return mont_prod(F, a, b)


class CudaAffine:
    """K8-K10: batched inversion over a field F (Montgomery form in and out).

    Planar layouts, the lane axis contiguous: chains (C, NL, Mw), lanes
    (NL, Wd). On CUDA tensors each method launches its kernel; on CPU
    tensors it runs the plain version beside it. No method handles 0 (a
    zero zeroes its whole chain): Field.batch_inv masks zeros out first.
    """

    def __init__(self, F):
        self.F = F
        self.NL = F.NL
        self._mod = ctypes.c_void_p(F.mod_words.ctypes.data)
        e = F.p_int - 2                                   # the plain version: x^(p-2)
        self.exp_int = e
        self.exp_bits = e.bit_length()
        # the kernel's safegcd inverts the integer aR; a product by R^3 mod p
        # gives a^-1 R
        self._r3_words = lb.int_to_limbs(pow(2, 96 * F.NL, F.p_int), F.NL)
        self._r3 = ctypes.c_void_p(self._r3_words.ctypes.data)

    def _check(self, v, what):
        if v.shape[-2] != self.NL:
            raise ValueError(f"{what}: {tuple(v.shape)} is not planar over {self.NL} limbs")

    def _mul_plain(self, a, b):
        return mont_mul_plain(a, b, self.F)

    def _one(self, n, device):
        return self.F.broadcast_one((n,), device)          # (n, NL)

    # -- K8 ---------------------------------------------------------------------

    def chain_fwd(self, dC):
        """dC (C, NL, Mw): chains down axis 0. Returns (pe (C, NL, Mw), the
        exclusive prefix products d[0]..d[c-1], and bp (NL, Mw), each
        chain's product). The kernel computes them as a prefix scan
        (csrc/chain.cuh): the same limbs. C <= CHAIN_MAX_C."""
        self._check(dC, "chain_fwd")
        C, NL, Mw = dC.shape
        if C > CHAIN_MAX_C:
            raise ValueError(f"chain_fwd: C = {C} links, the kernel's block takes at most "
                             f"{CHAIN_MAX_C}")
        if not _on_cuda(dC):
            return self._chain_fwd_plain(dC)
        pe = torch.empty_like(dC)
        bp = torch.empty((NL, Mw), dtype=dC.dtype, device=dC.device)
        build.KERNELS["chain_fwd"](dC.device, NL, self._mod,
                                   *map(build.ptr, (dC, pe, bp)), C, Mw)
        return pe, bp

    def _chain_fwd_plain(self, dC):
        run = self._one(dC.shape[2], dC.device)
        pe = []
        for c in range(dC.shape[0]):
            pe.append(run)
            run = self._mul_plain(run, dC[c].T)
        return torch.stack([p.T for p in pe]).contiguous(), run.T.contiguous()

    # -- K9 ---------------------------------------------------------------------

    def fermat_inv(self, x):
        """x (NL, Wd) -> x^(p-2) per lane (the inverse; 0 gives 0). The
        kernel computes it by safegcd (csrc/inv.cuh), the plain version by
        the reference's square-and-multiply: the same limbs."""
        self._check(x, "fermat_inv")
        if not _on_cuda(x):
            return self._fermat_inv_plain(x)
        out = torch.empty_like(x)
        build.KERNELS["fermat_inv"](x.device, self.NL, self._mod, self._r3,
                                    build.ptr(x), build.ptr(out), x.shape[1])
        return out

    def _fermat_inv_plain(self, x):
        base = x.T
        acc = self._one(x.shape[1], x.device)
        for b in range(self.exp_bits - 1, -1, -1):
            acc = self._mul_plain(acc, acc)
            if (self.exp_int >> b) & 1:
                acc = self._mul_plain(acc, base)
        return acc.T.contiguous()

    # -- K10 --------------------------------------------------------------------

    def chain_bwd_inv(self, pe, dC, bpinv):
        """inv[c] = run * pe[c]; run *= d[c], c = C-1..0, run starting at
        bpinv (NL, Mw). Returns inv (C, NL, Mw). The kernel computes it as
        bpinv * (d[c+1] ... d[C-1]) * pe[c], a suffix scan (csrc/chain.cuh):
        the same limbs. C <= CHAIN_MAX_C."""
        self._check(dC, "chain_bwd_inv")
        C, NL, Mw = dC.shape
        if pe.shape != dC.shape or bpinv.shape != (NL, Mw):
            raise ValueError(f"chain_bwd_inv: {tuple(pe.shape)}, {tuple(dC.shape)}, "
                             f"{tuple(bpinv.shape)}")
        if C > CHAIN_MAX_C:
            raise ValueError(f"chain_bwd_inv: C = {C} links, the kernel's block takes at most "
                             f"{CHAIN_MAX_C}")
        if not _on_cuda(pe, dC, bpinv):
            return self._chain_bwd_inv_plain(pe, dC, bpinv)
        inv = torch.empty_like(dC)
        build.KERNELS["chain_bwd_inv"](dC.device, NL, self._mod,
                                       *map(build.ptr, (pe, dC, bpinv, inv)), C, Mw)
        return inv

    def _chain_bwd_inv_plain(self, pe, dC, bpinv):
        run = bpinv.T
        inv = [None] * dC.shape[0]
        for c in range(dC.shape[0] - 1, -1, -1):
            inv[c] = self._mul_plain(run, pe[c].T).T
            run = self._mul_plain(run, dC[c].T)
        return torch.stack(inv).contiguous()

    # -- composition ------------------------------------------------------------

    def batch_inv_packed(self, x, C: int = 32, block: int = 512):
        """Inverse of every lane of x (NL, m), none of them 0.

        The reference's two-level recursion: up to 4 blocks of lanes go to
        one Fermat launch; wider inputs are padded with ones to a multiple
        of C*block, chained down C (Mw = m/C lanes), the Mw chain products
        inverted the same way (recursively while Mw > 4 blocks), and
        unwound. C and block are the reference's 32 and 512 by default.
        """
        self._check(x, "batch_inv_packed")
        NL, m0 = x.shape
        if m0 <= 4 * block:
            return self.fermat_inv(x)
        m = -(-m0 // (C * block)) * C * block
        if m != m0:
            x = torch.cat([x, self._one(m - m0, x.device).T], 1)
        Mw = m // C
        dC = x.reshape(NL, C, Mw).transpose(0, 1).contiguous()
        pe, bp = self.chain_fwd(dC)
        bpinv = self.batch_inv_packed(bp, C, block)
        inv = self.chain_bwd_inv(pe, dC, bpinv)
        return inv.transpose(0, 1).reshape(NL, m)[:, :m0].contiguous()
