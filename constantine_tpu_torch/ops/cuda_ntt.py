"""K3′, the NTT stage kernels -- wrappers and plain versions.

Counterpart of the two ``PallasEC._elemwise`` kernels that
``constantine_tpu/ops/ntt.py`` builds: ``ntt_bfly`` (:168, the butterfly s =
a + b·w, d = a - b·w) and ``ntt_twm`` (:198, the four-step's product with
the twiddle matrix, here the store factor of ``ntt_stages``). On CUDA
tensors each wrapper launches its kernel from ``csrc/ntt_kernels.cu``; on
CPU tensors it runs the plain version beside it, built on
``mont_mul_plain`` and ``Field.add``/``sub``.

A stage works on a natural-layout (batch, ns, lanes, NL) tensor and
transforms along ns with half-block h: the elements i0 = block·2h + k and
i0 + h of every (batch, lane) pair take the twiddle tw[k] (see
``csrc/ntt.cuh``). ``ntt_stages`` runs a pass in one launch: the bit
reversal of ns, then stages 0 .. stages - 1 over tiles in shared memory,
with a factor on the load and on the store and a transposed store if asked;
``ntt_bfly`` one stage, in place. ``pass_stages`` says how many stages a
pass takes at a shape: all of them where a tile of ns rows fits a block's
shared memory (every pass of the PeerDAS paths; one lane of 8,192 rows, a
batched radix-2 transform, takes 12 and leaves one to ``ntt_bfly``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .cuda_field import _on_cuda, mont_mul_plain


def _check_stage(x, tw, h):
    if x.dim() != 4:
        raise ValueError(f"ntt_bfly takes (batch, ns, lanes, NL), got {tuple(x.shape)}")
    ns = x.shape[1]
    if ns < 2 or ns & (ns - 1) or h < 1 or h & (h - 1) or 2 * h > ns:
        raise ValueError(f"ntt_bfly: ns = {ns}, h = {h}")
    if tw.shape != (h, x.shape[3]):
        raise ValueError(f"ntt_bfly: twiddles {tuple(tw.shape)} for h = {h}")


def ntt_bfly(F, x, tw, h: int, out=None):
    """One radix-2 DIT stage: for every butterfly, s = a + b·tw[k] goes to
    i0 and d = a - b·tw[k] to i0 + h. Returns `out` (default a new tensor;
    x itself works in place)."""
    _check_stage(x, tw, h)
    if not _on_cuda(x, tw, *(() if out is None else (out,))):
        res = ntt_bfly_plain(F, x, tw, h)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape:
        raise ValueError(f"ntt_bfly: out {tuple(out.shape)} for x {tuple(x.shape)}")
    B, ns, lanes, NL = x.shape
    build.KERNELS["ntt_bfly"](x.device, NL, ctypes.c_void_p(F.mod_words.ctypes.data),
                              build.ptr(x), build.ptr(out), build.ptr(tw), B, ns, lanes, h)
    return out


def ntt_bfly_plain(F, x, tw, h: int):
    """The stage in torch ops, as the reference lays it out: a reshape to
    (batch, ns/2h, 2, h, lanes) and the (s, d) pair stacked back."""
    B, ns, lanes, NL = x.shape
    y = x.reshape(B, ns // (2 * h), 2, h, lanes, NL)
    a, b = y[:, :, 0], y[:, :, 1]
    t = mont_mul_plain(b, tw[:, None, :].expand_as(b), F)
    return torch.stack([F.add(a, t), F.sub(a, t)], 2).reshape(x.shape)


# A pass's tile: 2^stages rows by TILE_COLS lanes (fewer where the lanes are
# fewer; on the H100, 2 as fast as 1 and faster than 4 and 8, PERF.md), each
# element N + 1 words in shared memory (csrc/ntt.cuh), at most STAGE_SMEM
# bytes a block (an H100's; csrc/ntt_kernels.cu).
TILE_COLS = 2
STAGE_SMEM = 232448


def tile_cols(lanes: int) -> int:
    """The tile's lanes: the largest power of two <= TILE_COLS dividing lanes."""
    g = 1
    while g * 2 <= TILE_COLS and lanes % (g * 2) == 0:
        g *= 2
    return g


def pass_stages(ns: int, lanes: int, NL: int) -> int:
    """Stages of an ns-row transform one ntt_stages launch takes: the most
    whose tile of 2^stages rows fits STAGE_SMEM."""
    g, k = tile_cols(lanes), ns.bit_length() - 1
    while k > 1 and (1 << k) * g * (NL + 1) * 4 > STAGE_SMEM:
        k -= 1
    return k


def _check_pass(y, tw, brp, stages):
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"ntt_stages takes a contiguous (batch, ns, lanes, NL), got "
                         f"{tuple(y.shape)}")
    B, ns, lanes, NL = y.shape
    if ns < 2 or ns & (ns - 1) or not 1 <= stages <= ns.bit_length() - 1:
        raise ValueError(f"ntt_stages: ns = {ns}, stages = {stages}")
    if tw.dim() != 2 or tw.shape[0] < (1 << stages) - 1 or tw.shape[1] != NL:
        raise ValueError(f"ntt_stages: packed twiddles {tuple(tw.shape)} for {stages} stages")
    if brp.shape != (ns,) or brp.dtype != torch.int64:
        raise ValueError(f"ntt_stages: brp {tuple(brp.shape)} {brp.dtype} for ns = {ns}")
    if (1 << stages) * tile_cols(lanes) * (NL + 1) * 4 > STAGE_SMEM:
        raise ValueError(f"ntt_stages: a tile of 2^{stages} rows exceeds {STAGE_SMEM} bytes")


def _check_factor(what, fac, y, period_max):
    """A factor table: contiguous (period, NL), period 1 or period_max, on
    y's device and of its dtype."""
    if fac is None:
        return
    if (fac.dim() != 2 or fac.shape[0] not in (1, period_max) or fac.shape[1] != y.shape[3]
            or fac.dtype != y.dtype or not fac.is_contiguous()):
        raise ValueError(f"ntt_stages: {what} {tuple(fac.shape)} {fac.dtype} for a pass over "
                         f"{tuple(y.shape)}: a contiguous (1 or {period_max}, {y.shape[3]})")
    if fac.device != y.device:
        raise ValueError(f"ntt_stages: {what} on {fac.device} for y on {y.device}")


def ntt_stages(F, y, tw, brp, stages: int, *, in_fac=None, out_fac=None, transposed=False):
    """y's axis 1 (ns) gathered by brp, then DIT stages 0 .. stages - 1
    (half-blocks 1 .. 2^(stages-1)), in one launch over tiles of 2^stages
    rows by tile_cols(lanes) lanes: tw holds the stage tables packed (stage
    s's 2^s twiddles at rows 2^s - 1 .. 2^(s+1) - 2). Returns a new
    (batch, ns, lanes, NL) tensor, or (batch, lanes, ns, NL) if transposed.

    in_fac multiplies y before the gather: element (b, i, l) by row i·lanes
    + l of the table, or by its one row. out_fac multiplies the output:
    each element by the row of its index within its batch row of the
    output (so laid out transposed for a transposed pass), or by its one
    row."""
    _check_pass(y, tw, brp, stages)
    B, ns, lanes, NL = y.shape
    _check_factor("in_fac", in_fac, y, ns * lanes)
    _check_factor("out_fac", out_fac, y, ns * lanes)
    facs = tuple(f for f in (in_fac, out_fac) if f is not None)
    on_cuda = _on_cuda(y, tw, *facs)
    if brp.device != y.device or not brp.is_contiguous():
        raise ValueError(f"ntt_stages: brp on {brp.device} for y on {y.device}")
    if not on_cuda:
        return ntt_stages_plain(F, y, tw, brp, stages, in_fac=in_fac, out_fac=out_fac,
                                transposed=transposed)
    out = torch.empty((B, lanes, ns, NL) if transposed else y.shape, dtype=y.dtype,
                      device=y.device)
    build.KERNELS["ntt_stages"](
        y.device, NL, ctypes.c_void_p(F.mod_words.ctypes.data), build.ptr(y), build.ptr(out),
        build.ptr(tw), build.ptr(brp),
        ctypes.c_void_p(None if in_fac is None else in_fac.data_ptr()),
        1 if in_fac is None else in_fac.shape[0],
        ctypes.c_void_p(None if out_fac is None else out_fac.data_ptr()),
        1 if out_fac is None else out_fac.shape[0], int(transposed), B, ns, lanes, stages,
        tile_cols(lanes))
    return out


def _times(F, y, fac):
    """y (B, a, b, NL) times a factor table of period 1 or a·b (plain)."""
    lead = (1, 1, 1) if fac.shape[0] == 1 else (1, *y.shape[1:3])
    f = fac.reshape(*lead, y.shape[3])
    return mont_mul_plain(y, f.expand_as(y), F)


def ntt_stages_plain(F, y, tw, brp, stages: int, *, in_fac=None, out_fac=None,
                     transposed=False):
    """The pass as the per-stage route computes it: the load factor's K1
    product, index_select, the chain of plain stages, a transpose, the
    store factor's product."""
    if in_fac is not None:
        y = _times(F, y, in_fac)
    y = y.index_select(1, brp)
    for s in range(stages):
        y = ntt_bfly_plain(F, y, tw[(1 << s) - 1:(2 << s) - 1], 1 << s)
    if transposed:
        y = y.transpose(1, 2).contiguous()
    if out_fac is not None:
        y = _times(F, y, out_fac)
    return y
