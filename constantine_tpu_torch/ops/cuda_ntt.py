"""K3′, the NTT stage kernels -- wrappers and plain versions.

Counterpart of the two ``PallasEC._elemwise`` kernels that
``constantine_tpu/ops/ntt.py`` builds: ``ntt_bfly`` (:168, the butterfly s =
a + b·w, d = a - b·w) and ``ntt_twm`` (:198, the four-step's product with
the twiddle matrix). On CUDA tensors each wrapper launches its kernel from
``csrc/ntt_kernels.cu``; on CPU tensors it runs the plain version beside it,
built on ``mont_mul_plain`` and ``Field.add``/``sub``.

A stage works on a natural-layout (batch, ns, lanes, NL) tensor and
transforms along ns with half-block h: the elements i0 = block·2h + k and
i0 + h of every (batch, lane) pair take the twiddle tw[k] (see
``csrc/ntt.cuh``). ``ntt_stages`` runs a pass in one launch: the bit
reversal of ns, then stages 0 .. stages - 1 over tiles in shared memory;
``ntt_bfly`` one stage, in place. ``pass_stages`` says how many stages a
pass takes at a shape: all of them where a tile of ns rows fits a block's
shared memory (every transform of the PeerDAS paths but the coset
transforms of 8,192 elements, which take 12 and leave one to ``ntt_bfly``).
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


def ntt_twm(F, x, t):
    """x·t (Montgomery) elementwise over (n, NL): the four-step's twiddle
    matrix product."""
    if x.shape != t.shape or x.dim() != 2:
        raise ValueError(f"ntt_twm: {tuple(x.shape)} and {tuple(t.shape)}")
    if not _on_cuda(x, t):
        return mont_mul_plain(x, t, F)
    out = torch.empty_like(x)
    build.KERNELS["ntt_twm"](x.device, x.shape[1], ctypes.c_void_p(F.mod_words.ctypes.data),
                             build.ptr(x), build.ptr(t), build.ptr(out), x.shape[0])
    return out


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


def ntt_stages(F, y, tw, brp, stages: int):
    """y's axis 1 (ns) gathered by brp, then DIT stages 0 .. stages - 1
    (half-blocks 1 .. 2^(stages-1)), in one launch over tiles of 2^stages
    rows by tile_cols(lanes) lanes: tw holds the stage tables packed (stage
    s's 2^s twiddles at rows 2^s - 1 .. 2^(s+1) - 2). Returns a new
    tensor."""
    _check_pass(y, tw, brp, stages)
    on_cuda = _on_cuda(y, tw)
    if brp.device != y.device or not brp.is_contiguous():
        raise ValueError(f"ntt_stages: brp on {brp.device} for y on {y.device}")
    if not on_cuda:
        return ntt_stages_plain(F, y, tw, brp, stages)
    B, ns, lanes, NL = y.shape
    out = torch.empty_like(y)
    build.KERNELS["ntt_stages"](y.device, NL, ctypes.c_void_p(F.mod_words.ctypes.data),
                                build.ptr(y), build.ptr(out), build.ptr(tw), build.ptr(brp),
                                B, ns, lanes, stages, tile_cols(lanes))
    return out


def ntt_stages_plain(F, y, tw, brp, stages: int):
    """The pass as the per-stage route computes it: index_select, then the
    chain of plain stages."""
    y = y.index_select(1, brp)
    for s in range(stages):
        y = ntt_bfly_plain(F, y, tw[(1 << s) - 1:(2 << s) - 1], 1 << s)
    return y
