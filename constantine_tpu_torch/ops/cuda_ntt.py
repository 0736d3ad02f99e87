"""K3′, the NTT stage kernels -- wrappers and plain versions.

Counterpart of the two ``PallasEC._elemwise`` kernels that
``constantine_tpu/ops/ntt.py`` builds: ``ntt_bfly`` (:168, the butterfly s =
a + b·w, d = a - b·w) and ``ntt_twm`` (:198, the four-step's product with
the twiddle matrix). On CUDA tensors each wrapper launches its kernel from
``csrc/ntt_kernels.cu`` (one launch a stage, in place); on CPU tensors it
runs the plain version beside it, built on ``mont_mul_plain`` and
``Field.add``/``sub``.

A stage works on a natural-layout (batch, ns, lanes, NL) tensor and
transforms along ns with half-block h: the elements i0 = block·2h + k and
i0 + h of every (batch, lane) pair take the twiddle tw[k] (see
``csrc/ntt.cuh``).
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
