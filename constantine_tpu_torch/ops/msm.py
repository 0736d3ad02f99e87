"""Multi-scalar multiplication entry point, signed-digit recoding and the
flat route.

Counterpart of ``constantine_tpu/ops/msm.py``. A group over the prime field
(G1, a = 0) runs the kernel pipeline of ``msm_gpu.py`` on either device,
for the online path (scalars in, the GLV split by default) and the
fixed-base path (``digits=``, as PrecomputedMSM calls it). Any other group
(over a tower, as G2, or with a != 0) takes the reference's XLA
formulation, the flat route: every
window's (bucket, point) pairs in one key-sorted stream, a flush scan of
mixed adds over K steps of M lanes, a cumsum compaction of the emitted
runs, a log-depth segmented sum into buckets, two suffix sums and the
window combine, top first. It is torch over the group law, with Python
loops where the reference has ``lax.scan``; its field products are K1
launches on CUDA tensors, and its adds read the card to find lanes that
double (an MSM's points and scalars are public).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from .msm_gpu import msm_gpu


def _signed_digits(scalars: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(N, NL) canonical 32-bit scalar limbs -> (W, N) int32 signed digits in
    [-2^(c-1), 2^(c-1)]; bucket id = |digit|.

    Same digits as the reference: raw c-bit windows, then the carry chain
    carry_w = g_w | (p_w & carry_{w-1}) (g = raw > half, p = raw == half)
    resolved by a log-depth Kogge-Stone scan. Windows past the limbs read 0.
    """
    if not 1 <= c <= 16:
        raise ValueError("window bits c must be in 1..16")
    N, NL = scalars.shape
    half = 1 << (c - 1)
    full = 1 << c
    dev = scalars.device
    sT = lb.widen(scalars).T                                   # (NL, N) int64
    bit0 = np.arange(n_windows) * c
    li = bit0 // lb.LIMB_BITS
    sh = torch.as_tensor(bit0 % lb.LIMB_BITS, device=dev)[:, None]
    zero = torch.zeros_like(sT[0])
    lo = torch.stack([sT[i] if i < NL else zero for i in li])
    hi = torch.stack([sT[i + 1] if i + 1 < NL else zero for i in li])
    raw = ((lo >> sh) | (hi << (lb.LIMB_BITS - sh))) & (full - 1)   # (W, N)
    g = raw > half
    p = raw == half
    carry = g
    s = 1
    while s < n_windows:
        pad = torch.zeros((s, N), dtype=torch.bool, device=dev)
        shifted = torch.cat([pad, carry[:-s]])
        pacc = torch.cat([pad, p[:-s]])
        carry = carry | (p & shifted)
        p = p & pacc
        s *= 2
    carry_in = torch.cat([torch.zeros((1, N), dtype=torch.bool, device=dev), carry[:-1]])
    return (raw + carry_in.long() - full * carry.long()).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _glv_for_group(group_name: str):
    """GLV context for an ECGroup named '<curve>.G1', else None. A G1 curve
    whose GLV fails to build raises (the reference swallows that)."""
    if not group_name.endswith(".G1"):
        return None
    from .glv import get_glv
    return get_glv(group_name[: -len(".G1")])


def _apply_glv(group, glv_ctx, points_aff, scalars):
    """N points x b-bit scalars -> 2N points x (b/2)-bit scalars."""
    k1, n1, k2, n2 = glv_ctx.decompose(scalars)
    px, py = points_aff
    P1 = group.aff_cneg(n1, (px, py))
    P2 = group.aff_cneg(n2, glv_ctx.endo((px, py)))
    pts = tuple(torch.cat([a, b]) for a, b in zip(P1, P2))
    return pts, torch.cat([k1, k2]), glv_ctx.mini_bits


def msm(group, points_aff, scalars, c: int = None, scalar_bits: int = None,
        digits=None, glv: bool = None, max_flat: int = 1 << 22):
    """sum_i scalars[i] * P_i. Returns a Jacobian point (batch ()).

    points_aff: (x, y) affine Montgomery coordinates with leading batch N;
    scalars: (N, NL_r) canonical limbs, or None with `digits` (W, N)
    precomputed signed c-bit digits. glv=None splits by the endomorphism on
    G1 when digits is None; scalar_bits bounds the scalars (default all their
    limbs' bits). A group over the prime field with a = 0 runs the kernel
    pipeline, any other group (a tower's, or a != 0) the flat route, whose
    key stream holds at most `max_flat` entries (further windows go in
    groups, one after another).
    """
    pts = tuple(points_aff)
    if glv is None:
        glv = digits is None
    if glv and digits is None and scalars is not None:
        glv_ctx = _glv_for_group(group.name)
        if glv_ctx is not None:
            pts, scalars, scalar_bits = _apply_glv(group, glv_ctx, pts, scalars)
    if hasattr(group.F, "deg") or getattr(group, "a_int", 0) != 0:
        return _msm_flat(group, pts, scalars, c, scalar_bits, digits, max_flat)
    return msm_gpu(group, pts, scalars, c=c, scalar_bits=scalar_bits, digits=digits)


# ---------------------------------------------------------------------------
# The flat route (the reference's XLA branch)
# ---------------------------------------------------------------------------


def best_window_size(n: int, bits: int = 255) -> int:
    """The flat route's window bits: the reference's model, log2(n) - 3
    clipped to 2..16 (its bestBucketBitSize biased one size larger)."""
    log2n = max(1, n).bit_length() - 1
    return max(2, min(16, log2n - 3))


def _masked_roll(group, vals, s: int, up: bool):
    """vals (a point with a leading lane axis) moved s lanes, towards lane 0
    with `up`, else away from it; the vacated lanes hold the neutral point."""
    n = vals[0].shape[0]
    s = min(s, n)
    tail = 2 if hasattr(group.F, "deg") else 1          # an element's own axes
    fill = group.infinity((s,) + vals[0].shape[1:-tail], vals[0].device)
    if up:
        return tuple(torch.cat([v[s:], f]) for v, f in zip(vals, fill))
    return tuple(torch.cat([f, v[:n - s]]) for v, f in zip(vals, fill))


def _log_rounds(n: int):
    """The shifts 1, 2, 4, ... of a log-depth scan over n lanes."""
    return [1 << i for i in range(max(1, n - 1).bit_length())]


def _segmented_sum(group, keys, vals, n: int):
    """Inclusive segmented scan over sorted keys: vals[i] accumulates every
    earlier entry with the same key (Hillis-Steele, log-depth)."""
    idx = torch.arange(n, device=keys.device)
    for s in _log_rounds(n):
        same = (keys == torch.roll(keys, s, 0)) & (idx >= s)
        summed = group.add(vals, _masked_roll(group, vals, s, up=False))
        vals = group.select(same, summed, vals)
    return vals


def _suffix_sum(group, vals, n: int):
    """vals[j] <- sum_{b >= j} vals[b], log-depth."""
    for s in _log_rounds(n):
        vals = group.add(vals, _masked_roll(group, vals, s, up=True))
    return vals


def _sum_all(group, vals, n: int):
    """The sum of a (n, ...) stack of points, log-depth; a batchless point."""
    return tuple(v[0] for v in _suffix_sum(group, vals, n))


def _expand(mask, extra_axes: int):
    """mask with `extra_axes` trailing axes of size one."""
    return mask[(...,) + (None,) * extra_axes]


def _to_chunks(arr, M: int, K: int):
    """(M*K, ...) -> (K, M, ...), lane m owning arr[m*K:(m+1)*K]."""
    return arr.reshape((M, K) + arr.shape[1:]).transpose(0, 1)


def _flatten_chunks(arr):
    """(K, M, ...) -> (M*K, ...), the sorted stream's order restored."""
    K, M = arr.shape[:2]
    return arr.transpose(0, 1).reshape((M * K,) + arr.shape[2:])


def _msm_flat(group, pts, scalars, c, scalar_bits, digits, max_flat):
    """The reference's XLA MSM over a group with from_affine, madd, add,
    double, select, aff_cneg and infinity. Returns a batchless point."""
    N = pts[0].shape[0]
    if digits is not None:
        if c is None:
            raise ValueError("msm with digits= needs the window bits c")
        W = digits.shape[0]
    else:
        bits = scalar_bits or scalars.shape[1] * lb.LIMB_BITS
        if c is None:
            c = best_window_size(N, bits)
        W = -(-bits // c) + 1                       # +1 for the signed digits' carry
        digits = _signed_digits(scalars, c, W)
    half = 1 << (c - 1)
    wg = max(1, min(W, max_flat // max(N, 1)))      # windows in a group of the stream
    n_groups = -(-W // wg)
    if n_groups * wg > W:
        digits = torch.cat([digits, digits.new_zeros((n_groups * wg - W, N))])
    digits = digits.reshape(n_groups, wg, N)
    flat = wg * N
    K = min(int(np.clip(flat // (1 << 16), 8, 64)), flat)
    M = -(-flat // K)
    emax = int(min(M + wg * (half + 2), (K + 1) * M))
    wsums = [_window_sums(group, pts, dws, half, K, M, emax) for dws in digits]
    wsums = tuple(torch.cat(w)[:W] for w in zip(*wsums))
    # the windows, top first: total = ((w_top 2^c + w_{top-1}) 2^c + ...)
    total = tuple(w[W - 1] for w in wsums)
    for idx in range(W - 2, -1, -1):
        for _ in range(c):
            total = group.double(total)
        total = group.add(total, tuple(w[idx] for w in wsums))
    return total


def _window_sums(group, pts, dws, half, K, M, emax):
    """The sums of one group of windows: dws (wg, N) signed digits -> a point
    with leading axis wg, window w's sum_b b * B_b."""
    wg, N = dws.shape
    dev = dws.device
    big = 2**31 - 1
    keys = dws.abs()
    # global key w (half + 1) + |d|; zero digits go to key 0, which is dropped
    widx = torch.arange(wg, device=dev, dtype=torch.int32)[:, None]
    gkeys = torch.where(keys == 0, 0, widx * (half + 1) + keys).reshape(-1)
    order = torch.argsort(gkeys, stable=True)
    sk = gkeys[order]
    spts = group.aff_cneg((dws < 0).reshape(-1)[order], tuple(t[order % N] for t in pts))
    pad = M * K - wg * N
    if pad:
        sk = torch.cat([sk, sk.new_zeros(pad)])
        spts = tuple(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) for t in spts)
    skc = _to_chunks(sk, M, K)                       # (K, M): lane m's chunk down a column
    cx, cy = (_to_chunks(t, M, K) for t in spts)
    # the flush scan: a lane accumulates its run of equal keys and emits the
    # sum when the key changes (key -1: no emission). Step 0 starts every
    # lane's run, so it needs no add.
    acc = group.from_affine((cx[0], cy[0]))
    cur = skc[0]
    ekeys, evals = [], []
    for k in range(1, K):
        same = skc[k] == cur
        ekeys.append(torch.where(same, -1, cur))
        evals.append(acc)
        coords = (cx[k], cy[k])
        acc = group.select(same, group.madd(acc, coords), group.from_affine(coords))
        cur = skc[k]
    # each lane's last run flushes as its K-th emission, so the lane-major
    # flatten stays key-sorted
    ekeys.append(cur)
    evals.append(acc)
    ekeys = _flatten_chunks(torch.stack(ekeys))
    evals = tuple(_flatten_chunks(torch.stack(e)) for e in zip(*evals))
    # compact the real emissions, already in key order, into emax slots
    # (slot emax takes the rest and is dropped)
    real = ekeys > 0
    pos = torch.where(real, torch.cumsum(real, 0) - 1, emax)
    ck = torch.full((emax + 1,), big, dtype=ekeys.dtype, device=dev)
    ck[pos] = torch.where(real, ekeys, big)
    ck = ck[:emax]
    cv = []
    for v in evals:
        out = v.new_zeros((emax + 1,) + v.shape[1:])   # Z = 0: infinity
        out[pos] = v
        cv.append(out[:emax])
    cv = _segmented_sum(group, ck, tuple(cv), emax)
    # the last entry of each key's run holds its bucket's sum
    last = torch.cat([ck[:-1] != ck[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    valid = last & (ck != big)
    tgt = torch.where(valid, ck, 0).long()
    buckets = group.infinity((wg * (half + 1),), dev)
    buckets = tuple(b.index_put((tgt,), torch.where(_expand(valid, v.dim() - 1), v, b[tgt]))
                    for b, v in zip(buckets, cv))
    # (half + 1, wg, ...): the bucket axis first, the windows ride along
    buckets = tuple(b.reshape((wg, half + 1) + b.shape[1:]).transpose(0, 1) for b in buckets)
    buckets = _suffix_sum(group, buckets, half + 1)
    # a window's sum is sum_{j >= 1} suffix[j]
    return _sum_all(group, tuple(b[1:] for b in buckets), half)
