"""MSM pipeline over the point kernels (Pippenger).

Counterpart of ``constantine_tpu/ops/msm_tpu.py`` with the same stages and
the same geometry (block = 512 lanes, the K0/M/K flush formulas, K2 = 32,
the bucket-reduce T), so each stage is bit-exact against the reference:

1. one sort of packed (|digit|, sign, index) words into a bucket-grouped
   stream (``_sorted_stream``);
2. flush scan (K4): lanes sweep K-long chunks, one mixed add per entry;
3. compaction of the run ends (``_compact_boundaries``), then merge scans
   (K5) until every bucket has at most 4 partials (``_merge_rounds``);
4. two masked tree rounds, the weighted bucket reduction (K6), log-depth
   chunk trees of K3 adds, then the window combine: K7 ``scaled_doubles``
   and a lane tree of K3 adds (``_msm_tail``), or per-row sums for
   independent MSMs sharing one table (``combine=False``).

Sorts, prefix sums, gathers and scatters are torch ops, as they were XLA ops
in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BLOCK = 512     # flush lanes are a multiple of this (the reference's TPU block)


def _cdiv(a, b):
    return -(-a // b)


def _rup(a, m):
    return _cdiv(a, m) * m


def best_window_tpu(n: int, bits: int = 255) -> int:
    """Balance flush madds (W*N) against bucket-side adds (~5*W*2^(c-1))."""
    best, bestcost = 8, float("inf")
    for c in range(8, 17):
        Wn = _cdiv(bits + 1, c)
        cost = Wn * n + 5 * Wn * (1 << (c - 1))
        if cost < bestcost:
            best, bestcost = c, cost
    return best


def _neg_std(F, y):
    """Field negation of (.., NL) limbs (plain torch, either device)."""
    return F.neg(y)


def _lane_tree_sum(pec, P, n):
    """Jacobian sum of the first n lanes of (NL, n) planar coords."""
    X, Y, Z = P
    while n > 1:
        h = n // 2
        s = pec.add(tuple(v[:, :h].contiguous() for v in (X, Y, Z)),
                    tuple(v[:, h:2 * h].contiguous() for v in (X, Y, Z)))
        if n % 2:
            X, Y, Z = (torch.cat([sv, v[:, 2 * h:]], 1) for sv, v in zip(s, (X, Y, Z)))
        else:
            X, Y, Z = s
        n = h + (n % 2)
    return X, Y, Z


def _sorted_stream(digits, c, W, H, N):
    """Sort the (W, N) signed digits into a bucket-grouped stream.

    Returns (sk (W*N,) int32 global keys w*(H+1) + |d|, gi (W*N,) int64
    gather rows into the [P ; -P] table). Zero digits take the gap key
    w*(H+1), so the stream is globally sorted.
    """
    dev = digits.device
    ib = max(1, N - 1).bit_length()                       # index bits
    widx = torch.arange(W, dtype=torch.int32, device=dev)[:, None].expand(W, N)
    if c + 1 + ib <= 31:
        k = digits.abs()
        sign = (digits < 0).to(torch.int32)
        idx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        packed = (k << (ib + 1)) | (sign << ib) | idx
        s, _ = torch.sort(packed, dim=1)
        sk_w = s >> (ib + 1)
        gi = (s & ((1 << ib) - 1)) + ((s >> ib) & 1) * N
        sk = widx * (H + 1) + sk_w
        return sk.reshape(-1), gi.reshape(-1).long()
    keys = (widx * (H + 1) + digits.abs()).reshape(-1)
    neg = (digits < 0).reshape(-1).long()
    sk, order = torch.sort(keys, stable=True)
    gi = (order % N) + neg[order] * N
    return sk, gi


def _compact_mask_gather(skT, coords, S, nb, H, shape2=None):
    """Compact the dense post-step scan emissions to the real run sums.

    skT (K, M) keys, coords [(K, NL, M)] post-step accumulators. Slot (k, m)
    is real iff its key is a bucket id (1..nb, not a gap value) and differs
    from the lane's next key: the last slot of a run holds the run sum.
    Real entries keep global stream order. shape2=(K2, M2) lays the output
    out for merge_scan ((K2, M2) keys, [(K2, NL, M2)]); shape2=None returns
    stream order (keys (S,), [(NL, S)]). Slots past the real count hold key
    0, neutral downstream.
    """
    K, M = skT.shape
    NL = coords[0].shape[1]
    dev = skT.device
    nxt = torch.cat([skT[1:], torch.full((1, M), -1, dtype=skT.dtype, device=dev)])
    real = (skT != nxt) & (skT > 0) & (skT <= nb) & (skT % (H + 1) != 0)
    ri = real.to(torch.int64)
    incl = torch.cumsum(ri, 0)                      # (K, M) within-lane
    tot = incl[-1]
    off = torch.cumsum(tot, 0) - tot                # exclusive lane offsets
    pos = off[None, :] + incl - 1                   # global stream rank
    if shape2 is not None:
        K2, M2 = shape2
        S = K2 * M2
        pos = (pos % K2) * M2 + (pos // K2)
    pos = torch.where(real, pos, S).reshape(-1)
    sid = torch.arange(K * M, dtype=torch.int64, device=dev)   # k-major slot id
    # scatter with "drop" semantics: one spare slot takes the non-real writes
    src = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
    src[pos] = sid
    src = src[:S]
    good = src >= 0
    src = src.clamp(min=0)
    ck = torch.where(good, skT.reshape(-1)[src], 0).to(skT.dtype)
    k_i = src // M
    m_i = src - k_i * M
    outs = [cv[k_i, :, m_i] for cv in coords]       # (S, NL)
    if shape2 is not None:
        return (ck.reshape(K2, M2),
                [o.reshape(K2, M2, NL).transpose(1, 2).contiguous() for o in outs])
    return ck, [o.T.contiguous() for o in outs]


def _compact_boundaries(pec, sk, skT, coords, K, M, nb, H, K2):
    """Post-flush compaction without dense scatters. The real emissions are
    (a) for each bucket id, the slot of its last stream entry, found by a
    binary search over the globally sorted keys, and (b) each lane's final
    slot when its last run continues into the next lane. S = nb + M slots.

    Returns (kT (K2, M2), xT/yT/zT (K2, NL, M2), M2) for merge_scan, entries
    grouped by key (invalid slots carry key 0).
    """
    NL = pec.NL
    ex, ey, ez = coords
    dev = sk.device
    want = torch.arange(1, nb + 1, dtype=sk.dtype, device=dev)
    # the reference's manual binary search: lo = #{sk <= want}
    lo = torch.searchsorted(sk, want, right=True)
    pa = lo - 1
    va = (pa >= 0) & (sk[pa.clamp(min=0)] == want) & (want % (H + 1) != 0)
    ka = torch.where(va, want, 0)
    pa = pa.clamp(min=0)
    ki_a = pa % K
    mi_a = pa // K
    le_keys = skT[K - 1, :]
    nxt_first = torch.cat([skT[0, 1:], torch.full((1,), -1, dtype=skT.dtype, device=dev)])
    vb = (le_keys > 0) & (le_keys <= nb) & (le_keys % (H + 1) != 0) & (nxt_first == le_keys)
    kb = torch.where(vb, le_keys, 0)
    ki_b = torch.full((M,), K - 1, dtype=torch.int64, device=dev)
    mi_b = torch.arange(M, dtype=torch.int64, device=dev)

    keys = torch.cat([ka, kb])
    ki = torch.cat([ki_a, ki_b])
    mi = torch.cat([mi_a, mi_b])
    S = nb + M
    keys, order = torch.sort(keys, stable=True)
    ki = ki[order]
    mi = mi[order]
    vals = [cv[ki, :, mi] for cv in (ex, ey, ez)]       # (S, NL) each

    M2 = _rup(_cdiv(S, K2), 128)
    pad = K2 * M2 - S
    if pad:
        keys = torch.cat([keys, torch.zeros((pad,), dtype=keys.dtype, device=dev)])
        vals = [torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in vals]
    kT = keys.reshape(M2, K2).T.contiguous()
    xT, yT, zT = (v.reshape(M2, K2, NL).permute(1, 2, 0).contiguous() for v in vals)
    return kT, xT, yT, zT, M2


def _merge_rounds(pec, keysP, ex, ey, ez, curK, curM, nb, H, r, K2=32):
    """Compact + merge_scan until every bucket has <= 4 partials (the reach
    of _msm_tail's two tree rounds). Returns the final compacted stream
    (ck (S,), cx, cy, cz (NL, S))."""
    while r > 4:
        Sb = min(curM * curK, curM + nb)
        M2 = _rup(_cdiv(Sb, K2), 128)
        kT, (xT, yT, zT) = _compact_mask_gather(
            keysP, [ex, ey, ez], None, nb, H, shape2=(K2, M2))
        ex, ey, ez = pec.merge_scan(kT, xT, yT, zT)
        keysP, curK, curM = kT, K2, M2
        r = _cdiv(r, K2) + 1
    Sf = min(curM * curK, curM + nb)
    ck, (cx, cy, cz) = _compact_mask_gather(keysP, [ex, ey, ez], Sf, nb, H)
    return ck, cx, cy, cz


def msm_gpu(group, points_aff, scalars=None, c: int = None, scalar_bits: int = None,
            digits=None, combine: bool = True):
    """MSM over the kernel pipeline, the reference's msm_tpu contract.

    points_aff: (x, y) (N, NL) affine Montgomery coordinates. Either scalars
    (N, NL_r) canonical limbs (window bits c from best_window_tpu unless
    given, W = ceil((bits + 1) / c) windows, bits = scalar_bits or all the
    limbs' bits), or digits (W, N) signed c-bit digits with c given.
    Returns a Jacobian point, each coordinate (NL,); with combine=False the
    W per-row sums instead, each coordinate (W, NL): the rows are then
    independent MSMs over one table (PrecomputedMSM.batch).
    """
    F = group.F
    pec = group.pec
    if digits is not None:
        if c is None:
            raise ValueError("msm_gpu with digits= needs the window bits c")
        W, N = digits.shape
    else:
        from .msm import _signed_digits
        N = scalars.shape[0]
        bits = scalar_bits or scalars.shape[1] * 32
        if c is None:
            c = best_window_tpu(N, bits)
        W = _cdiv(bits + 1, c)
        digits = _signed_digits(scalars, c, W)
    H = 1 << (c - 1)
    fs = _flush_stream(F, points_aff, digits, c)
    ex, ey, ez = pec.flush_scan(fs.skT, fs.st)
    K2 = 32
    kT, xT, yT, zT, M2 = _compact_boundaries(pec, fs.sk, fs.skT, (ex, ey, ez),
                                             fs.K, fs.M, fs.nb, fs.H, K2)
    e2x, e2y, e2z = pec.merge_scan(kT, xT, yT, zT)
    r = _cdiv(_cdiv(N, fs.K) + 1, K2) + 1
    ck, cx, cy, cz = _merge_rounds(pec, kT, e2x, e2y, e2z, K2, M2, fs.nb, fs.H, r, K2)
    return _msm_tail(group, pec, ck, cx, cy, cz, c, W, H, combine)


class FlushStream(NamedTuple):
    sk: torch.Tensor      # (M*K,) globally sorted keys, padded with nb + 1
    skT: torch.Tensor     # (K, M) the keys as the lanes sweep them
    st: torch.Tensor      # (K, 2NL, M) gathered [x | +-y] entries
    K: int
    M: int
    nb: int
    H: int


def _flush_stream(F, points_aff, digits, c):
    """Sort the digits and gather the flush scan's input stream, with the
    reference's geometry: M lanes (a multiple of BLOCK) sweeping K-long
    chunks, K0 = max(8, N/64) bounding the partials per bucket."""
    px, py = points_aff
    dev = px.device
    NL = F.NL
    W, N = digits.shape
    H = 1 << (c - 1)
    sk, gi = _sorted_stream(digits, c, W, H, N)
    flat = W * N
    nb = W * (H + 1)
    K0 = max(8, _cdiv(N, 64))
    M = _rup(_cdiv(flat, K0), BLOCK)
    K = _rup(_cdiv(flat, M), 8)
    pad = M * K - flat
    if pad:
        # pad above every real key so the stream stays globally sorted
        sk = torch.cat([sk, torch.full((pad,), nb + 1, dtype=sk.dtype, device=dev)])
        gi = torch.cat([gi, torch.zeros((pad,), dtype=gi.dtype, device=dev)])
    # gather table [x | y ; x | -y]: the sign of a digit is a row offset.
    # The reference packs two 16-bit digits per u32 here (_pack16); the
    # port's limbs are that packing already.
    ptab = torch.cat([torch.cat([px, py], 1),
                      torch.cat([px, _neg_std(F, py)], 1)], 0)     # (2N, 2NL)
    skT = sk.reshape(M, K).T.contiguous()
    st = ptab[gi].reshape(M, K, 2 * NL).permute(1, 2, 0).contiguous()
    return FlushStream(sk, skT, st, K, M, nb, H)


def _tree_rounds(pec, ck, cx, cy, cz):
    """Two masked rounds of adjacent adds: inclusive segmented sums over the
    compacted runs (each at most 4 long), so a run's last entry holds its
    bucket sum."""
    idx = torch.arange(ck.shape[0], device=ck.device)
    for s in (1, 2):
        same = (ck == torch.roll(ck, s)) & (idx >= s) & (ck > 0)
        shX = torch.roll(cx, s, 1)
        shY = torch.roll(cy, s, 1)
        shZ = torch.where(same[None, :], torch.roll(cz, s, 1), 0)
        aX, aY, aZ = pec.add((cx, cy, cz), (shX, shY, shZ.contiguous()))
        cx = torch.where(same[None, :], aX, cx)
        cy = torch.where(same[None, :], aY, cy)
        cz = torch.where(same[None, :], aZ, cz)
    return cx, cy, cz


def _bucket_planes(ck, cx, cy, cz, c, W, H):
    """Scatter the bucket sums (last entry of each run) into the (T, NL,
    W*C) bucket_reduce layout: lane = window chunk of T buckets, step t
    holds the bucket of weight T-1-t within its chunk. Returns (planes, T, C).
    T is the largest that still fills >= 2048 lanes, and at least 4."""
    NL = cx.shape[0]
    nxt = torch.roll(ck, -1)
    nxt[-1] = -1
    last = (ck != nxt) & (ck > 0)
    T = 1 << max(2, (c - 1) // 2)
    while T > 4 and W * (H // T) < 2048:
        T //= 2
    C = _cdiv(H, T)
    if C * T != H:
        raise ValueError(f"bucket count {H} is not a multiple of T={T}")
    ck64 = ck.long()
    w_of = (ck64 - 1) // (H + 1)
    h = ck64 - w_of * (H + 1) - 1                        # bucket 1..H -> 0..H-1
    tstep = (T - 1) - (h % T)                            # weight = h % T
    lane = w_of * C + h // T
    n2 = W * C
    tpos = torch.where(last, tstep * n2 + lane, T * n2)
    planes = []
    for v in (cx, cy, cz):
        buf = torch.zeros((NL, T * n2 + 1), dtype=torch.int32, device=ck.device)
        buf[:, tpos] = v                                 # spare column: "drop"
        planes.append(buf[:, : T * n2].reshape(NL, T, n2).transpose(0, 1).contiguous())
    return planes, T, C


def _msm_tail(group, pec, ck, cx, cy, cz, c, W, H, combine):
    """Tree rounds, scatter into the bucket-reduce layout, two-level bucket
    reduction, window sums, then the window combine (or, with combine=False,
    the per-row sums in standard layout (W, NL))."""
    NL = group.F.NL
    dev = ck.device
    cx, cy, cz = _tree_rounds(pec, ck, cx, cy, cz)
    planes, T, C = _bucket_planes(ck, cx, cy, cz, c, W, H)
    n2 = W * C
    (rX, rY, rZ), (wX, wY, wZ) = pec.bucket_reduce(*planes, T)
    # window sum S_w = T * A_w + WS_w + R_w with A_w = sum_c c*run_c,
    # R_w = sum_c run_c, WS_w = sum_c wsum_c; level 2 runs log-depth over
    # the C chunk lanes of each window.
    cpos = torch.arange(n2, device=dev) % C

    def _roll_in(P, s, kill0=False):
        """P + (P rolled -s lanes); lanes crossing their window's chunk block
        (or lane c = 0 with kill0) are neutralized with Z = 0."""
        ok = (cpos + s) < C
        X, Y, Z = P
        rX_ = torch.roll(X, -s, 1)
        rY_ = torch.roll(Y, -s, 1)
        rZ_ = torch.where(ok[None, :], torch.roll(Z, -s, 1), 0)
        if kill0:
            Z = torch.where((cpos == 0)[None, :], 0, Z)
        return pec.add((X, Y, Z.contiguous()), (rX_, rY_, rZ_.contiguous()))

    S = (rX, rY, rZ)
    s = 1
    while s < C:
        S = _roll_in(S, s)
        s *= 2
    A = _roll_in(S, 1, kill0=True)
    s = 2
    while s < C:
        A = _roll_in(A, s)
        s *= 2
    WS = (wX, wY, wZ)
    s = 1
    while s < C:
        WS = _roll_in(WS, s)
        s *= 2

    def lane0(P):
        return tuple(v.reshape(NL, W, C)[:, :, 0].contiguous() for v in P)

    logT = int(np.log2(T))
    tA = pec.double_k(lane0(A), logT)                   # (NL, W)
    t1 = pec.add(tA, lane0(WS))
    wsum = pec.add(t1, lane0(S))                        # window sums
    if not combine:
        return tuple(v.T for v in wsum)

    dws = pec.scaled_doubles(wsum, c, W)                # lane w = 2^(cw) S_w
    total = _lane_tree_sum(pec, dws, W)
    return tuple(t[:, 0].reshape(NL) for t in total)
