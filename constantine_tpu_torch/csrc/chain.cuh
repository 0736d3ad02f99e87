// K8 and K10: the forward and backward chains of batched inversion as a
// prefix and a suffix scan over a tile in shared memory, shared by the CUDA
// kernels (field_kernels.cu) and the host build the tests use
// (chain_host.cpp).
//
// K8 replaces constantine_tpu/ops/pallas_ec.py:chain_fwd, which walks a
// chain's C links on the grid's minor axis with the running product in
// VMEM scratch: pe[c] = run, then run *= d[c], run starting at one, and bp
// the last run. Written out,
//
//     pe[c] = d[0] * ... * d[c-1],   pe[0] = 1,   bp = d[0] * ... * d[C-1],
//
// an exclusive prefix product of d and its total.
//
// K10 replaces pallas_ec.py:chain_bwd_inv, which walks the chain in reverse:
// inv[c] = run * pe[c], then run *= d[c], run starting at bpinv, the
// inverse of the chain's product. Written out,
//
//     inv[c] = bpinv * S[c] * pe[c],   S[c] = d[c+1] * ... * d[C-1],   S[C-1] = 1,
//
// so the walk is an exclusive suffix product of d. Field products are exact
// and canonical, so any order of them gives the walks' limbs.
//
// Layout: chains (C, N, Mw) and lanes (N, Mw), the lane axis contiguous (the
// port's planar layout, CudaAffine). A block takes G lanes m0 .. m0 + G - 1
// of every link: thread (g, c) -- threadIdx.x = g along the lanes, so a
// warp's loads of one limb are contiguous, threadIdx.y = c along the chain
// (K8: a segment of links). The tile holds two buffers of C x N x G words,
// element (c, g) with limb l at word (c N + l) G + g, so a warp's accesses
// to one limb fall on consecutive banks.
//
// What bounds them on an H100: at the paths' Mw = 512 one thread a lane
// was 4 blocks on 132 SMs, its time a chain of C = 32 dependent products.
// K10 here is a Hillis-Steele scan, ceil(log2 C) = 5 levels of one product
// a thread between barriers, then two products a thread: 7 products deep
// instead of 32, on C times as many threads. The scan does about C log C
// products a lane (one thread a lane 2C), which costs at the widest call,
// Mw = 8,192, where the card is busy (PERF.md). K8 scans segments of S
// links, a thread a segment: a product down the segment, the scan across
// segments, a walk down the segment again, 2 (S - 1) + log2(C / S) deep
// with about 2C products a lane, so the segment length trades depth (S = 1,
// the plain scan) against work (field_kernels.cu picks S by Mw).
#pragma once

#include <stddef.h>

#include "ec.cuh"

namespace ctt {

constexpr int CHAIN_MAX_C = 32;  // a chain's links, at most the block's rows

// Word l of a planar lane: base[l * stride + idx].
template <int N>
CTT_HD Fe<N> load_lane(const uint32_t* base, int stride, int idx) {
  Fe<N> r;
#pragma unroll
  for (int l = 0; l < N; ++l) r.v[l] = base[(size_t)l * stride + idx];
  return r;
}

template <int N>
CTT_HD void store_lane(uint32_t* base, int stride, int idx, const Fe<N>& v) {
#pragma unroll
  for (int l = 0; l < N; ++l) base[(size_t)l * stride + idx] = v.v[l];
}

// Element c of buffer b of a tile: limb l of lane g at [l * G + g].
CTT_HD uint32_t* chain_slot(uint32_t* tile, int b, int c, int C, int N, int G) {
  return tile + ((size_t)b * C + c) * N * G;
}

// Levels of the scan: the least L with 2^L >= C.
CTT_HD int chain_levels(int C) {
  int L = 0;
  while ((1 << L) < C) ++L;
  return L;
}

// Words of a block's tile: two buffers of C x N x G.
CTT_HD size_t chain_tile_words(int C, int N, int G) { return 2 * (size_t)C * N * G; }

// K10's phase p of thread (g, c) in the block whose lanes start at m0; the
// tile holds a barrier between phases. With L = chain_levels(C):
//   p = 0      buffer 0 gets the chain shifted by one link, d[c + 1], and
//              one at c = C - 1 (the exclusive shift);
//   p = 1..L   level u = p - 1: buffer p & 1 gets, at c, buffer u & 1's c
//              times its c + 2^u where that is a link, else its c alone, so
//              after it link c holds the shifted links c .. c + 2^(u+1) - 1;
//   p = L + 1  inv[c] = (bpinv * S[c]) * pe[c], S[c] read from buffer L & 1.
// A phase reads one buffer and writes the other (or global memory), so its
// threads may run in any order.
template <int N>
CTT_HD void chain_bwd_phase(const Mod<N>& M, const uint32_t* pe, const uint32_t* d,
                            const uint32_t* bpinv, uint32_t* inv, uint32_t* tile, int C, int Mw,
                            int G, int m0, int g, int c, int p) {
  const int m = m0 + g;
  if (m >= Mw || c >= C) return;
  const int L = chain_levels(C);
  const size_t link = (size_t)N * Mw;
  if (p == 0) {
    const Fe<N> v = c + 1 < C ? load_lane<N>(d + (c + 1) * link, Mw, m) : fe_one<N>(M);
    store_lane<N>(chain_slot(tile, 0, c, C, N, G), G, g, v);
  } else if (p <= L) {
    const int u = p - 1, off = 1 << u;
    Fe<N> v = load_lane<N>(chain_slot(tile, u & 1, c, C, N, G), G, g);
    if (c + off < C)
      v = fe_mul<N>(v, load_lane<N>(chain_slot(tile, u & 1, c + off, C, N, G), G, g), M);
    store_lane<N>(chain_slot(tile, p & 1, c, C, N, G), G, g, v);
  } else if (p == L + 1) {
    const Fe<N> s = load_lane<N>(chain_slot(tile, L & 1, c, C, N, G), G, g);
    const Fe<N> r = fe_mul<N>(load_lane<N>(bpinv, Mw, m), s, M);
    store_lane<N>(inv + c * link, Mw, m, fe_mul<N>(r, load_lane<N>(pe + c * link, Mw, m), M));
  }
}

// K8's phase p of thread (g, s), the mirror of chain_bwd_phase over
// segments: thread s takes links s S .. s S + S - 1 (the last segment may be
// shorter), so a block row is a segment, n = ceil(C / S) rows, and element
// (s, g) of a buffer is segment s. With L = chain_levels(n):
//   p = 0      buffer 0 gets, at s, the segment's product (S - 1 products);
//   p = 1..L   level u = p - 1: buffer p & 1 gets, at s, buffer u & 1's s
//              times its s - 2^u where that is a segment, else its s alone,
//              so after it segment s holds segments s - 2^(u+1) + 1 .. s
//              (the inclusive scan);
//   p = L + 1  the walk down the segment from the product of the segments
//              before it (segment s - 1 of buffer L & 1, one at s = 0: the
//              exclusive shift): pe[c] = run, then run *= d[c] (S - 1
//              products); the last segment also stores bp, its whole chain.
// At S = 1 it is the Hillis-Steele scan over links, L products deep; at S
// > 1, 2 (S - 1) + L deep with about 2C products a lane instead of C log C.
template <int N>
CTT_HD void chain_fwd_phase(const Mod<N>& M, const uint32_t* d, uint32_t* pe, uint32_t* bp,
                            uint32_t* tile, int C, int S, int Mw, int G, int m0, int g, int s,
                            int p) {
  const int m = m0 + g, n = (C + S - 1) / S;
  if (m >= Mw || s >= n) return;
  const int L = chain_levels(n), c0 = s * S, c1 = c0 + S < C ? c0 + S : C;
  const size_t link = (size_t)N * Mw;
  if (p == 0) {
    Fe<N> run = load_lane<N>(d + c0 * link, Mw, m);
    for (int c = c0 + 1; c < c1; ++c) run = fe_mul<N>(run, load_lane<N>(d + c * link, Mw, m), M);
    store_lane<N>(chain_slot(tile, 0, s, n, N, G), G, g, run);
  } else if (p <= L) {
    const int u = p - 1, off = 1 << u;
    Fe<N> v = load_lane<N>(chain_slot(tile, u & 1, s, n, N, G), G, g);
    if (s - off >= 0)
      v = fe_mul<N>(load_lane<N>(chain_slot(tile, u & 1, s - off, n, N, G), G, g), v, M);
    store_lane<N>(chain_slot(tile, p & 1, s, n, N, G), G, g, v);
  } else if (p == L + 1) {
    Fe<N> run = s > 0 ? load_lane<N>(chain_slot(tile, L & 1, s - 1, n, N, G), G, g)
                      : fe_one<N>(M);
    for (int c = c0; c < c1; ++c) {
      store_lane<N>(pe + c * link, Mw, m, run);
      if (c + 1 < c1) run = fe_mul<N>(run, load_lane<N>(d + c * link, Mw, m), M);
    }
    if (s == n - 1)
      store_lane<N>(bp, Mw, m, load_lane<N>(chain_slot(tile, L & 1, s, n, N, G), G, g));
  }
}

}  // namespace ctt
