// K10: the backward chain of batched inversion as a suffix scan over a tile
// in shared memory, shared by the CUDA kernel (field_kernels.cu) and the host
// build the tests use (chain_host.cpp).
//
// Replaces constantine_tpu/ops/pallas_ec.py:chain_bwd_inv, which walks a
// chain's C links in reverse on the grid's minor axis with the running
// product in VMEM scratch: inv[c] = run * pe[c], then run *= d[c], run
// starting at bpinv, the inverse of the chain's product. Written out,
//
//     inv[c] = bpinv * S[c] * pe[c],   S[c] = d[c+1] * ... * d[C-1],   S[C-1] = 1,
//
// so the walk is an exclusive suffix product of d. Field products are exact
// and canonical, so any order of them gives the walk's limbs.
//
// Layout: chains (C, N, Mw) and lanes (N, Mw), the lane axis contiguous (the
// port's planar layout, CudaAffine). A block takes G lanes m0 .. m0 + G - 1
// of every link: thread (g, c) -- threadIdx.x = g along the lanes, so a
// warp's loads of one limb are contiguous, threadIdx.y = c along the chain.
// The tile holds two buffers of C x N x G words, element (c, g) with limb l
// at word (c N + l) G + g, so a warp's accesses to one limb fall on
// consecutive banks.
//
// What bounds it on an H100: at the paths' Mw = 512 the parent's one thread
// a lane was 4 blocks on 132 SMs, its time a chain of C = 32 dependent
// products. Here the chain is a Hillis-Steele scan, ceil(log2 C) = 5 levels
// of one product a thread between barriers, then two products a thread:
// 7 products deep instead of the parent's 32, on C times as many threads.
// The scan does about C log C + 2C products a lane (the parent 2C), which
// costs at the widest call, Mw = 8,192, where the card is busy (PERF.md).
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

// Phase p of thread (g, c) in the block whose lanes start at m0; the tile
// holds a barrier between phases. With L = chain_levels(C):
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

}  // namespace ctt
