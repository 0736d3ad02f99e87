// Host build of chain.cuh for the tests: K8's prefix scan over segments and
// K10's suffix scan played on the CPU, so their levels, the exclusive shifts
// and the stores can be held against the plain PyTorch versions on a
// machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libchain_host.so chain_host.cpp
//
// Arrays are the kernels' planar layouts: d, pe and inv (C, nl, Mw), bp and
// bpinv (nl, Mw), u32 limbs in Montgomery form over nl = 8 or 12 limbs;
// mod_words is p[nl], m0, one[nl] as in ec.cuh.
#include <vector>

#include "chain.cuh"

using namespace ctt;

namespace {

// Every block of the launch, one after the other, its tile (two buffers of
// rows x N x G words) filled with `fill`; in each of the L + 2 phases, L =
// chain_levels(rows), the block's G x rows threads one after the other, in
// order or reversed (the barrier between phases). phase(tile, m0, g, row,
// p) is one thread's phase.
template <int N, class Phase>
void play_blocks(int rows, int Mw, int G, int reverse, uint32_t fill, Phase phase) {
  const int L = chain_levels(rows), nthr = G * rows;
  std::vector<uint32_t> tile(chain_tile_words(rows, N, G));
  for (int m0 = 0; m0 < Mw; m0 += G) {
    tile.assign(tile.size(), fill);
    for (int p = 0; p <= L + 1; ++p)
      for (int i = 0; i < nthr; ++i) {
        const int t = reverse ? nthr - 1 - i : i;
        phase(tile.data(), m0, t % G, t / G, p);
      }
  }
}

template <int N>
void chain_bwd_blocks(const uint32_t* mod_words, const uint32_t* pe, const uint32_t* d,
                      const uint32_t* bpinv, uint32_t* inv, int C, int Mw, int G, int reverse,
                      uint32_t fill) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  play_blocks<N>(C, Mw, G, reverse, fill, [&](uint32_t* tile, int m0, int g, int c, int p) {
    chain_bwd_phase<N>(md, pe, d, bpinv, inv, tile, C, Mw, G, m0, g, c, p);
  });
}

template <int N>
void chain_fwd_blocks(const uint32_t* mod_words, const uint32_t* d, uint32_t* pe, uint32_t* bp,
                      int C, int S, int Mw, int G, int reverse, uint32_t fill) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  play_blocks<N>((C + S - 1) / S, Mw, G, reverse, fill,
                 [&](uint32_t* tile, int m0, int g, int s, int p) {
                   chain_fwd_phase<N>(md, d, pe, bp, tile, C, S, Mw, G, m0, g, s, p);
                 });
}

bool bad_shape(int nl, int C, int G) {
  return (nl != 8 && nl != 12) || C < 1 || C > CHAIN_MAX_C || G < 1;
}

}  // namespace

// K10. Returns the scan's levels, or -1 for a limb count other than 8 and
// 12 or a chain longer than CHAIN_MAX_C.
extern "C" int ctt_host_chain_bwd_inv(int nl, const uint32_t* mod_words, const uint32_t* pe,
                                      const uint32_t* d, const uint32_t* bpinv, uint32_t* inv,
                                      int C, int Mw, int G, int reverse, uint32_t fill) {
  if (bad_shape(nl, C, G)) return -1;
  if (nl == 8)
    chain_bwd_blocks<8>(mod_words, pe, d, bpinv, inv, C, Mw, G, reverse, fill);
  else
    chain_bwd_blocks<12>(mod_words, pe, d, bpinv, inv, C, Mw, G, reverse, fill);
  return chain_levels(C);
}

// K8 over segments of S >= 1 links a thread: pe and bp from d. Returns the
// scan's levels over the segments, or -1 as ctt_host_chain_bwd_inv does.
extern "C" int ctt_host_chain_fwd(int nl, const uint32_t* mod_words, const uint32_t* d,
                                  uint32_t* pe, uint32_t* bp, int C, int S, int Mw, int G,
                                  int reverse, uint32_t fill) {
  if (bad_shape(nl, C, G) || S < 1) return -1;
  if (nl == 8)
    chain_fwd_blocks<8>(mod_words, d, pe, bp, C, S, Mw, G, reverse, fill);
  else
    chain_fwd_blocks<12>(mod_words, d, pe, bp, C, S, Mw, G, reverse, fill);
  return chain_levels((C + S - 1) / S);
}

extern "C" int ctt_host_chain_max_c() { return CHAIN_MAX_C; }
