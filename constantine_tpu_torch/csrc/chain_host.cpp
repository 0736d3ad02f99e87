// Host build of chain.cuh for the tests: K10's suffix scan played on the
// CPU, so its levels, the exclusive shift and the store can be held against
// the plain PyTorch version on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libchain_host.so chain_host.cpp
//
// Arrays are the kernel's planar layouts: pe, d and inv (C, nl, Mw), bpinv
// (nl, Mw), u32 limbs in Montgomery form over nl = 8 or 12 limbs; mod_words
// is p[nl], m0, one[nl] as in ec.cuh.
#include <vector>

#include "chain.cuh"

using namespace ctt;

namespace {

// Every block of the launch, one after the other, its tile filled with
// `fill`; in each phase the block's G x C threads one after the other, in
// order or reversed (the barrier between phases).
template <int N>
void chain_bwd_blocks(const uint32_t* mod_words, const uint32_t* pe, const uint32_t* d,
                      const uint32_t* bpinv, uint32_t* inv, int C, int Mw, int G, int reverse,
                      uint32_t fill) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  const int L = chain_levels(C), nthr = G * C;
  std::vector<uint32_t> tile(chain_tile_words(C, N, G));
  for (int m0 = 0; m0 < Mw; m0 += G) {
    tile.assign(tile.size(), fill);
    for (int p = 0; p <= L + 1; ++p)
      for (int i = 0; i < nthr; ++i) {
        const int t = reverse ? nthr - 1 - i : i;
        chain_bwd_phase<N>(md, pe, d, bpinv, inv, tile.data(), C, Mw, G, m0, t % G, t / G, p);
      }
  }
}

}  // namespace

// Returns the scan's levels, or -1 for a limb count other than 8 and 12 or a
// chain longer than CHAIN_MAX_C.
extern "C" int ctt_host_chain_bwd_inv(int nl, const uint32_t* mod_words, const uint32_t* pe,
                                      const uint32_t* d, const uint32_t* bpinv, uint32_t* inv,
                                      int C, int Mw, int G, int reverse, uint32_t fill) {
  if (C < 1 || C > CHAIN_MAX_C || G < 1) return -1;
  if (nl == 8)
    chain_bwd_blocks<8>(mod_words, pe, d, bpinv, inv, C, Mw, G, reverse, fill);
  else if (nl == 12)
    chain_bwd_blocks<12>(mod_words, pe, d, bpinv, inv, C, Mw, G, reverse, fill);
  else
    return -1;
  return chain_levels(C);
}

extern "C" int ctt_host_chain_max_c() { return CHAIN_MAX_C; }
