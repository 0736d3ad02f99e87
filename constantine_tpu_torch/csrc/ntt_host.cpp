// Host build of ntt.cuh for the tests: the K3' kernels' per-element code
// behind a plain C interface, looped over the work on the CPU, so the
// kernels' index arithmetic and field code can be held against the plain
// PyTorch versions on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libntt_host.so ntt_host.cpp
//
// Arrays are row-major u32 limbs in Montgomery form over 8-limb Fr;
// mod_words is p[8], m0, one[8] as in ec.cuh.
#include <vector>

#include "ntt.cuh"

using namespace ctt;

extern "C" void ctt_host_ntt_bfly(const uint32_t* mod_words, const uint32_t* x,
                                  uint32_t* out, const uint32_t* tw, int batch, int ns,
                                  int lanes, int h) {
  const Mod<8> md = mod_from_words<8>(mod_words);
  const int nb = batch * (ns / 2) * lanes;
  for (int j = 0; j < nb; ++j) ntt_bfly_at<8>(md, x, out, tw, j, ns, lanes, h);
}

namespace {

template <bool InFac, bool OutFac, bool Transposed>
void host_pass(const Mod<8>& md, const uint32_t* x, uint32_t* out, const uint32_t* tw,
               const int64_t* brp, const NttFactors& fac, int batch, int ns, int lanes,
               int stages, int cols, int nthr, int reverse, uint32_t fill) {
  const int S = 1 << stages;
  const int nblocks = batch * (ns / S) * (lanes / cols);
  const int phases = ntt_tile_phases<InFac, OutFac>(stages);
  std::vector<uint32_t> tile((size_t)S * cols * (8 + 1));
  for (int blk = 0; blk < nblocks; ++blk) {
    const NttTile t = ntt_tile_at(blk, ns, lanes, S, cols);
    tile.assign(tile.size(), fill);
    for (int p = 0; p < phases; ++p)
      for (int i = 0; i < nthr; ++i)
        ntt_tile_phase<8, InFac, OutFac, Transposed>(t, md, x, out, tw, brp, fac, tile.data(),
                                                     stages, p, reverse ? nthr - 1 - i : i,
                                                     nthr);
  }
}

using HostPass = void (*)(const Mod<8>&, const uint32_t*, uint32_t*, const uint32_t*,
                          const int64_t*, const NttFactors&, int, int, int, int, int, int, int,
                          uint32_t);

// host_pass at (InFac, OutFac, Transposed), indexed by their bits 4, 2, 1.
const HostPass HOST_PASSES[8] = {
    host_pass<false, false, false>, host_pass<false, false, true>,
    host_pass<false, true, false>,  host_pass<false, true, true>,
    host_pass<true, false, false>,  host_pass<true, false, true>,
    host_pass<true, true, false>,   host_pass<true, true, true>};

}  // namespace

// A pass of ntt_stages (ntt.cuh ntt_tile_phase): every block of the launch,
// one after the other, with a tile filled with `fill`; in each phase, the
// block's nthr threads (ntt_stage_threads' count if nthr <= 0) one after the
// other, in order or reversed, the barrier between phases. brp holds ns
// int64 row indices; in_fac / out_fac are null or (period, 8) tables of
// period 1 or ns * lanes; transposed writes out as (batch, lanes, ns). out
// must not be x.
extern "C" void ctt_host_ntt_stages(const uint32_t* mod_words, const uint32_t* x, uint32_t* out,
                                    const uint32_t* tw, const int64_t* brp,
                                    const uint32_t* in_fac, int in_period,
                                    const uint32_t* out_fac, int out_period, int transposed,
                                    int batch, int ns, int lanes, int stages, int cols, int nthr,
                                    int reverse, uint32_t fill) {
  const Mod<8> md = mod_from_words<8>(mod_words);
  if (nthr <= 0) nthr = ntt_stage_threads(1 << stages, cols);
  const NttFactors fac{in_fac, in_period, out_fac, out_period};
  HOST_PASSES[(in_fac ? 4 : 0) | (out_fac ? 2 : 0) | (transposed ? 1 : 0)](
      md, x, out, tw, brp, fac, batch, ns, lanes, stages, cols, nthr, reverse, fill);
}
