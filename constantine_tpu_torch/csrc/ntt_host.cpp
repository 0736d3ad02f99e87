// Host build of ntt.cuh for the tests: the K3' kernels' per-element code
// behind a plain C interface, looped over the work on the CPU, so the
// kernels' index arithmetic and field code can be held against the plain
// PyTorch versions on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libntt_host.so ntt_host.cpp
//
// Arrays are row-major u32 limbs in Montgomery form over 8-limb Fr;
// mod_words is p[8], m0, one[8] as in ec.cuh.
#include "ntt.cuh"

using namespace ctt;

extern "C" void ctt_host_ntt_bfly(const uint32_t* mod_words, const uint32_t* x,
                                  uint32_t* out, const uint32_t* tw, int batch, int ns,
                                  int lanes, int h) {
  const Mod<8> md = mod_from_words<8>(mod_words);
  const int nb = batch * (ns / 2) * lanes;
  for (int j = 0; j < nb; ++j) ntt_bfly_at<8>(md, x, out, tw, j, ns, lanes, h);
}

extern "C" void ctt_host_ntt_twm(const uint32_t* mod_words, const uint32_t* x,
                                 const uint32_t* t, uint32_t* out, int n) {
  const Mod<8> md = mod_from_words<8>(mod_words);
  for (int i = 0; i < n; ++i) ntt_twm_at<8>(md, x, t, out, i);
}
