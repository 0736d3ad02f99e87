// K12 final_exp: the BLS12-381 final exponentiation, one thread per Fp12,
// over pairing.cuh. (K11 is miller_loop.cu.)
//
// Replaces constantine_tpu/ops/pallas_pairing.py:_final_exp_fn
// (ctt_final_exp). The TPU kernel runs the hard part as a microcode
// interpreter over SMEM; here it is straight-line code with one loop per
// pow-x chain.
//
// Layout: row-major, lane-major: f (B, 12, 12) in and out; Montgomery
// form.
//
// Bound on an H100: a lone thread's chain of dependent 12-limb multiplies:
// about 8,400 a lane (five pow-x chains of 63 cyclotomic squarings and 5
// Fp12 products, 7,020; the Fermat inverse of the easy part, 608; the rest
// of the easy and hard parts). multi_pairing runs it on one lane, so the
// time is that chain's latency. The tower products are calls (tower.cuh);
// Fp12 values live in local memory.
#include <cuda_runtime.h>

#include "pairing.cuh"

using namespace ctt;

namespace {

constexpr int THREADS = 64;

__global__ void final_exp_kernel(PairingConsts C, const uint32_t* __restrict__ f,
                                 uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  f12store(out + (size_t)i * 12 * FPN, final_exp_lane(f12load(f + (size_t)i * 12 * FPN), C));
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// consts: the host layout of PairingConsts (ops/cuda_pairing.py packs it).
extern "C" int ctt_final_exp(const void* consts, const void* f, void* out, int n,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const PairingConsts C = *(const PairingConsts*)consts;
  final_exp_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      C, (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
