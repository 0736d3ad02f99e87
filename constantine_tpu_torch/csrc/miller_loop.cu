// K11 miller_loop: the BLS12-381 Miller loop, one thread per pair, over
// pairing.cuh. (K12 is final_exp.cu: one nvcc process each, built in
// parallel.)
//
// Replaces constantine_tpu/ops/pallas_pairing.py:_miller_fn
// (ctt_miller_loop). The TPU kernel puts the batch on the 128-wide lanes of
// (L, TB) blocks and walks the loop bits from SMEM; here a thread owns one
// pair and loops over the bits of |x| itself.
//
// Layout: row-major, lane-major: P (B, 12) x 2 and Q (B, 2, 12) x 2 in,
// f (B, 12, 12) out; Montgomery form.
//
// Bound on an H100: a lone thread's chain of dependent 12-limb multiplies:
// 8,053 a pair (63 doubling iterations of 121: the Fp12 squaring, the
// doubling step, the sparse line product; 5 addition steps of 86). At the
// verify's B = 2 nothing else runs beside it, so the time is that chain's
// latency; at B = 256 four blocks of 64 threads fill 4 SMs with the same
// chain each. The tower products are calls (tower.cuh), which keeps the
// build time down; Fp12 values live in local memory.
#include <cuda_runtime.h>

#include "pairing.cuh"

using namespace ctt;

namespace {

constexpr int THREADS = 64;

__global__ void miller_loop_kernel(PairingConsts C, const uint32_t* __restrict__ xp,
                                   const uint32_t* __restrict__ yp,
                                   const uint32_t* __restrict__ xq,
                                   const uint32_t* __restrict__ yq,
                                   uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp xP = fp_load(xp + (size_t)i * FPN);
  const Fp yP = fp_load(yp + (size_t)i * FPN);
  const Fp2 xQ{fp_load(xq + (size_t)i * 2 * FPN), fp_load(xq + (size_t)i * 2 * FPN + FPN)};
  const Fp2 yQ{fp_load(yq + (size_t)i * 2 * FPN), fp_load(yq + (size_t)i * 2 * FPN + FPN)};
  f12store(out + (size_t)i * 12 * FPN, miller_loop_lane(xP, yP, xQ, yQ, C));
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// consts: the host layout of PairingConsts (ops/cuda_pairing.py packs it).
extern "C" int ctt_miller_loop(const void* consts, const void* xp, const void* yp,
                               const void* xq, const void* yq, void* out, int n,
                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const PairingConsts C = *(const PairingConsts*)consts;
  miller_loop_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      C, (const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)xq,
      (const uint32_t*)yq, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ctt_pairing_consts_size() { return (int)sizeof(PairingConsts); }
