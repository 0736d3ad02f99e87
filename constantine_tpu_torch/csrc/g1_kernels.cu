// K13 g1_decompress: G1 decompression with the subgroup check, one thread
// per point, over g1.cuh.
//
// Replaces constantine_tpu/ops/pallas_g1.py:PallasG1._fn (ctt_g1_decompress),
// which runs the same sqrt, sign fix and Scott ladder on (L, TB) blocks with
// the exponent and ladder bits in SMEM; here they go by value in a struct
// and each thread walks them.
//
// Layout: x Montgomery (N, 12) row-major, sign (N,) int32 -> y (N, 12)
// Montgomery, ok (N,) int32.
//
// Bound on an H100: the lane's dependent chain of 1,680 multiplies (the
// square root's 378 squarings and 228 multiplies, the ladder's 127
// doublings and 16 additions); the verify runs it on 2 to 128 points, so it
// is latency-bound by design.
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace ctt;

namespace {

constexpr int THREADS = 64;

__global__ void g1_decompress_kernel(G1DecompressConsts C, const uint32_t* __restrict__ xm,
                                     const int32_t* __restrict__ sign,
                                     uint32_t* __restrict__ y, int32_t* __restrict__ ok,
                                     int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp yi;
  const bool good = g1_decompress_lane(fp_load(xm + (size_t)i * FPN), sign[i] != 0, yi, C);
  fp_store(y + (size_t)i * FPN, yi);
  ok[i] = good ? 1 : 0;
}

}  // namespace

// consts: the host layout of G1DecompressConsts (ops/cuda_g1.py packs it).
extern "C" int ctt_g1_decompress(const void* consts, const void* xm, const void* sign,
                                 void* y, void* ok, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const G1DecompressConsts C = *(const G1DecompressConsts*)consts;
  g1_decompress_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      C, (const uint32_t*)xm, (const int32_t*)sign, (uint32_t*)y, (int32_t*)ok, n);
  return (int)cudaGetLastError();
}

extern "C" int ctt_g1_consts_size() { return (int)sizeof(G1DecompressConsts); }
