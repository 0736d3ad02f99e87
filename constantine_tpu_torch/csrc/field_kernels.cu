// K1: batched Montgomery multiply, out = a * b * R^-1 mod p.
//
// Replaces constantine_tpu/ops/pallas_field.py:_mont_mul_kernel
// (PallasMontMul.mul), which runs the CIOS over 16-bit digits in u32 lanes
// on (L, TB) blocks. Here one thread multiplies one element with the
// 32-bit-limb CIOS of ec.cuh (12 limbs for Fp, 8 for Fr).
//
// Bound on an H100: integer multiply issue (about 2N^2 32x32->64 products
// per element against 3*4N bytes moved), far above the memory roofline.
// The design keeps the element in registers and reads each operand once;
// operands stay in the callers' (n, N) row layout, where a warp reads a
// contiguous span of 32*4N bytes, so loads are fully used cache lines.
#include <cuda_runtime.h>

#include "ec.cuh"

using namespace ctt;

template <int N>
__global__ void mont_mul_kernel(Mod<N> md, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<N> x, y;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    x.v[l] = a[(size_t)i * N + l];
    y.v[l] = b[(size_t)i * N + l];
  }
  const Fe<N> r = fe_mul<N>(x, y, md);
#pragma unroll
  for (int l = 0; l < N; ++l) out[(size_t)i * N + l] = r.v[l];
}

template <int N>
static void launch_mont_mul(const uint32_t* mod_words, const void* a, const void* b,
                            void* out, int n, cudaStream_t stream) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  const int threads = 256;
  mont_mul_kernel<N><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      md, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
}

extern "C" int ctt_mont_mul(int nl, const uint32_t* mod_words, const void* a,
                            const void* b, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      launch_mont_mul<8>(mod_words, a, b, out, n, s);
      break;
    case 12:
      launch_mont_mul<12>(mod_words, a, b, out, n, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ctt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
