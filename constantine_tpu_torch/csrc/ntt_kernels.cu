// K3': the NTT stage kernels over Fr (8 limbs), templated on the limb count.
//
// Replace constantine_tpu/ops/pallas_ec.py:_elemwise as the NTT uses it:
//   ntt_bfly  constantine_tpu/ops/ntt.py:168  (ctt_ntt_bfly)
//   ntt_twm   constantine_tpu/ops/ntt.py:198  (ctt_ntt_twm)
// The TPU kernels take planar (16, n) digit planes padded to 512 lanes, with
// the stage's operands a, b and the twiddle plane cut out and put back by
// XLA slices and a concatenate around every call. Here one launch does a
// whole stage in the natural (batch, ns, lanes, 8) layout, in place, with
// the index arithmetic of ntt.cuh; the twiddle is read from the stage's
// (h, 8) table, not from a plane repeated over the lanes.
//
// Bound on an H100: a butterfly is one 8-limb Montgomery multiply (~136
// 32x32->64 products) and an add and a sub against 96 bytes read and 64
// written, so a stage sits near the balance of the two bounds; at PeerDAS's
// sizes (4,096 butterflies a stage) it is one wave of 16 blocks and the
// launch itself is most of the time. One thread per butterfly keeps the
// operands in registers; each thread reads 32 contiguous bytes per element
// and neighbouring threads neighbouring elements (lanes = 1) or lanes.
#include <cuda_runtime.h>

#include "ntt.cuh"

using namespace ctt;

namespace {

constexpr int THREADS = 256;

template <int N>
__global__ void ntt_bfly_kernel(Mod<N> md, const uint32_t* x, uint32_t* out,
                                const uint32_t* __restrict__ tw, int ns, int lanes, int h,
                                int nb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nb) return;
  ntt_bfly_at<N>(md, x, out, tw, j, ns, lanes, h);
}

template <int N>
__global__ void ntt_twm_kernel(Mod<N> md, const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ t, uint32_t* __restrict__ out,
                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ntt_twm_at<N>(md, x, t, out, i);
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// One radix-2 DIT stage, half-block h, over x (batch, ns, lanes, nl) into out
// (which may be x).
extern "C" int ctt_ntt_bfly(int nl, const uint32_t* mod_words, const void* x, void* out,
                            const void* tw, int batch, int ns, int lanes, int h,
                            void* stream) {
  if (batch <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if (ns < 2 || (ns & (ns - 1)) || h < 1 || 2 * h > ns || (h & (h - 1)))
    return (int)cudaErrorInvalidValue;
  const long nb = (long)batch * (ns / 2) * lanes;
  if (nb * 2 * nl >= (1L << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      ntt_bfly_kernel<8><<<blocks((int)nb), THREADS, 0, s>>>(
          mod_from_words<8>(mod_words), (const uint32_t*)x, (uint32_t*)out,
          (const uint32_t*)tw, ns, lanes, h, (int)nb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = x * t (Montgomery) over n elements: the four-step's twiddle matrix.
extern "C" int ctt_ntt_twm(int nl, const uint32_t* mod_words, const void* x, const void* t,
                           void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      ntt_twm_kernel<8><<<blocks(n), THREADS, 0, s>>>(
          mod_from_words<8>(mod_words), (const uint32_t*)x, (const uint32_t*)t,
          (uint32_t*)out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
