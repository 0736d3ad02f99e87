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
#include "inv.cuh"

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

// K8-K10: batched inversion by Montgomery chains (12-limb Fp and 8-limb Fr).
//
// Replace constantine_tpu/ops/pallas_ec.py:PallasAffine
//   K8  chain_fwd      (ctt_chain_fwd)
//   K9  fermat_inv     (ctt_fermat_inv)
//   K10 chain_bwd_inv  (ctt_chain_bwd_inv)
// which batch_inv_packed composes: products chained down C, one inversion
// of each chain's total, then the unwind. The reference's packed
// layout (two 16-bit digits per u32) is this port's native 32-bit limb, so
// the planar layouts carry over as they are: chains (C, N, Mw), lanes (N, Wd)
// with the lane axis contiguous, and a warp's loads of one limb contiguous.
//
// Translation of the sequential grid: the TPU walks C on the grid's minor
// axis with the running product in VMEM scratch (K10 in reverse through its
// index map). Here one thread owns lane m and loops over c itself.
//
// Bound on an H100: K8 and K10 do 1 and 2 multiplies per element against
// 2-3 elements moved (300-600 operations per 48-96 bytes), so they sit near
// the balance of the two bounds and are latency-bound below a few hundred
// thousand lanes; the design keeps the running product in registers and
// reads each element once.
//
// K9 runs on 1 to 512 lanes (at most 4 blocks), so it is one lane's latency
// whatever its operations. The reference's square-and-multiply over p - 2 is
// a chain of 610 dependent products for Fp (419 for Fr), ~0.96 ms on the
// H100 over fe_mul. Here a lane inverts by Bernstein-Yang's safegcd (inv.cuh
// fe_inv): a fixed number of batches of INV_BITS = 30 divsteps (37 for Fp,
// 25 for Fr), each a branch-free loop on one word that yields a 2x2
// matrix, then that matrix applied to f, g, d and e (L limbs each, products
// of independent limbs), and one fe_mul at the end by R^3 mod p to return to
// Montgomery form (~0.05 ms for Fp and ~0.03 for Fr on the H100). The result
// is the unique inverse, so its limbs are the reference's; the time does not
// depend on the input, and 0 gives 0.

template <int N>
__device__ __forceinline__ Fe<N> load_lane(const uint32_t* __restrict__ base, int stride,
                                           int idx) {
  Fe<N> r;
#pragma unroll
  for (int l = 0; l < N; ++l) r.v[l] = base[(size_t)l * stride + idx];
  return r;
}

template <int N>
__device__ __forceinline__ void store_lane(uint32_t* __restrict__ base, int stride, int idx,
                                           const Fe<N>& v) {
#pragma unroll
  for (int l = 0; l < N; ++l) base[(size_t)l * stride + idx] = v.v[l];
}

// dC (C, N, Mw) -> pe (C, N, Mw), pe[c] = d[0] * ... * d[c-1] (exclusive),
// and bp (N, Mw), the product of the whole chain.
template <int N>
__global__ void chain_fwd_kernel(Mod<N> md, const uint32_t* __restrict__ d,
                                 uint32_t* __restrict__ pe, uint32_t* __restrict__ bp,
                                 int C, int Mw) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mw) return;
  Fe<N> run = fe_one<N>(md);
  for (int c = 0; c < C; ++c) {
    const size_t off = (size_t)c * N * Mw;
    store_lane<N>(pe + off, Mw, m, run);
    run = fe_mul<N>(run, load_lane<N>(d + off, Mw, m), md);
  }
  store_lane<N>(bp, Mw, m, run);
}

// inv[c] = run * pe[c], then run *= d[c], for c = C-1 .. 0, run starting at
// the inverse of the chain's product.
template <int N>
__global__ void chain_bwd_inv_kernel(Mod<N> md, const uint32_t* __restrict__ pe,
                                     const uint32_t* __restrict__ d,
                                     const uint32_t* __restrict__ bpinv,
                                     uint32_t* __restrict__ inv, int C, int Mw) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mw) return;
  Fe<N> run = load_lane<N>(bpinv, Mw, m);
  for (int c = C - 1; c >= 0; --c) {
    const size_t off = (size_t)c * N * Mw;
    store_lane<N>(inv + off, Mw, m, fe_mul<N>(run, load_lane<N>(pe + off, Mw, m), md));
    run = fe_mul<N>(run, load_lane<N>(d + off, Mw, m), md);
  }
}

// x (N, n) -> x^-1 per lane, Montgomery form in and out (0 gives 0).
template <int N>
__global__ void fermat_inv_kernel(Mod<N> md, InvConsts<N> ic,
                                  const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_lane<N>(out, n, i, fe_inv<N>(load_lane<N>(x, n, i), ic, md));
}

constexpr int CHAIN_THREADS = 128;

inline int chain_blocks(int n) { return (n + CHAIN_THREADS - 1) / CHAIN_THREADS; }

template <int N>
static void launch_chain_fwd(const uint32_t* mod_words, const void* d, void* pe, void* bp,
                             int C, int Mw, cudaStream_t s) {
  chain_fwd_kernel<N><<<chain_blocks(Mw), CHAIN_THREADS, 0, s>>>(
      mod_from_words<N>(mod_words), (const uint32_t*)d, (uint32_t*)pe, (uint32_t*)bp, C, Mw);
}

template <int N>
static void launch_chain_bwd_inv(const uint32_t* mod_words, const void* pe, const void* d,
                                 const void* bpinv, void* inv, int C, int Mw,
                                 cudaStream_t s) {
  chain_bwd_inv_kernel<N><<<chain_blocks(Mw), CHAIN_THREADS, 0, s>>>(
      mod_from_words<N>(mod_words), (const uint32_t*)pe, (const uint32_t*)d,
      (const uint32_t*)bpinv, (uint32_t*)inv, C, Mw);
}

template <int N>
static void launch_fermat_inv(const uint32_t* mod_words, const uint32_t* r3_words, const void* x,
                              void* out, int n, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  fermat_inv_kernel<N><<<chain_blocks(n), CHAIN_THREADS, 0, s>>>(
      md, inv_consts<N>(md, r3_words), (const uint32_t*)x, (uint32_t*)out, n);
}

extern "C" int ctt_chain_fwd(int nl, const uint32_t* mod_words, const void* d, void* pe,
                             void* bp, int C, int Mw, void* stream) {
  if (C <= 0 || Mw <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      launch_chain_fwd<8>(mod_words, d, pe, bp, C, Mw, s);
      break;
    case 12:
      launch_chain_fwd<12>(mod_words, d, pe, bp, C, Mw, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ctt_chain_bwd_inv(int nl, const uint32_t* mod_words, const void* pe,
                                 const void* d, const void* bpinv, void* inv, int C, int Mw,
                                 void* stream) {
  if (C <= 0 || Mw <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      launch_chain_bwd_inv<8>(mod_words, pe, d, bpinv, inv, C, Mw, s);
      break;
    case 12:
      launch_chain_bwd_inv<12>(mod_words, pe, d, bpinv, inv, C, Mw, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// r3_words: R^3 mod p (N words), which brings the integer inverse of aR back
// to Montgomery form.
extern "C" int ctt_fermat_inv(int nl, const uint32_t* mod_words, const uint32_t* r3_words,
                              const void* x, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      launch_fermat_inv<8>(mod_words, r3_words, x, out, n, s);
      break;
    case 12:
      launch_fermat_inv<12>(mod_words, r3_words, x, out, n, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ctt_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
