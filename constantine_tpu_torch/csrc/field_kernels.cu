// K1: a chain of Montgomery products in one launch,
//
//     out = (f0 * f1 * ... * f_{m-1})^(2^k),   each product a * b * R^-1 mod p,
//
// with 1 <= m <= 4 factors and k >= 0 squarings (m - 1 + k >= 1).
//
// Replaces constantine_tpu/ops/pallas_field.py:_mont_mul_kernel
// (PallasMontMul.mul), which runs the CIOS over 16-bit digits in u32 lanes
// on (L, TB) blocks and which the reference's Field.mul launches for every
// product. Here one thread computes one element's whole chain with the
// 32-bit-limb CIOS of ec.cuh (12 limbs for Fp, 8 for Fr), so z^(2^12) is one
// launch, not twelve, and a product of three is one, not two.
//
// Operands stay in the callers' (n, N) row layout. Element i reads factor j
// at row i mod period_j: a period of n is a full operand, 1 one row for all
// (a constant), 4,096 a table repeated down a batch (the roots against a
// batch of blobs), so a broadcast operand is read where it lies, never
// copied out first.
//
// What bounds it on an H100: at the paths' widest call (90,112 elements) one
// product is ~600 integer operations on 3 x 48 bytes moved, so the bytes and
// the multiplies take about as long, a few microseconds each. A thread moves
// its row as 16-byte words (3 for Fp, 2 for Fr), loads every factor before
// the first product, and keeps the chain in registers. Most calls are small
// (1 to 4,096 elements): there the wrapper's host cost is the time, and the
// chain's one launch is the saving.
#include <cuda_runtime.h>

#include "chain.cuh"
#include "ec.cuh"
#include "inv.cuh"

using namespace ctt;

// Threads a block, and the product fe_mul_eo (two carry chains) rather than
// fe_mul: both chosen on the H100 (PERF.md, scripts/torch_chain_teams.py).
constexpr int K1_THREADS = 64;

struct K1Factors {
  const uint4* f[4];
  int period[4];
};

template <int N>
__device__ __forceinline__ Fe<N> k1_load(const uint4* __restrict__ base, int row) {
  static_assert(N % 4 == 0, "rows of whole 16-byte words");
  Fe<N> r;
  const uint4* p = base + (size_t)row * (N / 4);
#pragma unroll
  for (int w = 0; w < N / 4; ++w) {
    const uint4 q = __ldg(p + w);
    r.v[4 * w] = q.x;
    r.v[4 * w + 1] = q.y;
    r.v[4 * w + 2] = q.z;
    r.v[4 * w + 3] = q.w;
  }
  return r;
}

template <int N, int M>
__global__ void __launch_bounds__(K1_THREADS)
    mont_mul_kernel(Mod<N> md, K1Factors fs, uint4* __restrict__ out, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<N> x[M];
#pragma unroll
  for (int j = 0; j < M; ++j) x[j] = k1_load<N>(fs.f[j], i % fs.period[j]);
  Fe<N> acc = x[0];
#pragma unroll
  for (int j = 1; j < M; ++j) acc = fe_mul_eo<N>(acc, x[j], md);
  for (int s = 0; s < k; ++s) acc = fe_mul_eo<N>(acc, acc, md);
  uint4* o = out + (size_t)i * (N / 4);
#pragma unroll
  for (int w = 0; w < N / 4; ++w)
    o[w] = make_uint4(acc.v[4 * w], acc.v[4 * w + 1], acc.v[4 * w + 2], acc.v[4 * w + 3]);
}

template <int N, int M>
static void launch_mont_prod(const Mod<N>& md, const K1Factors& fs, void* out, int n, int k,
                             cudaStream_t s) {
  mont_mul_kernel<N, M><<<(n + K1_THREADS - 1) / K1_THREADS, K1_THREADS, 0, s>>>(
      md, fs, (uint4*)out, n, k);
}

template <int N>
static int mont_prod_n(const uint32_t* mod_words, int m, const K1Factors& fs, void* out, int n,
                       int k, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  switch (m) {
    case 1:
      launch_mont_prod<N, 1>(md, fs, out, n, k, s);
      break;
    case 2:
      launch_mont_prod<N, 2>(md, fs, out, n, k, s);
      break;
    case 3:
      launch_mont_prod<N, 3>(md, fs, out, n, k, s);
      break;
    case 4:
      launch_mont_prod<N, 4>(md, fs, out, n, k, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// f0..f3: the factors' rows (16-byte aligned; those past m unused), p0..p3
// their periods (1 <= p <= n), out (n, nl).
extern "C" int ctt_mont_prod(int nl, const uint32_t* mod_words, int m, int k, const void* f0,
                             const void* f1, const void* f2, const void* f3, int p0, int p1,
                             int p2, int p3, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > 4 || k < 0 || m - 1 + k < 1) return (int)cudaErrorInvalidValue;
  const K1Factors fs{{(const uint4*)f0, (const uint4*)f1, (const uint4*)f2, (const uint4*)f3},
                     {p0, p1, p2, p3}};
  for (int j = 0; j < m; ++j)
    if (fs.f[j] == nullptr || fs.period[j] < 1 || fs.period[j] > n)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 8:
      return mont_prod_n<8>(mod_words, m, fs, out, n, k, s);
    case 12:
      return mont_prod_n<12>(mod_words, m, fs, out, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// index map). Here K8 is an exclusive prefix scan over segments of the
// chain, a thread a segment, and K10 an exclusive suffix scan over the
// chain axis, a thread a link, both in shared memory (chain.cuh).
//
// Bound on an H100: K8 and K10 do 1 and 2 multiplies per element against
// 2-3 elements moved (300-600 operations per 48-96 bytes), so they sit near
// the balance of the two bounds and are latency-bound below a few hundred
// thousand lanes; the scans trade more products a lane (K8 about 2C, K10 C
// log C) for a depth of 2 (S - 1) + log2(C / S) (K8) or log C + 2 (K10)
// products.
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

// K8's links a thread and lanes a block (PERF.md: chosen on the H100): below
// CHAIN_FWD_WIDE lanes, where a chain's depth decides, segments of 2 links
// and 4 lanes a block (the paths' Mw = 512: 128 blocks); from there on,
// where the card is busy and the products' count decides, 4 links and 16
// lanes. The tile is then at most 2 x 16 x 12 x 4 words (6 KB) or 2 x 8 x 12
// x 16 (12 KB): no opt-in above 48 KB.
constexpr int CHAIN_FWD_WIDE = 2048;

// dC (C, N, Mw) -> pe (C, N, Mw), pe[c] = d[0] * ... * d[c-1] (exclusive),
// and bp (N, Mw), the product of the whole chain, for every segment of S
// links of a block of G lanes (chain.cuh chain_fwd_phase), a barrier
// between the scan's phases.
template <int N, int S, int G>
__global__ void __launch_bounds__(G * CHAIN_MAX_C / S)
    chain_fwd_kernel(Mod<N> md, const uint32_t* __restrict__ d, uint32_t* __restrict__ pe,
                     uint32_t* __restrict__ bp, int C, int Mw) {
  extern __shared__ uint32_t chain_tile[];
  const int L = chain_levels((C + S - 1) / S);
  for (int p = 0; p <= L + 1; ++p) {
    chain_fwd_phase<N>(md, d, pe, bp, chain_tile, C, S, Mw, G, blockIdx.x * G, threadIdx.x,
                       threadIdx.y, p);
    if (p <= L) __syncthreads();
  }
}

// K10's lanes a block, by limb count (PERF.md: chosen on the H100): 4 for
// Fr, whose chains of 512 lanes then take 128 blocks, 8 for Fp.
template <int N>
struct ChainG {
  static constexpr int value = N == 8 ? 4 : 8;
};

// inv[c] = bpinv * d[c+1] * ... * d[C-1] * pe[c] for every link c of a
// block of ChainG lanes (chain.cuh chain_bwd_phase), a barrier between the
// scan's phases.
template <int N>
__global__ void __launch_bounds__(ChainG<N>::value * CHAIN_MAX_C)
    chain_bwd_inv_kernel(Mod<N> md, const uint32_t* __restrict__ pe,
                         const uint32_t* __restrict__ d, const uint32_t* __restrict__ bpinv,
                         uint32_t* __restrict__ inv, int C, int Mw) {
  extern __shared__ uint32_t chain_tile[];
  const int L = chain_levels(C);
  for (int p = 0; p <= L + 1; ++p) {
    chain_bwd_phase<N>(md, pe, d, bpinv, inv, chain_tile, C, Mw, ChainG<N>::value,
                       blockIdx.x * ChainG<N>::value, threadIdx.x, threadIdx.y, p);
    if (p <= L) __syncthreads();
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

template <int N, int S, int G>
static void launch_chain_fwd_sg(const Mod<N>& md, const void* d, void* pe, void* bp, int C,
                                int Mw, cudaStream_t s) {
  const int n = (C + S - 1) / S;
  chain_fwd_kernel<N, S, G><<<(Mw + G - 1) / G, dim3(G, n),
                              chain_tile_words(n, N, G) * sizeof(uint32_t), s>>>(
      md, (const uint32_t*)d, (uint32_t*)pe, (uint32_t*)bp, C, Mw);
}

template <int N>
static void launch_chain_fwd(const uint32_t* mod_words, const void* d, void* pe, void* bp,
                             int C, int Mw, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  if (Mw < CHAIN_FWD_WIDE)
    launch_chain_fwd_sg<N, 2, 4>(md, d, pe, bp, C, Mw, s);
  else
    launch_chain_fwd_sg<N, 4, 16>(md, d, pe, bp, C, Mw, s);
}

template <int N>
static void launch_chain_bwd_inv(const uint32_t* mod_words, const void* pe, const void* d,
                                 const void* bpinv, void* inv, int C, int Mw,
                                 cudaStream_t s) {
  constexpr int G = ChainG<N>::value;
  const size_t smem = chain_tile_words(C, N, G) * sizeof(uint32_t);
  static bool opted = false;  // the tile at C = CHAIN_MAX_C may pass 48 KB
  if (!opted) {
    cudaFuncSetAttribute(chain_bwd_inv_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)(chain_tile_words(CHAIN_MAX_C, N, G) * sizeof(uint32_t)));
    opted = true;
  }
  chain_bwd_inv_kernel<N><<<(Mw + G - 1) / G, dim3(G, C), smem, s>>>(
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

// C <= CHAIN_MAX_C links a chain.
extern "C" int ctt_chain_fwd(int nl, const uint32_t* mod_words, const void* d, void* pe,
                             void* bp, int C, int Mw, void* stream) {
  if (C <= 0 || Mw <= 0) return (int)cudaGetLastError();
  if (C > CHAIN_MAX_C) return (int)cudaErrorInvalidValue;
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

// C <= CHAIN_MAX_C links a chain.
extern "C" int ctt_chain_bwd_inv(int nl, const uint32_t* mod_words, const void* pe,
                                 const void* d, const void* bpinv, void* inv, int C, int Mw,
                                 void* stream) {
  if (C <= 0 || Mw <= 0) return (int)cudaGetLastError();
  if (C > CHAIN_MAX_C) return (int)cudaErrorInvalidValue;
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
