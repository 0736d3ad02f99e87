// K3': the NTT stage kernels over Fr (8 limbs), templated on the limb count.
//
// Replace constantine_tpu/ops/pallas_ec.py:_elemwise as the NTT uses it:
//   ntt_bfly  constantine_tpu/ops/ntt.py:168  (ctt_ntt_stages, ctt_ntt_bfly)
//   ntt_twm   constantine_tpu/ops/ntt.py:198  (ctt_ntt_stages' store factor)
// The TPU kernels take planar (16, n) digit planes padded to 512 lanes, with
// the stage's operands a, b and the twiddle plane cut out and put back by
// XLA slices and a concatenate around every call, one call a stage. Here
// the natural (batch, ns, lanes, 8) layout stays as it is, with the index
// arithmetic of ntt.cuh; the twiddle is read from the stage's (h, 8) table,
// not from a plane repeated over the lanes.
//
// Bound on an H100: a butterfly is one 8-limb Montgomery multiply (~136
// 32x32->64 products) and an add and a sub against 96 bytes read and 64
// written, so a stage sits near the balance of the two bounds. But at
// PeerDAS's sizes (4,096-8,192 elements a transform) a stage is one wave of
// 16-32 blocks, and one launch a stage made the launch and its ctypes call
// most of the time (0.021-0.038 ms a call against 0.0044 on the device).
// ctt_ntt_stages runs a whole pass instead: the bit reversal folded into the
// load, then every stage of the pass over a tile in shared memory, S = 2^stages
// rows by G lanes (lanes contiguous, 32 bytes an element: a warp reads runs of
// 32 G bytes; G = 2 was the fastest on the H100, cuda_ntt.py TILE_COLS),
// __syncthreads() between stages, and one store. The pass takes a factor on
// its load and on its store and may store transposed (ntt.cuh), so the
// four-step is two launches: the column pass stores the product with the
// twiddle matrix transposed, and the row pass stores 1/n on the inverse; a
// coset transform's shift powers ride on the column pass's load (forward)
// or the row pass's store (inverse). Each combination of the three options
// is its own instantiation, so the plain pass carries no factor code.
// The paths' transforms (ns = 64 and 128 over 1-128 lanes) are one launch a
// pass. A transform too large for a tile (one lane of more than 4,096 rows,
// a batched radix-2 input) takes 12 stages in tiles of 4,096 rows (147 KB of
// shared memory) and the rest from ctt_ntt_bfly, one thread a butterfly over
// the whole array, a launch a stage.
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

// A pass: block blk's tile (ntt.cuh ntt_tile_at), its phases between barriers.
constexpr int STAGE_SMEM = 232448;  // the most shared memory a block takes on an H100

template <int N, bool InFac, bool OutFac, bool Transposed>
__global__ void __launch_bounds__(NTT_STAGE_THREADS)
ntt_stages_kernel(Mod<N> md, const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ tw, const int64_t* __restrict__ brp,
                  NttFactors fac, int ns, int lanes, int stages, int G) {
  extern __shared__ uint32_t tile[];
  const NttTile t = ntt_tile_at(blockIdx.x, ns, lanes, 1 << stages, G);
  const int phases = ntt_tile_phases<InFac, OutFac>(stages);
  for (int p = 0; p < phases; ++p) {
    if (p) __syncthreads();
    ntt_tile_phase<N, InFac, OutFac, Transposed>(t, md, x, out, tw, brp, fac, tile, stages, p,
                                                 threadIdx.x, blockDim.x);
  }
}

// Launch of the pass at one combination of the options.
template <int N, bool InFac, bool OutFac, bool Transposed>
void launch_stages(const Mod<N>& md, const uint32_t* x, uint32_t* out, const uint32_t* tw,
                   const int64_t* brp, const NttFactors& fac, int ns, int lanes, int stages,
                   int cols, long nblocks, int threads, size_t smem, cudaStream_t s) {
  auto* kernel = ntt_stages_kernel<N, InFac, OutFac, Transposed>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<(unsigned)nblocks, threads, smem, s>>>(md, x, out, tw, brp, fac, ns, lanes, stages,
                                                  cols);
}

using StagesLaunch8 = void (*)(const Mod<8>&, const uint32_t*, uint32_t*, const uint32_t*,
                               const int64_t*, const NttFactors&, int, int, int, int, long, int,
                               size_t, cudaStream_t);

// launch_stages<8, ...> indexed by the bits of (InFac, OutFac, Transposed): 4, 2, 1.
const StagesLaunch8 STAGES_LAUNCH8[8] = {
    launch_stages<8, false, false, false>, launch_stages<8, false, false, true>,
    launch_stages<8, false, true, false>,  launch_stages<8, false, true, true>,
    launch_stages<8, true, false, false>,  launch_stages<8, true, false, true>,
    launch_stages<8, true, true, false>,   launch_stages<8, true, true, true>};

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

// A pass: bit-reverse axis ns of x (batch, ns, lanes, nl) by brp (ns int64
// row indices), then DIT stages 0 .. stages - 1 (half-blocks 1 .. 2^(stages-1),
// stage u's twiddles at rows 2^u - 1 of tw), over tiles of 2^stages rows by
// cols lanes, into out (not x): (batch, ns, lanes, nl), or (batch, lanes, ns,
// nl) if transposed. in_fac and out_fac are null or (period, nl) tables of
// period 1 or ns * lanes: the load's factor by x's element, the store's by
// out's (ntt.cuh).
extern "C" int ctt_ntt_stages(int nl, const uint32_t* mod_words, const void* x, void* out,
                              const void* tw, const void* brp, const void* in_fac, int in_period,
                              const void* out_fac, int out_period, int transposed, int batch,
                              int ns, int lanes, int stages, int cols, void* stream) {
  if (batch <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if (ns < 2 || (ns & (ns - 1)) || stages < 1 || stages > 30 || (1 << stages) > ns ||
      cols < 1 || lanes % cols)
    return (int)cudaErrorInvalidValue;
  const long row = (long)ns * lanes;
  if ((in_fac && in_period != 1 && in_period != row) ||
      (out_fac && out_period != 1 && out_period != row))
    return (int)cudaErrorInvalidValue;
  const int S = 1 << stages;
  const size_t smem = (size_t)S * cols * (nl + 1) * sizeof(uint32_t);
  const long nblocks = (long)batch * (ns / S) * (lanes / cols);
  if (smem > STAGE_SMEM || (long)batch * ns * lanes * nl >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  const int threads = ntt_stage_threads(S, cols);
  const NttFactors fac{(const uint32_t*)in_fac, in_period, (const uint32_t*)out_fac,
                       out_period};
  const int variant = (in_fac ? 4 : 0) | (out_fac ? 2 : 0) | (transposed ? 1 : 0);
  switch (nl) {
    case 8:
      STAGES_LAUNCH8[variant](mod_from_words<8>(mod_words), (const uint32_t*)x, (uint32_t*)out,
                              (const uint32_t*)tw, (const int64_t*)brp, fac, ns, lanes, stages,
                              cols, nblocks, threads, smem, (cudaStream_t)stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
