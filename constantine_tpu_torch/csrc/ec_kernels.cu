// K3-K7: the G1 point kernels, over BLS12-381 Fp (12 limbs).
//
// Replace constantine_tpu/ops/pallas_ec.py:
//   K3  PallasEC._elemwise -> add, double, double_k  (ctt_ec_add, ctt_ec_double_k),
//       and as ECGroup.scalar_mul drives them, a double, an add and a select
//       per scalar bit (constantine_tpu/ops/ec.py:260-282): ctt_ec_scalar_mul
//   K4  PallasEC.flush_scan   (ctt_flush_scan)
//   K5  PallasEC.merge_scan   (ctt_merge_scan)
//   K6  PallasEC.bucket_reduce (ctt_bucket_reduce)
//   K7  PallasEC.scaled_doubles (ctt_scaled_doubles)
// All inline the field and point code of ec.cuh (K2, the reference's _KF).
//
// Layout is the reference's planar one: a coordinate array is (L, n) with
// the lane axis contiguous, a stream is (K, L, M). Where thread m owns lane
// m, a warp reading limb l of entry k reads 128 contiguous bytes.
//
// Translation of the sequential grid: the TPU kernels walk K (or T) on the
// grid's minor axis and carry the accumulator in VMEM scratch between grid
// steps. GPU blocks run in no order, so here a thread (or a team of
// threads) keeps its accumulator in registers and loops over K itself.
//
// Bound on an H100: integer multiply issue -- a madd is 11 Montgomery
// multiplies (~3,300 products) and an add 16 (~4,800) against 72-144 bytes
// of input per step (chip_smoke.py `bound` counts the multiplies these
// inputs need). One thread a lane runs them as one dependent chain, far
// above that bound on the widths the paths use; six kernels shorten the
// chain with a team of threads a lane or a run (ec.cuh: a level's
// independent products side by side, over the two-chain multiply
// fe_mul_eo).
//
// K4 flush_scan replaces pallas_ec.py:616-764. The reference sweeps each of
// M = 512-1,024 lanes through K = 120-1,472 steps; one thread a lane kept 4-8
// of the 132 SMs busy with one warp per scheduler, a chain of 11 multiplies
// a step. Here a team of SM_TEAM threads walks a lane (ec.cuh flush_lane),
// each step a madd in 5 levels (ec_madd_team), the next entry loaded a step
// ahead, the step's 36 output words split among the members. The scan
// restarts at every change of key, so a lane is a chain per run of equal
// keys; but in the paths' streams the longest run is a whole lane (the top
// windows' zero digits take the gap key, and their few nonzero buckets hold
// hundreds of entries each), so splitting lanes into chunks of runs did not
// pay (PERF.md, scripts/torch_flush_scan_teams.py). K steps of one team
// (~6.6 us each on the H100, 5 multiply latencies and the linear work
// between them) set the time, far above the multiplies' operations bound
// (chip_smoke.py `bound`). The walk is the same whatever the keys: a
// restart is a select.
//
// K5 merge_scan replaces pallas_ec.py:766-851. The reference walks each of
// M2 = 128-1,152 lanes through K2 = 32 slots with an add and a select at
// every one; one thread a lane ran 32 dependent ec_adds (1.7-1.8 ms). But
// the merge stream's runs of equal keys are short (at most 27 slots in the
// paths' streams, mostly 1-3), its key <= 0 padding fills whole lanes, and
// an add with an operand at infinity is a select. Here a team of SM_TEAM
// threads owns the runs that start in a chunk of MS_CHUNK slots of a lane
// (ec.cuh merge_runs; MS_CHUNK = 1, a team a run, was the fastest on the
// H100; chunks of 2-4 slots up to 1.26x slower), carries each to its end, and
// computes ec_add_team (16 products in 5 rounds) only where both operands
// are finite under a key > 0; a restart or a skipped add is a select, so
// every slot keeps the sequential scan's limbs. The branches depend only on
// the keys and on which partial sums are infinity, uniform across a team
// (the reference is branch-free). A launch takes the longest run's chain
// of team adds (~7 us each), plus its wrapper's host cost.
//
// K6 bucket_reduce replaces pallas_ec.py:853-925, which walks T bucket
// steps on the grid with wsum += run; run += B[t] for all C lanes at each.
// Lane c's adds are a chain (T = 4-16 on the paths, over 512-2,816 lanes);
// one thread a lane ran its 2T ec_adds over fe_mul, 16 dependent products
// each (0.32 ms on the H100). But a step's two adds read only the old run,
// and an add with an operand at infinity (the first step's, an empty
// bucket's) is a select. Here two teams of SM_TEAM threads a lane run the
// step's two ec_add_teams side by side (ec.cuh bucket_lane), 5 rounds of
// products a step, the run handed from one team to the other through shared
// memory; the chain is the lane's T - 1 steps with an add, far above the
// multiplies' operations bound (chip_smoke.py `bound`).
//
// K3 add (ctt_ec_add) replaces PallasEC._elemwise's add (pallas_ec.py:
// 525-560): a team of SM_TEAM threads a lane runs ec_add_team, 16 products
// in 5 rounds, so a launch takes 5 multiply latencies instead of 16. At the
// paths' widths it stays latency-bound (0.009-0.015 ms a launch on the
// H100), and a call's time is the wrapper's host cost (0.03-0.06 ms).
//
// K3 double (ctt_ec_double_k) replaces _elemwise's double and double_k
// (pallas_ec.py:590, 599), which run every doubling as a pass over all
// lanes. Its callers are the fixed-base setup (a table layer is c = 12
// doublings of 4,096 points, one launch) and the MSM tail (k = 2-4 on 1-16
// lanes): a lane's k doublings are a chain. One thread a lane ran 7
// dependent products a doubling; here a team of SM_TEAM threads a lane runs
// ec_double_team (3 rounds over fe_mul_eo) k times with the point in
// registers (ec.cuh double_k_lane), so the bound that matters is 3k rounds
// of fe_mul_eo's latency, far above the bytes' bound.
//
// K7 scaled_doubles replaces pallas_ec.py:931-1011, which runs (W-1)*c grid
// steps over all W lanes and masks each step to the lanes that still owe a
// doubling. Lane w owes c*w doublings, each on the last one's result, so
// the longest lane's chain is the time: at the paths' (W, c) = (15, 9) and
// (11, 12), 126 and 120 doublings on W <= 16 lanes, one block. One thread a
// lane ran them over fe_mul, 7 dependent products a doubling (2.9 ms on the
// H100). Here a team of SM_TEAM threads a lane runs ec_double_team, 3
// levels of products over fe_mul_eo (3 rounds, the last one product that
// every member computes), so the bound that matters is the longest lane's
// 3*c*(W-1) dependent rounds, far above the multiplies' operations bound;
// the team cuts the chain from 7 products a doubling to 3 (0.42-0.45 ms on
// the H100, 1.27x those rounds at fe_mul_eo's latency).
//
// ec_scalar_mul walks every bit of [k]Q in one launch (the per-bit route
// took two launches and three selects a bit). FK20 calls it on 64-128
// lanes, where one thread a lane is two warps on one SM: a chain of 23
// dependent multiplies a bit, so its time is the chain's, far above the
// issue bound. The design shortens the chain: Q's Z^2 and Z^3 once a lane
// (21 products a bit), the bit's products in 7 levels of independent ones
// (ec.cuh ladder_step) computed side by side by a team of SM_TEAM threads
// a lane, and a Montgomery multiply over two independent carry chains
// (ec.cuh fe_mul_eo).
#include <cuda_runtime.h>

#include "ec.cuh"

using namespace ctt;

namespace {

constexpr int NL = 12;
using F = Fe<NL>;
using J = Jac<NL>;
using MD = Mod<NL>;

__device__ __forceinline__ F load(const uint32_t* __restrict__ base, int stride, int idx) {
  F r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = base[(size_t)l * stride + idx];
  return r;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, int stride, int idx,
                                      const F& v) {
#pragma unroll
  for (int l = 0; l < NL; ++l) base[(size_t)l * stride + idx] = v.v[l];
}

// ec_scalar_mul: [k]Q per lane, every bit in one launch (ec.cuh's
// ec_scalar_mul). A team of SM_TEAM threads in one warp owns a lane; each
// member holds the whole state, computes its share of a level's products
// and hands it to the others through shared memory.
constexpr int SM_TEAM = 4;       // threads a lane (PERF.md: chosen on the H100)
constexpr int SM_THREADS = 64;
constexpr int SM_LANES = SM_THREADS / SM_TEAM;
constexpr int SM_WORDS = 2 * SM_TEAM * NL + 1;   // +1: teams start on different banks
static_assert(32 % SM_TEAM == 0, "a team lies within one warp");

// k: (ls, n) canonical scalar limbs, lane axis contiguous.
__global__ void __launch_bounds__(SM_THREADS)
ec_scalar_mul_kernel(MD md, const uint32_t* __restrict__ k, const uint32_t* x,
                     const uint32_t* y, const uint32_t* z, uint32_t* ox, uint32_t* oy,
                     uint32_t* oz, int n, int nbits) {
  const int team = threadIdx.x / SM_TEAM;
  const int i = blockIdx.x * SM_LANES + team;
  if (i >= n) return;  // a whole team: SM_TEAM divides the warp
  const J Q{load(x, n, i), load(y, n, i), load(z, n, i)};
  __shared__ uint32_t slots[SM_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  const J R = ec_scalar_mul<NL>(tm, k + i, n, nbits, Q, md);
  if (rank == 0) {
    store(ox, n, i, R.X);
    store(oy, n, i, R.Y);
    store(oz, n, i, R.Z);
  }
}

// K3 add: a team of SM_TEAM threads a lane over ec_add_team, launched like
// ec_scalar_mul (16 lanes a block of 64 threads).
__global__ void __launch_bounds__(SM_THREADS)
ec_add_kernel(MD md, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
              const uint32_t* x2, const uint32_t* y2, const uint32_t* z2, uint32_t* x3,
              uint32_t* y3, uint32_t* z3, int n) {
  const int team = threadIdx.x / SM_TEAM;
  const int i = blockIdx.x * SM_LANES + team;
  if (i >= n) return;  // a whole team
  const J P{load(x1, n, i), load(y1, n, i), load(z1, n, i)};
  const J Q{load(x2, n, i), load(y2, n, i), load(z2, n, i)};
  __shared__ uint32_t slots[SM_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  store_split<NL>(tm, x3 + i, y3 + i, z3 + i, n, ec_add_team<NL>(tm, P, Q, md));
}

// K3 double: k doublings of lane i of (NL, n) in one launch (ec.cuh
// double_k_lane), a team of SM_TEAM threads a lane, launched like
// ec_scalar_mul (16 lanes a block of 64 threads).
__global__ void __launch_bounds__(SM_THREADS)
ec_double_k_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                   uint32_t* ox, uint32_t* oy, uint32_t* oz, int n, int k) {
  const int team = threadIdx.x / SM_TEAM;
  const int i = blockIdx.x * SM_LANES + team;
  if (i >= n) return;  // a whole team
  __shared__ uint32_t slots[SM_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  double_k_lane<NL>(tm, x, y, z, ox, oy, oz, n, k, i, md);
}

// K7, the online MSM's window combine: lane w of (NL, W) becomes
// 2^(c*w) * P_w (ec.cuh scaled_doubles_lane), a team of SM_TEAM threads a
// lane, launched like ec_scalar_mul (16 lanes a block of 64 threads).
__global__ void __launch_bounds__(SM_THREADS)
scaled_doubles_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                      uint32_t* ox, uint32_t* oy, uint32_t* oz, int W, int c) {
  const int team = threadIdx.x / SM_TEAM;
  const int w = blockIdx.x * SM_LANES + team;
  if (w >= W) return;  // a whole team
  __shared__ uint32_t slots[SM_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  scaled_doubles_lane<NL>(tm, x, y, z, ox, oy, oz, W, c, w, md);
}

// K6: buckets (T, NL, C) x 3 -> run, wsum (NL, C) x 3. Two teams of SM_TEAM
// threads a lane (ec.cuh bucket_lane), in one warp: role 0 carries wsum, role
// 1 run, each with its own product slots, and the pair meets at a __syncwarp
// over its 2 SM_TEAM threads to hand over the run.
constexpr int BR_PAIR = 2 * SM_TEAM;       // threads a lane
constexpr int BR_THREADS = 64;
constexpr int BR_LANES = BR_THREADS / BR_PAIR;
constexpr int BR_WORDS = 2 * SM_WORDS + 6 * NL;   // two teams' slots, two handed runs
static_assert(32 % BR_PAIR == 0, "a lane's teams lie within one warp");

__global__ void __launch_bounds__(BR_THREADS)
bucket_reduce_kernel(MD md, const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                     const uint32_t* __restrict__ bz, uint32_t* rx, uint32_t* ry, uint32_t* rz,
                     uint32_t* wx, uint32_t* wy, uint32_t* wz, int T, int C) {
  const int pair = threadIdx.x / BR_PAIR;
  const int c = blockIdx.x * BR_LANES + pair;
  if (c >= C) return;  // a whole lane: BR_PAIR divides the warp
  __shared__ uint32_t sm[BR_LANES * BR_WORDS];
  uint32_t* base = sm + pair * BR_WORDS;
  const int within = threadIdx.x % BR_PAIR;
  const int role = within / SM_TEAM, rank = within % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  const unsigned both = ((1u << BR_PAIR) - 1) << ((threadIdx.x & 31) - within);
  SmTeam<NL, SM_TEAM> tm{base + role * SM_WORDS, mask, rank};
  bucket_lane<NL>(tm, role, base + 2 * SM_WORDS, [both] { __syncwarp(both); }, bx, by, bz, rx,
                  ry, rz, wx, wy, wz, T, C, c, md);
}

// K4: keys (K, M); xy (K, 2*NL, M), rows 0..NL-1 the x limbs and NL..2NL-1
// the y limbs (the reference's packed stream); out (K, NL, M) x 3, slot
// (k, m) lane m's accumulator after entry k. Team m walks lane m (ec.cuh
// flush_lane): the teams of a warp hold neighbouring lanes, so their loads
// and stores of a limb share sectors.
constexpr int FS_THREADS = 128;
constexpr int FS_LANES = FS_THREADS / SM_TEAM;

__global__ void __launch_bounds__(FS_THREADS)
flush_scan_kernel(MD md, const int* __restrict__ keys, const uint32_t* __restrict__ xy,
                  uint32_t* __restrict__ ex, uint32_t* __restrict__ ey,
                  uint32_t* __restrict__ ez, int K, int M) {
  const int team = threadIdx.x / SM_TEAM;
  const int m = blockIdx.x * FS_LANES + team;
  if (m >= M) return;  // a whole team
  __shared__ uint32_t slots[FS_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  flush_lane<NL>(tm, keys, xy, ex, ey, ez, K, M, m, md);
}

// K5: keys (K, M); q and out (K, NL, M) x 3. A team of SM_TEAM threads
// owns the runs that start in a chunk of MS_CHUNK slots of a lane (ec.cuh
// merge_runs); team g holds lane g mod M, chunk g / M, so the teams of a
// warp hold neighbouring lanes at the same slots.
constexpr int MS_CHUNK = 1;      // slots a team starts runs in (PERF.md: chosen on the H100)
constexpr int MS_THREADS = 128;
constexpr int MS_LANES = MS_THREADS / SM_TEAM;

__global__ void __launch_bounds__(MS_THREADS)
merge_scan_kernel(MD md, const int* __restrict__ keys, const uint32_t* __restrict__ qx,
                  const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                  uint32_t* __restrict__ ex, uint32_t* __restrict__ ey,
                  uint32_t* __restrict__ ez, int K, int M, long long teams) {
  const int team = threadIdx.x / SM_TEAM;
  const long long g = (long long)blockIdx.x * MS_LANES + team;
  if (g >= teams) return;  // a whole team
  __shared__ uint32_t slots[MS_LANES * SM_WORDS];
  const int rank = threadIdx.x % SM_TEAM;
  const unsigned mask = ((1u << SM_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, SM_TEAM> tm{slots + team * SM_WORDS, mask, rank};
  const int m = (int)(g % M), k0 = (int)(g / M) * MS_CHUNK;
  merge_runs<NL>(tm, keys, qx, qy, qz, ex, ey, ez, K, M, m, k0, min(k0 + MS_CHUNK, K), md);
}

}  // namespace

extern "C" int ctt_ec_add(const uint32_t* mod_words, const void* x1, const void* y1,
                          const void* z1, const void* x2, const void* y2,
                          const void* z2, void* x3, void* y3, void* z3, int n,
                          void* stream) {
  if (n > 0)
    ec_add_kernel<<<(n + SM_LANES - 1) / SM_LANES, SM_THREADS, 0, (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const uint32_t*)x1, (const uint32_t*)y1,
        (const uint32_t*)z1, (const uint32_t*)x2, (const uint32_t*)y2,
        (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n);
  return (int)cudaGetLastError();
}

extern "C" int ctt_ec_double_k(const uint32_t* mod_words, const void* x, const void* y,
                               const void* z, void* ox, void* oy, void* oz, int n,
                               int k, void* stream) {
  if (n > 0)
    ec_double_k_kernel<<<(n + SM_LANES - 1) / SM_LANES, SM_THREADS, 0,
                         (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const uint32_t*)x, (const uint32_t*)y,
        (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, k);
  return (int)cudaGetLastError();
}

extern "C" int ctt_flush_scan(const uint32_t* mod_words, const void* keys,
                              const void* xy, void* ex, void* ey, void* ez, int K,
                              int M, void* stream) {
  if (M > 0 && K > 0)
    flush_scan_kernel<<<(M + FS_LANES - 1) / FS_LANES, FS_THREADS, 0, (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const int*)keys, (const uint32_t*)xy,
        (uint32_t*)ex, (uint32_t*)ey, (uint32_t*)ez, K, M);
  return (int)cudaGetLastError();
}

extern "C" int ctt_merge_scan(const uint32_t* mod_words, const void* keys,
                              const void* qx, const void* qy, const void* qz,
                              void* ex, void* ey, void* ez, int K, int M,
                              void* stream) {
  if (M > 0 && K > 0) {
    const long long teams = (long long)M * ((K + MS_CHUNK - 1) / MS_CHUNK);
    merge_scan_kernel<<<(unsigned)((teams + MS_LANES - 1) / MS_LANES), MS_THREADS, 0,
                        (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const int*)keys, (const uint32_t*)qx,
        (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ex, (uint32_t*)ey,
        (uint32_t*)ez, K, M, teams);
  }
  return (int)cudaGetLastError();
}

extern "C" int ctt_bucket_reduce(const uint32_t* mod_words, const void* bx,
                                 const void* by, const void* bz, void* rx, void* ry,
                                 void* rz, void* wx, void* wy, void* wz, int T, int C,
                                 void* stream) {
  if (C > 0 && T > 0)
    bucket_reduce_kernel<<<(C + BR_LANES - 1) / BR_LANES, BR_THREADS, 0, (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const uint32_t*)bx, (const uint32_t*)by,
        (const uint32_t*)bz, (uint32_t*)rx, (uint32_t*)ry, (uint32_t*)rz,
        (uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz, T, C);
  return (int)cudaGetLastError();
}

extern "C" int ctt_scaled_doubles(const uint32_t* mod_words, const void* x, const void* y,
                                  const void* z, void* ox, void* oy, void* oz, int W,
                                  int c, void* stream) {
  if (W > 0)
    scaled_doubles_kernel<<<(W + SM_LANES - 1) / SM_LANES, SM_THREADS, 0,
                            (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const uint32_t*)x, (const uint32_t*)y,
        (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, W, c);
  return (int)cudaGetLastError();
}

extern "C" int ctt_ec_scalar_mul(const uint32_t* mod_words, const void* k, const void* x,
                                 const void* y, const void* z, void* ox, void* oy, void* oz,
                                 int n, int nbits, void* stream) {
  if (n > 0)
    ec_scalar_mul_kernel<<<(n + SM_LANES - 1) / SM_LANES, SM_THREADS, 0,
                           (cudaStream_t)stream>>>(
        mod_from_words<NL>(mod_words), (const uint32_t*)k, (const uint32_t*)x,
        (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz, n, nbits);
  return (int)cudaGetLastError();
}
