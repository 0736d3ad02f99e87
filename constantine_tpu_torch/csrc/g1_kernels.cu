// K13 g1_decompress: G1 decompression with the subgroup check, a team of
// G1_TEAM threads per point, over g1.cuh.
//
// Replaces constantine_tpu/ops/pallas_g1.py:PallasG1._fn (ctt_g1_decompress),
// which runs the same sqrt, sign fix and Scott ladder on (L, TB) blocks with
// the exponent and ladder bits in SMEM; here they go by value in a struct
// (the square root's 4-bit digits precomputed on the host) and each team
// walks them.
//
// Layout: x Montgomery (N, 12) row-major, sign (N,) int32 -> y (N, 12)
// Montgomery, ok (N,) int32.
//
// Bound on an H100: the lane's dependent chain. The verify runs K13 on 2
// to 130 points, a few warps of the card, so a point's time is its chain of
// multiply latencies, far above the operations bound. One thread a point
// walked 1,680 dependent fe_mul (the square root's 378 squarings and 228
// multiplies bit by bit, the ladder's 127 doublings at 7 and 16 mixed
// additions at 11). Here a team of G1_TEAM threads in one warp owns a
// point (g1.cuh g1_decompress_team): the square root over the two-chain
// multiply fe_mul_eo by 4-bit windows (the 14-product table in 4 levels the
// members share, then 376 squarings and a product for each nonzero digit,
// computed by every member), and the ladder's products in levels of
// independent ones (ec.cuh ec_double_team: 2 rounds and 2 lone products a
// doubling; ec_madd_team: 5 rounds), handed between the members through
// shared memory. y's words are stored by the members in turn.
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace ctt;

namespace {

constexpr int G1_TEAM = 4;       // threads a point (PERF.md: chosen on the H100)
constexpr int G1_THREADS = 64;
constexpr int G1_LANES = G1_THREADS / G1_TEAM;
constexpr int G1_WORDS = 2 * G1_TEAM * FPN + 1;   // +1: teams start on different banks
constexpr int G1_TAB = 15 * FPN;                   // the window table, 16-byte aligned
static_assert(32 % G1_TEAM == 0, "a team lies within one warp");

__global__ void __launch_bounds__(G1_THREADS)
g1_decompress_kernel(G1DecompressConsts C, const uint32_t* __restrict__ xm,
                     const int32_t* __restrict__ sign, uint32_t* __restrict__ y,
                     int32_t* __restrict__ ok, int n) {
  const int team = threadIdx.x / G1_TEAM;
  const int i = blockIdx.x * G1_LANES + team;
  if (i >= n) return;  // a whole team
  __shared__ uint32_t slots[G1_LANES * G1_WORDS];
  __shared__ __align__(16) uint32_t tabs[G1_LANES * G1_TAB];
  const int rank = threadIdx.x % G1_TEAM;
  const unsigned mask = ((1u << G1_TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<FPN, G1_TEAM> tm{slots + team * G1_WORDS, mask, rank};
  Fp yi;
  const bool good = g1_decompress_team(tm, tabs + team * G1_TAB, fp_load(xm + (size_t)i * FPN),
                                       sign[i] != 0, yi, C);
  g1_store_team(tm, y + (size_t)i * FPN, ok + i, yi, good);
}

}  // namespace

// consts: the host layout of G1DecompressConsts (ops/cuda_g1.py packs it).
extern "C" int ctt_g1_decompress(const void* consts, const void* xm, const void* sign,
                                 void* y, void* ok, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const G1DecompressConsts C = *(const G1DecompressConsts*)consts;
  g1_decompress_kernel<<<(n + G1_LANES - 1) / G1_LANES, G1_THREADS, 0, (cudaStream_t)stream>>>(
      C, (const uint32_t*)xm, (const int32_t*)sign, (uint32_t*)y, (int32_t*)ok, n);
  return (int)cudaGetLastError();
}

extern "C" int ctt_g1_consts_size() { return (int)sizeof(G1DecompressConsts); }
