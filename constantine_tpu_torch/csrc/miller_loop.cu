// K11 miller_loop: the BLS12-381 Miller loop, a team of TEAM threads a
// pair, over pairing.cuh's program. (K12 is final_exp.cu: one nvcc process
// each, built in parallel.)
//
// Replaces constantine_tpu/ops/pallas_pairing.py:_miller_fn
// (ctt_miller_loop). The TPU kernel puts the batch on the 128-wide lanes of
// (L, TB) blocks and walks the loop bits from SMEM; here the host unrolls
// the bits of |x| into one program (pairing.cuh miller_program) and a team
// runs its rounds: member m computes task m of a round (a sum or one Fp
// product over fe_mul_eo) from the lane's slot file in shared memory, and
// the team syncs.
//
// Layout: row-major, lane-major: P (B, 12) x 2 and Q (B, 2, 12) x 2 in,
// f (B, 12, 12) out; Montgomery form.
//
// Bound on an H100: one thread's chain of 8,053 dependent 12-limb
// multiplies was the time; the team's is its rounds with a product, each
// about one multiply's latency (a doubling iteration is an Fp12 squaring,
// the step and a sparse line product: 118 independent-enough products in
// 4-5 such rounds at TEAM = 32), plus the rounds of sums between them. At
// the verify's B = 2 two teams run on two SMs; at B = 256, 64 blocks of
// LANES teams.
#include <cuda_runtime.h>

#include "pairing.cuh"

using namespace ctt;

namespace {

constexpr int TEAM = 32;    // threads a pair (PERF.md: chosen on the H100)
constexpr int LANES = 4;    // pairs a block
static_assert(TEAM <= 32 ? 32 % TEAM == 0 : TEAM % 32 == 0 && LANES < 16,
              "a team divides a warp, or is whole warps with a named barrier each");
using Team = SmTeam<FPN, TEAM>;

// Words of one lane's slot file: +4 puts the lanes of a warp (TEAM < 32)
// on different banks and keeps 16-byte alignment.
__host__ __device__ inline int lane_words(int slots) { return slots * FPN + 4; }

__global__ void __launch_bounds__(TEAM * LANES)
miller_loop_kernel(PairingConsts C, ProgramRef P, const uint32_t* __restrict__ xp,
                   const uint32_t* __restrict__ yp, const uint32_t* __restrict__ xq,
                   const uint32_t* __restrict__ yq, uint32_t* __restrict__ out, int n) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x / TEAM;
  const int i = blockIdx.x * LANES + lane;
  if (i >= n) return;  // a whole team
  const int rank = threadIdx.x % TEAM;
  const unsigned mask =
      TEAM >= 32 ? 0xffffffffu : ((1u << (TEAM % 32)) - 1) << ((threadIdx.x & 31) - rank);
  Team tm{nullptr, mask, rank, 0, 1 + lane};
  uint32_t* s = reinterpret_cast<uint32_t*>(smem) + lane * lane_words(P.slots);
  load_lane(tm, s, C, MILLER_INPUTS, [&](int k) {
    const size_t f = (size_t)i * FPN;
    return k == 0 ? xp + f : k == 1 ? yp + f : k < 4 ? xq + 2 * f + (k - 2) * FPN
                                                     : yq + 2 * f + (k - 4) * FPN;
  });
  run_program(tm, P, s, C);
  store_lane(tm, P, s, out + (size_t)i * 12 * FPN);
}

int program(const PairingConsts& C, ProgramRef& P) {
  return device_program(C, [](const PairingConsts& c) { return miller_program(c, TEAM); }, P);
}

}  // namespace

// consts: the host layout of PairingConsts (ops/cuda_pairing.py packs it).
extern "C" int ctt_miller_loop(const void* consts, const void* xp, const void* yp,
                               const void* xq, const void* yq, void* out, int n,
                               void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const PairingConsts C = *(const PairingConsts*)consts;
  ProgramRef P;
  int rc = program(C, P);
  if (rc != 0) return rc;
  const int smem = LANES * lane_words(P.slots) * 4;
  rc = (int)cudaFuncSetAttribute(miller_loop_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  miller_loop_kernel<<<(n + LANES - 1) / LANES, TEAM * LANES, smem, (cudaStream_t)stream>>>(
      C, P, (const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)xq,
      (const uint32_t*)yq, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ctt_pairing_consts_size() { return (int)sizeof(PairingConsts); }

// The kernel's program: 7 ints as pairing.cuh's program_stats.
extern "C" int ctt_miller_loop_stats(const void* consts, int* out) {
  program_stats(miller_program(*(const PairingConsts*)consts, TEAM), out);
  return 0;
}
