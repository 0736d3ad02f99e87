// K12 final_exp: the BLS12-381 final exponentiation, a team of TEAM
// threads an Fp12, over pairing.cuh's program. (K11 is miller_loop.cu.)
//
// Replaces constantine_tpu/ops/pallas_pairing.py:_final_exp_fn
// (ctt_final_exp). The TPU kernel runs the hard part as a microcode
// interpreter over SMEM; here the host unrolls the whole exponentiation
// into one program (pairing.cuh final_exp_program) and a team runs its
// rounds from the lane's slot file in shared memory, as K11 does.
//
// Layout: row-major, lane-major: f (B, 12, 12) in and out; Montgomery
// form.
//
// Bound on an H100: one thread's chain of about 8,400 dependent 12-limb
// multiplies was the time; the team's is its rounds with a product (a
// cyclotomic squaring's 18 products are one, an Fp12 product's 54 two at
// TEAM = 32; five pow-x chains of 63 squarings and 5 products) plus the
// inverse over Fp, which no team shortens: 485 multiplies of one member
// (a fixed 4-bit window), while the others wait. multi_pairing runs it on
// one lane.
#include <cuda_runtime.h>

#include "pairing.cuh"

using namespace ctt;

namespace {

constexpr int TEAM = 32;    // threads an Fp12 (PERF.md: chosen on the H100)
constexpr int LANES = 4;    // Fp12 values a block
static_assert(TEAM <= 32 ? 32 % TEAM == 0 : TEAM % 32 == 0 && LANES < 16,
              "a team divides a warp, or is whole warps with a named barrier each");
using Team = SmTeam<FPN, TEAM>;

// Words of one lane's slot file: +4 puts the lanes of a warp (TEAM < 32)
// on different banks and keeps 16-byte alignment.
__host__ __device__ inline int lane_words(int slots) { return slots * FPN + 4; }

__global__ void __launch_bounds__(TEAM * LANES)
final_exp_kernel(PairingConsts C, ProgramRef P, const uint32_t* __restrict__ f,
                 uint32_t* __restrict__ out, int n) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x / TEAM;
  const int i = blockIdx.x * LANES + lane;
  if (i >= n) return;  // a whole team
  const int rank = threadIdx.x % TEAM;
  const unsigned mask =
      TEAM >= 32 ? 0xffffffffu : ((1u << (TEAM % 32)) - 1) << ((threadIdx.x & 31) - rank);
  Team tm{nullptr, mask, rank, 0, 1 + lane};
  uint32_t* s = reinterpret_cast<uint32_t*>(smem) + lane * lane_words(P.slots);
  load_lane(tm, s, C, FINAL_EXP_INPUTS, [&](int k) { return f + ((size_t)i * 12 + k) * FPN; });
  run_program(tm, P, s, C);
  store_lane(tm, P, s, out + (size_t)i * 12 * FPN);
}

int program(const PairingConsts& C, ProgramRef& P) {
  return device_program(C, [](const PairingConsts& c) { return final_exp_program(c, TEAM); },
                        P);
}

}  // namespace

// consts: the host layout of PairingConsts (ops/cuda_pairing.py packs it).
extern "C" int ctt_final_exp(const void* consts, const void* f, void* out, int n,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const PairingConsts C = *(const PairingConsts*)consts;
  ProgramRef P;
  int rc = program(C, P);
  if (rc != 0) return rc;
  const int smem = LANES * lane_words(P.slots) * 4;
  rc = (int)cudaFuncSetAttribute(final_exp_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  final_exp_kernel<<<(n + LANES - 1) / LANES, TEAM * LANES, smem, (cudaStream_t)stream>>>(
      C, P, (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// The kernel's program: 7 ints as pairing.cuh's program_stats.
extern "C" int ctt_final_exp_stats(const void* consts, int* out) {
  program_stats(final_exp_program(*(const PairingConsts*)consts, TEAM), out);
  return 0;
}
