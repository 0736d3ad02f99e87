// The BLS12-381 optimal-ate pairing for a team of threads a lane: the Miller
// loop (K11) and the final exponentiation (K12) as programs (program.cuh)
// built from the tower formulas (tower.cuh).
//
// Replaces the kernel bodies of constantine_tpu/ops/pallas_pairing.py:
// _miller_fn (the fused double/add steps and sparse line products,
// _dbl_step/_add_step/_emit_line/f12sparse_line) and _final_exp_fn (easy
// part with the Fp12 inverse through the norms and an inverse over Fp, then
// the hard part). The TPU runs the hard part as a microcode interpreter over
// a host-built program (_build_hard_program); here both kernels are: the
// host unrolls the loops over the public bits of |x| into one program each,
// computing the same (x-1)^2 (x+p) (x^2+p^2-1) + 3 decomposition. G2 is in
// homogeneous projective coordinates on the M-twist; lines are scaled as in
// the reference, so the Miller value is limb-identical to the plain version
// in ops/cuda_pairing.py (it is not canonical: other line scalings give
// values that differ by factors the final exponentiation kills).
//
// A lane's slot file holds the constants (slots 0..NCONST-1: the Montgomery
// one, then gamma1[1..5] and gamma2[1..5], c0 and c1 each), then the inputs
// (K11: xP, yP, xQ.c0, xQ.c1, yQ.c0, yQ.c1; K12: the 12 coefficients of f),
// then the program's values.
#pragma once

#include "tower.cuh"

#if defined(__CUDACC__)
#include <cstring>
#include <map>
#include <mutex>
#endif

namespace ctt {

struct Fp2 {
  Fp c0, c1;
};

// Constants of the pairing, passed to the kernels by value.
struct PairingConsts {
  MdP md;
  Fp2 gamma1[6];   // Frobenius p: xi^(j (p-1)/6), coefficient order
  Fp2 gamma2[6];   // Frobenius p^2
  FpExp pm2;       // p - 2 (the inverse over Fp)
  uint32_t x_lo, x_hi;  // |x|
  int x_bits;      // bit length of |x|
  int x_neg;       // x < 0: conjugate the Miller value and each pow-x
};

constexpr int NCONST = 21;
constexpr int MILLER_INPUTS = 6;
constexpr int FINAL_EXP_INPUTS = 12;

// The value of constant slot k < NCONST.
CTT_HD Fp const_slot(const PairingConsts& C, int k) {
  if (k == 0) return fe_one<FPN>(C.md);
  const Fp2& g = k <= 10 ? C.gamma1[1 + (k - 1) / 2] : C.gamma2[1 + (k - 11) / 2];
  return ((k - 1) & 1) ? g.c1 : g.c0;
}

// A builder with the constants as nodes: zero and the Montgomery one fold.
struct PairingBuild {
  Builder b;
  SymTower t{b};
  S2 gamma1[6], gamma2[6];

  explicit PairingBuild(const PairingConsts& C) {
    b.input_one(0);
    const Fp one = fe_one<FPN>(C.md);
    auto node = [&](int k) {
      const Fp v = const_slot(C, k);
      return fe_is_zero<FPN>(v) ? b.zero() : fp_eq(v, one) ? b.one : b.input(k);
    };
    gamma1[0] = gamma2[0] = t.f2one();
    for (int j = 1; j < 6; ++j) {
      gamma1[j] = {node(2 * j - 1), node(2 * j)};
      gamma2[j] = {node(2 * j + 9), node(2 * j + 10)};
    }
  }

  S12 input12(int first) {
    S12 f;
    for (int k = 0; k < 12; ++k) s12at(f, k) = b.input(first + k);
    return f;
  }

  static std::vector<int> outputs(S12 f) {
    std::vector<int> o;
    for (int k = 0; k < 12; ++k) o.push_back(s12at(f, k));
    return o;
  }

  // Projective doubling of T and its tangent line (lA, lC, lB) at P, the
  // formulas of the reference's _dbl_step with sA = 2YZ^2, sB = -3X^2 Z,
  // sC = 3X^3 - 2Y^2 Z, lA = yP xi sA, lB = xP sB, lC = sC. Regrouped for
  // fewer levels: 3 b' Z^2 = 12 xi Z^2 (b' = 4 xi) is a sum, and
  // yP (H Z) = H (yP Z), xP (X^2 Z) = X^2 (xP Z).
  void dbl_step(S2& X, S2& Y, S2& Z, int xP, int yP, S2& lA, S2& lC, S2& lB) {
    const S2 B = t.f2sq(Y);
    const S2 C = t.f2sq(Z);
    const S2 E = t.f2scale(t.f2xi(C), 12);                            // 3 b' Z^2
    const S2 F3 = t.f2scale(E, 3);
    const S2 A = t.f2half(t.f2mul(X, Y));                             // XY/2
    const S2 G = t.f2half(t.f2add(B, F3));                            // (B + 3E)/2
    const S2 H = t.f2sub(t.f2sub(t.f2sq(t.f2add(Y, Z)), B), C);       // 2YZ
    const S2 XX3 = t.f2scale(t.f2sq(X), 3);
    lA = t.f2xi(t.f2mul(H, t.f2mul_fp(Z, yP)));
    lC = t.f2sub(t.f2mul(XX3, X), t.f2mul(t.f2scale(B, 2), Z));
    lB = t.f2neg(t.f2mul(XX3, t.f2mul_fp(Z, xP)));
    const S2 X3 = t.f2mul(A, t.f2sub(B, F3));
    const S2 Y3 = t.f2sub(t.f2sq(G), t.f2scale(t.f2sq(E), 3));
    Z = t.f2mul(B, H);
    X = X3;
    Y = Y3;
  }

  // Mixed addition T + Q (Q affine) and the chord line: theta = Y - yQ Z,
  // lam = X - xQ Z; sA = lam, sB = -theta, sC = theta xQ - lam yQ.
  void add_step(S2& X, S2& Y, S2& Z, const S2& xQ, const S2& yQ, int xP, int yP, S2& lA,
                S2& lC, S2& lB) {
    const S2 theta = t.f2sub(Y, t.f2mul(yQ, Z));
    const S2 lam = t.f2sub(X, t.f2mul(xQ, Z));
    const S2 t2 = t.f2sq(theta);
    const S2 l2 = t.f2sq(lam);
    const S2 l3c = t.f2mul(l2, lam);
    const S2 l2X = t.f2mul(l2, X);
    const S2 H = t.f2add(t.f2sub(t.f2mul(t2, Z), t.f2scale(l2X, 2)), l3c);
    const S2 X3 = t.f2mul(lam, H);
    const S2 Y3 = t.f2sub(t.f2mul(theta, t.f2sub(l2X, H)), t.f2mul(Y, l3c));
    Z = t.f2mul(l3c, Z);
    X = X3;
    Y = Y3;
    lA = t.f2mul_fp(t.f2xi(lam), yP);
    lC = t.f2sub(t.f2mul(theta, xQ), t.f2mul(lam, yQ));
    lB = t.f2mul_fp(t.f2neg(theta), xP);
  }

  // f^x in the cyclotomic subgroup: cyclotomic squarings over the bits of
  // |x| after the leading one, conjugated for x < 0.
  S12 pow_x(const S12& f, const PairingConsts& C) {
    const uint64_t x = ((uint64_t)C.x_hi << 32) | C.x_lo;
    S12 acc = f;
    for (int i = C.x_bits - 2; i >= 0; --i) {
      acc = t.f12cyc_sq(acc);
      if ((x >> i) & 1u) acc = t.f12mul(acc, f);
    }
    return C.x_neg ? t.f12conj(acc) : acc;
  }
};

// K11: f_{|x|,Q}(P), conjugated for x < 0: one doubling step and line per
// bit of |x| after the leading one, an addition step and line where the bit
// is set.
inline Program miller_program(const PairingConsts& C, int T) {
  PairingBuild pb(C);
  Builder& b = pb.b;
  SymTower& t = pb.t;
  const int xP = b.input(NCONST), yP = b.input(NCONST + 1);
  const S2 xQ{b.input(NCONST + 2), b.input(NCONST + 3)};
  const S2 yQ{b.input(NCONST + 4), b.input(NCONST + 5)};
  const uint64_t x = ((uint64_t)C.x_hi << 32) | C.x_lo;
  S12 f = t.f12one();
  S2 X = xQ, Y = yQ, Z = t.f2one(), lA, lC, lB;
  for (int i = C.x_bits - 2; i >= 0; --i) {
    f = t.f12sq(f);
    pb.dbl_step(X, Y, Z, xP, yP, lA, lC, lB);
    f = t.f12sparse_line(f, lA, lC, lB);
    if ((x >> i) & 1u) {
      pb.add_step(X, Y, Z, xQ, yQ, xP, yP, lA, lC, lB);
      f = t.f12sparse_line(f, lA, lC, lB);
    }
  }
  if (C.x_neg) f = t.f12conj(f);
  return compile(b, PairingBuild::outputs(f), T, NCONST + MILLER_INPUTS, C.pm2);
}

// K12: f^(3 (p^12 - 1)/r): the easy part f^((p^6 - 1)(p^2 + 1)), then the
// hard part as (x-1)^2 (x+p) (x^2+p^2-1) + 3 (asserted in ops/pairing.py).
inline Program final_exp_program(const PairingConsts& C, int T) {
  PairingBuild pb(C);
  SymTower& t = pb.t;
  const S12 f = pb.input12(NCONST);
  S12 g = t.f12mul(t.f12conj(f), t.f12inv(f));                          // f^(p^6 - 1)
  g = t.f12mul(t.f12frob(g, pb.gamma2, false), g);                      // ^(p^2 + 1)
  S12 t1 = t.f12mul(pb.pow_x(g, C), t.f12conj(g));                      // g^(x-1)
  t1 = t.f12mul(pb.pow_x(t1, C), t.f12conj(t1));                        // g^((x-1)^2)
  const S12 t2 = t.f12mul(pb.pow_x(t1, C), t.f12frob(t1, pb.gamma1, true));  // ^(x+p)
  S12 acc = pb.pow_x(pb.pow_x(t2, C), C);                               // t2^(x^2)
  acc = t.f12mul(acc, t.f12frob(t2, pb.gamma2, false));                 // * t2^(p^2)
  acc = t.f12mul(acc, t.f12conj(t2));                                   // / t2
  acc = t.f12mul(acc, t.f12cyc_sq(g));                                  // * g^2
  acc = t.f12mul(acc, g);                                               // * g
  return compile(pb.b, PairingBuild::outputs(acc), T, NCONST + FINAL_EXP_INPUTS, C.pm2);
}

// What a program costs, for the launch's callers: T, rounds, rounds with a
// product (the INV's round not among them), the INV's lone multiplies,
// product tasks, sum tasks, slots.
inline void program_stats(const Program& P, int* out) {
  const int v[7] = {P.T, P.rounds, P.mul_rounds, P.inv_muls, P.muls, P.sums, P.slots};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

#if defined(__CUDACC__)

// What a kernel needs of a program: its tasks on the card and the slot of
// each output.
struct ProgramRef {
  const Task* tasks;
  int rounds;
  int slots;
  uint16_t out[12];
};

// Load the constants and a lane's n_in inputs (input k at in(k)) into its
// slot file.
template <class Team, class In>
__device__ __forceinline__ void load_lane(Team& tm, uint32_t* s, const PairingConsts& C,
                                          int n_in, In in) {
  for (int k = tm.rank; k < NCONST + n_in; k += Team::T)
    slot_store(s, k, k < NCONST ? const_slot(C, k) : fp_load(in(k - NCONST)));
  tm.sync();
}

// Rounds whose tasks a member holds in registers ahead of the one it runs.
constexpr int AHEAD = 1;

// Run the program's rounds: member m runs task m of each round, then the
// team syncs.
template <class Team>
__device__ __forceinline__ void run_program(Team& tm, const ProgramRef& P, uint32_t* s,
                                            const PairingConsts& C) {
  const double inv_p = p_top_inv(C.md);
  const uint4* tasks = reinterpret_cast<const uint4*>(P.tasks) + TASK_VECS * tm.rank;
  const size_t stride = (size_t)TASK_VECS * Team::T;
  uint4 q[AHEAD][TASK_VECS];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a)
#pragma unroll
    for (int j = 0; j < TASK_VECS; ++j)
      q[a][j] = a < P.rounds ? __ldg(tasks + a * stride + j) : make_uint4(0, 0, 0, 0);
  for (int r = 0; r < P.rounds; ++r) {
    Task t;
    memcpy(&t, q[0], sizeof t);
#pragma unroll
    for (int a = 0; a + 1 < AHEAD; ++a)
#pragma unroll
      for (int j = 0; j < TASK_VECS; ++j) q[a][j] = q[a + 1][j];
    if (r + AHEAD < P.rounds)
#pragma unroll
      for (int j = 0; j < TASK_VECS; ++j) q[AHEAD - 1][j] = __ldg(tasks + (r + AHEAD) * stride + j);
    exec_task(t, s, C.md, C.pm2, inv_p);
    tm.sync();
  }
}

// Member m stores outputs m, m + T, ... of the lane (12 Fp at out).
template <class Team>
__device__ __forceinline__ void store_lane(Team& tm, const ProgramRef& P, const uint32_t* s,
                                           uint32_t* out) {
  for (int k = tm.rank; k < 12; k += Team::T) fp_store(out + k * FPN, slot_load(s, P.out[k]));
}

// The program of a kernel on the current device, built on the host and
// copied to the card at its first launch there (once a process).
template <class Make>
inline int device_program(const PairingConsts& C, Make make, ProgramRef& ref) {
  struct Entry {
    PairingConsts consts;
    ProgramRef ref;
  };
  static std::mutex mu;
  static std::map<int, Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it != cache.end() && memcmp(&it->second.consts, &C, sizeof C) == 0) {
    ref = it->second.ref;
    return 0;
  }
  const Program P = make(C);
  void* d = nullptr;
  const size_t bytes = P.tasks.size() * sizeof(Task);
  if ((err = cudaMalloc(&d, bytes)) != cudaSuccess) return (int)err;
  if ((err = cudaMemcpy(d, P.tasks.data(), bytes, cudaMemcpyHostToDevice)) != cudaSuccess) {
    cudaFree(d);
    return (int)err;
  }
  ref.tasks = (const Task*)d;
  ref.rounds = P.rounds;
  ref.slots = P.slots;
  for (int k = 0; k < 12; ++k) ref.out[k] = P.out[k];
  cache[dev] = Entry{C, ref};
  return 0;
}

#endif  // __CUDACC__

}  // namespace ctt
