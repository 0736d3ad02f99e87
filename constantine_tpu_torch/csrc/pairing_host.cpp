// Host build of program.cuh, tower.cuh, pairing.cuh and g1.cuh for the
// tests: the programs of K11 and K12 (and of single Fp12 operations) run by
// one thread that plays every member of the team in turn, and K13's lane,
// behind a plain C interface, so they can be held against the port's plain
// PyTorch versions on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libpairing_host.so pairing_host.cpp
//
// Arrays are row-major u32 limbs in Montgomery form: Fp (n, 12), Fp2
// (n, 2, 12), Fp12 (n, 12, 12). consts is the kernels' constants struct as
// ops/cuda_pairing.py and ops/cuda_g1.py pack it. T is the team size the
// program is scheduled for (the kernels' is a constant of miller_loop.cu and
// final_exp.cu); reverse plays the members of each round from the last to
// the first, which changes the result if two tasks of a round touch one slot.
// K13's team lane runs with a team of one, or with a thread for each member
// of a team of T, the members meeting at a barrier where the card's meet at
// __syncwarp; so do ec.cuh's team doubling and K7's lane (scaled_doubles),
// on (n, 12) rows and on K7's planar (12, W) columns, mod_words as in
// ec_host.cpp.
#include <cstddef>
#include <vector>

#include "g1.cuh"
#include "host_team.h"
#include "pairing.cuh"

using namespace ctt;

namespace {
constexpr int W12 = 12 * FPN;

// One Fp12 operation on inputs a (12 Fp) and b (12 Fp, the sparse line's
// lA, lC, lB in its first three Fp2 coefficients): 0 mul, 1 square,
// 2 cyclotomic square, 3 conj, 4 Frobenius p, 5 Frobenius p^2, 6 inverse,
// 7 sparse line product.
Program fp12_op_program(const PairingConsts& C, int op, int T) {
  PairingBuild pb(C);
  SymTower& t = pb.t;
  const S12 a = pb.input12(NCONST), y = pb.input12(NCONST + 12);
  S12 r;
  switch (op) {
    case 0: r = t.f12mul(a, y); break;
    case 1: r = t.f12sq(a); break;
    case 2: r = t.f12cyc_sq(a); break;
    case 3: r = t.f12conj(a); break;
    case 4: r = t.f12frob(a, pb.gamma1, true); break;
    case 5: r = t.f12frob(a, pb.gamma2, false); break;
    case 6: r = t.f12inv(a); break;
    default: r = t.f12sparse_line(a, y.c0.c0, y.c0.c1, y.c0.c2); break;
  }
  return compile(pb.b, PairingBuild::outputs(r), T, NCONST + 24, C.pm2);
}

// One lane: load the constants and inputs (input k at in(k)), run the
// rounds, store the 12 outputs.
template <class In>
void run_lane(const Program& P, const PairingConsts& C, int n_in, In in, bool reverse,
              uint32_t* out) {
  std::vector<uint32_t> s((size_t)P.slots * FPN, 0);
  for (int k = 0; k < NCONST + n_in; ++k)
    slot_store(s.data(), k, k < NCONST ? const_slot(C, k) : fp_load(in(k - NCONST)));
  const double inv_p = p_top_inv(C.md);
  for (int r = 0; r < P.rounds; ++r)
    for (int i = 0; i < P.T; ++i) {
      const int m = reverse ? P.T - 1 - i : i;
      exec_task(P.tasks[(size_t)r * P.T + m], s.data(), C.md, C.pm2, inv_p);
    }
  for (int k = 0; k < 12; ++k) fp_store(out + k * FPN, slot_load(s.data(), P.out[k]));
}

void miller(const PairingConsts& C, int T, bool reverse, const uint32_t* xp, const uint32_t* yp,
            const uint32_t* xq, const uint32_t* yq, uint32_t* out, int n) {
  const Program P = miller_program(C, T);
  for (int i = 0; i < n; ++i) {
    const uint32_t* in[MILLER_INPUTS] = {xp + (size_t)i * FPN, yp + (size_t)i * FPN,
                                         xq + (size_t)i * 2 * FPN, xq + (size_t)i * 2 * FPN + FPN,
                                         yq + (size_t)i * 2 * FPN, yq + (size_t)i * 2 * FPN + FPN};
    run_lane(P, C, MILLER_INPUTS, [&](int k) { return in[k]; }, reverse, out + (size_t)i * W12);
  }
}

// K13's team lane on lanes [0, n): a team of one, or kT threads a lane.
template <int kT>
void g1_team_lanes(const G1DecompressConsts& C, const uint32_t* xm, const int32_t* sign,
                   uint32_t* y, int32_t* ok, int n) {
  std::vector<uint32_t> tab(15 * FPN);
  for (int i = 0; i < n; ++i)
    play_team<FPN, kT>([&](auto& tm) {
      Fp yi;
      const bool good =
          g1_decompress_team(tm, tab.data(), fp_load(xm + (size_t)i * FPN), sign[i] != 0, yi, C);
      g1_store_team(tm, y + (size_t)i * FPN, ok + i, yi, good);
    });
}

// ec_double_team on rows [0, n), each member storing its share.
template <int kT>
void double_team_rows(const MdP& M, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                      uint32_t* ox, uint32_t* oy, uint32_t* oz, int n) {
  for (int i = 0; i < n; ++i) {
    const size_t o = (size_t)i * FPN;
    play_team<FPN, kT>([&](auto& tm) {
      const Jac<FPN> R = ec_double_team<FPN>(tm, Jac<FPN>{fp_load(x + o), fp_load(y + o),
                                                          fp_load(z + o)}, M);
      store_split<FPN>(tm, ox + o, oy + o, oz + o, 1, R);
    });
  }
}

// K7's lanes (scaled_doubles_lane) one team after the other, in order or
// reversed.
template <int kT>
void scaled_doubles_teams(const MdP& M, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                          uint32_t* ox, uint32_t* oy, uint32_t* oz, int W, int c, bool reverse) {
  for (int t = 0; t < W; ++t) {
    const int w = reverse ? W - 1 - t : t;
    play_team<FPN, kT>([&](auto& tm) {
      scaled_doubles_lane<FPN>(tm, x, y, z, ox, oy, oz, W, c, w, M);
    });
  }
}

void final_exp(const PairingConsts& C, int T, bool reverse, const uint32_t* f, uint32_t* out,
               int n) {
  const Program P = final_exp_program(C, T);
  for (int i = 0; i < n; ++i)
    run_lane(P, C, FINAL_EXP_INPUTS, [&](int k) { return f + (size_t)i * W12 + k * FPN; },
             reverse, out + (size_t)i * W12);
}
}  // namespace

extern "C" int ctt_host_pairing_consts_size() { return (int)sizeof(PairingConsts); }
extern "C" int ctt_host_g1_consts_size() { return (int)sizeof(G1DecompressConsts); }

// op: 0 mul, 1 square, 2 cyclotomic square, 3 conj, 4 Frobenius p,
// 5 Frobenius p^2, 6 inverse, 7 sparse line (b holds lA, lC, lB in its
// first three Fp2 coefficients); a team of one
extern "C" void ctt_host_fp12_op(const void* consts, int op, const uint32_t* a,
                                 const uint32_t* b, uint32_t* out, int n) {
  const PairingConsts& C = *(const PairingConsts*)consts;
  const Program P = fp12_op_program(C, op, 1);
  for (int i = 0; i < n; ++i)
    run_lane(P, C, 24, [&](int k) {
      return k < 12 ? a + (size_t)i * W12 + k * FPN : b + (size_t)i * W12 + (k - 12) * FPN;
    }, false, out + (size_t)i * W12);
}

// K11's and K12's programs for a team of one.
extern "C" void ctt_host_miller_loop(const void* consts, const uint32_t* xp,
                                     const uint32_t* yp, const uint32_t* xq,
                                     const uint32_t* yq, uint32_t* out, int n) {
  miller(*(const PairingConsts*)consts, 1, false, xp, yp, xq, yq, out, n);
}

extern "C" void ctt_host_final_exp(const void* consts, const uint32_t* f, uint32_t* out,
                                   int n) {
  final_exp(*(const PairingConsts*)consts, 1, false, f, out, n);
}

// The same for a team of T, members played in order or reversed.
extern "C" void ctt_host_miller_loop_team(const void* consts, int T, int reverse,
                                          const uint32_t* xp, const uint32_t* yp,
                                          const uint32_t* xq, const uint32_t* yq, uint32_t* out,
                                          int n) {
  miller(*(const PairingConsts*)consts, T, reverse != 0, xp, yp, xq, yq, out, n);
}

extern "C" void ctt_host_final_exp_team(const void* consts, int T, int reverse,
                                        const uint32_t* f, uint32_t* out, int n) {
  final_exp(*(const PairingConsts*)consts, T, reverse != 0, f, out, n);
}

// which: 0 K11, 1 K12; out: 7 ints as pairing.cuh's program_stats.
extern "C" void ctt_host_program_stats(const void* consts, int which, int T, int* out) {
  const PairingConsts& C = *(const PairingConsts*)consts;
  program_stats(which == 0 ? miller_program(C, T) : final_exp_program(C, T), out);
}

extern "C" void ctt_host_g1_decompress(const void* consts, const uint32_t* xm,
                                       const int32_t* sign, uint32_t* y, int32_t* ok, int n) {
  const G1DecompressConsts& C = *(const G1DecompressConsts*)consts;
  for (int i = 0; i < n; ++i) {
    Fp yi;
    ok[i] = g1_decompress_lane(fp_load(xm + (size_t)i * FPN), sign[i] != 0, yi, C) ? 1 : 0;
    fp_store(y + (size_t)i * FPN, yi);
  }
}

// K13's team lane (g1.cuh g1_decompress_team) with a team of T = 1, or of
// T = 2 or 4 threads a lane, each storing its share of the outputs.
// Returns -1 for another T.
extern "C" int ctt_host_g1_decompress_team(const void* consts, int T, const uint32_t* xm,
                                           const int32_t* sign, uint32_t* y, int32_t* ok,
                                           int n) {
  const G1DecompressConsts& C = *(const G1DecompressConsts*)consts;
  switch (T) {
    case 1: g1_team_lanes<1>(C, xm, sign, y, ok, n); return 0;
    case 2: g1_team_lanes<2>(C, xm, sign, y, ok, n); return 0;
    case 4: g1_team_lanes<4>(C, xm, sign, y, ok, n); return 0;
    default: return -1;
  }
}

// ec.cuh's ec_double_team with a team of T = 1, 2 or 4 (a thread a member):
// rows (n, 12). Returns -1 for another T.
extern "C" int ctt_host_ec_double_team(const uint32_t* mod_words, int T, const uint32_t* x,
                                       const uint32_t* y, const uint32_t* z, uint32_t* ox,
                                       uint32_t* oy, uint32_t* oz, int n) {
  const MdP M = mod_from_words<FPN>(mod_words);
  switch (T) {
    case 1: double_team_rows<1>(M, x, y, z, ox, oy, oz, n); return 0;
    case 2: double_team_rows<2>(M, x, y, z, ox, oy, oz, n); return 0;
    case 4: double_team_rows<4>(M, x, y, z, ox, oy, oz, n); return 0;
    default: return -1;
  }
}

// K7 (ec.cuh scaled_doubles_lane): lane w of the planar (12, W) columns
// becomes 2^(c w) P_w, a team of T = 1, 2 or 4 a lane, the lanes in order or
// reversed. Returns -1 for another T.
extern "C" int ctt_host_scaled_doubles_team(const uint32_t* mod_words, int T, int reverse,
                                            const uint32_t* x, const uint32_t* y,
                                            const uint32_t* z, uint32_t* ox, uint32_t* oy,
                                            uint32_t* oz, int W, int c) {
  const MdP M = mod_from_words<FPN>(mod_words);
  switch (T) {
    case 1: scaled_doubles_teams<1>(M, x, y, z, ox, oy, oz, W, c, reverse != 0); return 0;
    case 2: scaled_doubles_teams<2>(M, x, y, z, ox, oy, oz, W, c, reverse != 0); return 0;
    case 4: scaled_doubles_teams<4>(M, x, y, z, ox, oy, oz, W, c, reverse != 0); return 0;
    default: return -1;
  }
}
