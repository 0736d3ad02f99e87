// Host build of ec.cuh for the tests: the header's portable arithmetic
// behind a plain C interface, so it can be held against the port's plain
// PyTorch versions on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -pthread -o libec_host.so ec_host.cpp
//
// Arrays are row-major (n, 12) u32 limbs in Montgomery form; mod_words is
// p[12], m0, one[12] as in ec.cuh. The flush scan's entries take the
// kernel's planar stream instead: keys (K, M), xy (K, 24, M), out (K, 12, M);
// the merge scan's, keys (K, M) and q, out (K, 12, M) x 3; bucket_reduce's,
// buckets (T, 12, C) and run, wsum (12, C) x 3; double_k's, planar (12, n)
// columns. The inverse (inv.cuh) takes rows of 8 or 12 limbs. The lanes of
// bucket_reduce and double_k run a thread for each member of their teams
// (host_team.h): build with -pthread.
#include <vector>

#include "ec.cuh"
#include "host_team.h"
#include "inv.cuh"

using namespace ctt;

namespace {
constexpr int NL = 12;
using F = Fe<NL>;
using J = Jac<NL>;

F row(const uint32_t* a, int i) {
  F r;
  for (int l = 0; l < NL; ++l) r.v[l] = a[i * NL + l];
  return r;
}

void put(uint32_t* a, int i, const F& v) {
  for (int l = 0; l < NL; ++l) a[i * NL + l] = v.v[l];
}
}  // namespace

extern "C" void ctt_host_fp_mul(const uint32_t* mod_words, const uint32_t* a,
                                const uint32_t* b, uint32_t* out, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) put(out, i, fe_mul<NL>(row(a, i), row(b, i), md));
}

extern "C" void ctt_host_fp_mul_eo(const uint32_t* mod_words, const uint32_t* a,
                                   const uint32_t* b, uint32_t* out, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) put(out, i, fe_mul_eo<NL>(row(a, i), row(b, i), md));
}

extern "C" void ctt_host_ec_add(const uint32_t* mod_words, const uint32_t* x1,
                                const uint32_t* y1, const uint32_t* z1,
                                const uint32_t* x2, const uint32_t* y2,
                                const uint32_t* z2, uint32_t* x3, uint32_t* y3,
                                uint32_t* z3, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    const J R = ec_add<NL>(J{row(x1, i), row(y1, i), row(z1, i)},
                           J{row(x2, i), row(y2, i), row(z2, i)}, md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

extern "C" void ctt_host_ec_madd(const uint32_t* mod_words, const uint32_t* x1,
                                 const uint32_t* y1, const uint32_t* z1,
                                 const uint32_t* x2, const uint32_t* y2, uint32_t* x3,
                                 uint32_t* y3, uint32_t* z3, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    const J R = ec_madd<NL>(J{row(x1, i), row(y1, i), row(z1, i)}, row(x2, i),
                            row(y2, i), md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

extern "C" void ctt_host_ec_double(const uint32_t* mod_words, const uint32_t* x,
                                   const uint32_t* y, const uint32_t* z, uint32_t* x3,
                                   uint32_t* y3, uint32_t* z3, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    const J R = ec_double<NL>(J{row(x, i), row(y, i), row(z, i)}, md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

// ec_scalar_mul's ladder as a team of one: k is row-major (n, ls) u32
// canonical limbs, the points (n, 12) as above.
extern "C" void ctt_host_ec_scalar_mul(const uint32_t* mod_words, const uint32_t* k, int ls,
                                       const uint32_t* x, const uint32_t* y,
                                       const uint32_t* z, uint32_t* x3, uint32_t* y3,
                                       uint32_t* z3, int n, int nbits) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    Solo<NL> tm;
    const J R = ec_scalar_mul<NL>(tm, k + (size_t)i * ls, 1, nbits,
                                  J{row(x, i), row(y, i), row(z, i)}, md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

// ec_add_team and ec_madd_team (K3 add's and K4's levels) as a team of one.
extern "C" void ctt_host_ec_add_team(const uint32_t* mod_words, const uint32_t* x1,
                                     const uint32_t* y1, const uint32_t* z1,
                                     const uint32_t* x2, const uint32_t* y2,
                                     const uint32_t* z2, uint32_t* x3, uint32_t* y3,
                                     uint32_t* z3, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    Solo<NL> tm;
    const J R = ec_add_team<NL>(tm, J{row(x1, i), row(y1, i), row(z1, i)},
                                J{row(x2, i), row(y2, i), row(z2, i)}, md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

extern "C" void ctt_host_ec_madd_team(const uint32_t* mod_words, const uint32_t* x1,
                                      const uint32_t* y1, const uint32_t* z1,
                                      const uint32_t* x2, const uint32_t* y2,
                                      uint32_t* x3, uint32_t* y3, uint32_t* z3, int n) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int i = 0; i < n; ++i) {
    Solo<NL> tm;
    const J R = ec_madd_team<NL>(tm, J{row(x1, i), row(y1, i), row(z1, i)}, row(x2, i),
                                 row(y2, i), md);
    put(x3, i, R.X);
    put(y3, i, R.Y);
    put(z3, i, R.Z);
  }
}

// K4's lane walk (ec.cuh flush_lane) over every lane, a team of one after
// the other: in the kernel's lane order, or reversed.
extern "C" void ctt_host_flush_scan_runs(const uint32_t* mod_words, const int32_t* keys,
                                         const uint32_t* xy, uint32_t* ex, uint32_t* ey,
                                         uint32_t* ez, int K, int M, int reverse) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  for (int t = 0; t < M; ++t) {
    Solo<NL> tm;
    flush_lane<NL>(tm, keys, xy, ex, ey, ez, K, M, reverse ? M - 1 - t : t, md);
  }
}

// The lanes' sequential scan over the one-thread ec_madd: lane m's
// accumulator after each entry, restarting at (x, y, 1) on a change of key.
extern "C" void ctt_host_flush_scan_seq(const uint32_t* mod_words, const int32_t* keys,
                                        const uint32_t* xy, uint32_t* ex, uint32_t* ey,
                                        uint32_t* ez, int K, int M) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  const size_t nl = (size_t)M;
  for (int m = 0; m < M; ++m) {
    J acc = jac_infinity<NL>(md);
    for (int k = 0; k < K; ++k) {
      const uint32_t* e = xy + k * 2 * NL * nl + m;
      const F X2 = load_col<NL>(e, nl), Y2 = load_col<NL>(e + NL * nl, nl);
      const bool same = k > 0 && keys[k * nl + m] == keys[(k - 1) * nl + m];
      acc = same ? ec_madd<NL>(acc, X2, Y2, md) : J{X2, Y2, fe_one<NL>(md)};
      Solo<NL> tm;
      const size_t o = k * NL * nl + m;
      store_split<NL>(tm, ex + o, ey + o, ez + o, nl, acc);
    }
  }
}

// K5's runs (ec.cuh merge_runs) for every team of a launch with chunks of
// Lc slots (team g: lane g mod M, slots from (g / M) Lc), a team of one
// after the other, in the kernel's team order or reversed. keys (K, M),
// q and out (K, 12, M) planar.
extern "C" void ctt_host_merge_scan_runs(const uint32_t* mod_words, const int32_t* keys,
                                         const uint32_t* qx, const uint32_t* qy,
                                         const uint32_t* qz, uint32_t* ex, uint32_t* ey,
                                         uint32_t* ez, int K, int M, int Lc, int reverse) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  const long long teams = (long long)M * ((K + Lc - 1) / Lc);
  for (long long t = 0; t < teams; ++t) {
    const long long g = reverse ? teams - 1 - t : t;
    const int m = (int)(g % M), k0 = (int)(g / M) * Lc;
    Solo<NL> tm;
    merge_runs<NL>(tm, keys, qx, qy, qz, ex, ey, ez, K, M, m, k0, k0 + Lc < K ? k0 + Lc : K,
                   md);
  }
}

// K6's lanes (ec.cuh bucket_lane) one after the other, in the kernel's lane
// order or reversed: each lane's two teams of kT, a thread a member, each
// team meeting at its own barrier and the pair at a barrier of 2 kT where
// the card's meet at __syncwarp.
template <int kT>
void bucket_lanes(const Mod<NL>& md, const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                  uint32_t* rx, uint32_t* ry, uint32_t* rz, uint32_t* wx, uint32_t* wy,
                  uint32_t* wz, int T, int C, bool reverse) {
  for (int i = 0; i < C; ++i) {
    const int c = reverse ? C - 1 - i : i;
    std::vector<uint32_t> slots(2 * 2 * kT * NL), hand(6 * NL);
    Barrier team0(kT), team1(kT), both(2 * kT);
    std::vector<std::thread> threads;
    for (int role = 0; role < 2; ++role)
      for (int r = 0; r < kT; ++r)
        threads.emplace_back([&, role, r] {
          ThreadTeam<NL, kT> tm{slots.data() + role * 2 * kT * NL, role ? &team1 : &team0, r};
          bucket_lane<NL>(tm, role, hand.data(), [&] { both.wait(); }, bx, by, bz, rx, ry, rz,
                          wx, wy, wz, T, C, c, md);
        });
    for (auto& t : threads) t.join();
  }
}

// K6 (ec.cuh bucket_lane) with two teams of T = 1, 2 or 4 a lane, the lanes
// in order or reversed: buckets (T, 12, C) planar, outputs (12, C). Returns
// -1 for another team size.
extern "C" int ctt_host_bucket_reduce_teams(const uint32_t* mod_words, int team, int reverse,
                                            const uint32_t* bx, const uint32_t* by,
                                            const uint32_t* bz, uint32_t* rx, uint32_t* ry,
                                            uint32_t* rz, uint32_t* wx, uint32_t* wy,
                                            uint32_t* wz, int T, int C) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  switch (team) {
    case 1: bucket_lanes<1>(md, bx, by, bz, rx, ry, rz, wx, wy, wz, T, C, reverse); return 0;
    case 2: bucket_lanes<2>(md, bx, by, bz, rx, ry, rz, wx, wy, wz, T, C, reverse); return 0;
    case 4: bucket_lanes<4>(md, bx, by, bz, rx, ry, rz, wx, wy, wz, T, C, reverse); return 0;
    default: return -1;
  }
}

// K3 double's lanes (ec.cuh double_k_lane) one team after the other, in the
// kernel's lane order or reversed: a team of one, or kT threads meeting at a
// barrier.
template <int kT>
void double_k_lanes(const Mod<NL>& md, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                    uint32_t* ox, uint32_t* oy, uint32_t* oz, int n, int k, bool reverse) {
  for (int t = 0; t < n; ++t) {
    const int i = reverse ? n - 1 - t : t;
    play_team<NL, kT>(
        [&](auto& tm) { double_k_lane<NL>(tm, x, y, z, ox, oy, oz, n, k, i, md); });
  }
}

// K3 double (ec.cuh double_k_lane): lane i of the planar (12, n) columns
// becomes 2^k P_i, a team of T = 1, 2 or 4 a lane, the lanes in order or
// reversed. Returns -1 for another T.
extern "C" int ctt_host_ec_double_k_team(const uint32_t* mod_words, int T, int reverse,
                                         const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                         uint32_t* ox, uint32_t* oy, uint32_t* oz, int n, int k) {
  const Mod<NL> md = mod_from_words<NL>(mod_words);
  switch (T) {
    case 1: double_k_lanes<1>(md, x, y, z, ox, oy, oz, n, k, reverse != 0); return 0;
    case 2: double_k_lanes<2>(md, x, y, z, ox, oy, oz, n, k, reverse != 0); return 0;
    case 4: double_k_lanes<4>(md, x, y, z, ox, oy, oz, n, k, reverse != 0); return 0;
    default: return -1;
  }
}

// A member of a team of kT threads, as store_split sees it.
template <int kT>
struct Member {
  static constexpr int T = kT;
  int rank;
};

template <int kT>
void store_members(const J& P, uint32_t* out) {
  for (int r = 0; r < kT; ++r) {
    uint32_t* o = out + r * 3 * NL;
    store_split<NL>(Member<kT>{r}, o, o + NL, o + 2 * NL, 1, P);
  }
}

// store_split's stores of the point (x, y, z) by each member r of a team of
// T (1, 2, 3, 4 or 8) into out + r * 3 * NL (X's words, then Y's, then Z's).
// Returns -1 for another T.
extern "C" int ctt_host_store_split(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                    uint32_t* out, int T) {
  const J P{row(x, 0), row(y, 0), row(z, 0)};
  switch (T) {
    case 1: store_members<1>(P, out); return 0;
    case 2: store_members<2>(P, out); return 0;
    case 3: store_members<3>(P, out); return 0;
    case 4: store_members<4>(P, out); return 0;
    case 8: store_members<8>(P, out); return 0;
    default: return -1;
  }
}

template <int N>
int inv_rows(const uint32_t* mod_words, const uint32_t* r3, const uint32_t* x, uint32_t* out,
             int n) {
  const Mod<N> md = mod_from_words<N>(mod_words);
  const InvConsts<N> C = inv_consts<N>(md, r3);
  for (int i = 0; i < n; ++i) {
    Fe<N> a;
    for (int l = 0; l < N; ++l) a.v[l] = x[(size_t)i * N + l];
    const Fe<N> r = fe_inv<N>(a, C, md);
    for (int l = 0; l < N; ++l) out[(size_t)i * N + l] = r.v[l];
  }
  return C.batches;
}

// inv.cuh's fe_inv (K9's lane) over nl = 8 or 12 limbs: x and out row-major
// (n, nl), r3 = R^3 mod p. Returns the batches of INV_BITS divsteps a lane
// runs, or -1 for another nl.
extern "C" int ctt_host_fe_inv(int nl, const uint32_t* mod_words, const uint32_t* r3,
                               const uint32_t* x, uint32_t* out, int n) {
  if (nl == 8) return inv_rows<8>(mod_words, r3, x, out, n);
  if (nl == 12) return inv_rows<12>(mod_words, r3, x, out, n);
  return -1;
}

// One batch of inv.cuh's divsteps on the low words f (odd) and g from eta =
// -delta: writes the matrix (u, v, q, r) to t and returns the new eta.
// Returns INV_BITS through *bits.
extern "C" int ctt_host_divsteps(int eta, uint32_t f, uint32_t g, int* t, int* bits) {
  Trans m;
  const int e = divsteps(eta, f, g, m);
  t[0] = m.u, t[1] = m.v, t[2] = m.q, t[3] = m.r;
  *bits = INV_BITS;
  return e;
}
