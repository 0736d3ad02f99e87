// One lane of G1 decompression with the subgroup check (K13).
//
// Replaces the kernel body of constantine_tpu/ops/pallas_g1.py
// (PallasG1._fn): rhs = x^3 + 4, y = rhs^((p+1)/4) (p = 3 mod 4), the
// is-square check y^2 == rhs, the lexicographic sign fix (y canonical >=
// (p+1)/2 is "big"), and Scott's test phi(P) == [-u^2]P with phi(x, y) =
// (beta x, y): a double-and-add ladder over the 127 bits of u^2 after its
// leading one, then the cross-multiplied comparison with -[u^2]P. The
// result is y (Montgomery) and ok = is-square AND in-subgroup; infinity
// lanes are the caller's business.
//
// Two forms of the lane: g1_decompress_lane, one thread over fe_mul, bit
// by bit (the host tests' reference), and g1_decompress_team, which the
// kernel runs: a team of threads (ec.cuh's team types) over fe_mul_eo, the
// square root by fixed 4-bit windows and the ladder in levels of
// independent products. Both return the same y and ok: every value is
// canonical, and the root is rhs^((p+1)/4) whatever the chain.
#pragma once

#include "tower.cuh"

namespace ctt {

constexpr int SQRT_WINDOWS = 96;   // 4-bit windows of an exponent < 2^384

struct G1DecompressConsts {
  MdP md;
  Fp beta;          // cube root of unity of the GLV endomorphism, Montgomery
  Fp half;          // (p + 1)/2, canonical
  FpExp sqrt_exp;   // (p + 1)/4
  FpExp u2;         // u^2
  uint8_t sqrt_win[SQRT_WINDOWS];   // (p + 1)/4's 4-bit digits, least significant first
  int sqrt_nwin;                    // its windows; the top one is not 0
};

// a >= b on canonical limbs.
CTT_HD bool fp_geq(const Fp& a, const Fp& b) {
  for (int i = FPN - 1; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

CTT_HD bool g1_decompress_lane(const Fp& xm, bool sign, Fp& y_out,
                               const G1DecompressConsts& C) {
  const MdP& M = C.md;
  const Fp one = fe_one<FPN>(M);
  const Fp four = fe_add<FPN>(fe_add<FPN>(one, one, M), fe_add<FPN>(one, one, M), M);
  const Fp rhs = fe_add<FPN>(fe_mul<FPN>(fe_sq<FPN>(xm, M), xm, M), four, M);
  Fp y = fp_pow(rhs, C.sqrt_exp, M);
  const bool is_sq = fp_eq(fe_sq<FPN>(y, M), rhs);
  Fp canon_one = fe_zero<FPN>();
  canon_one.v[0] = 1;
  const bool is_big = fp_geq(fe_mul<FPN>(y, canon_one, M), C.half);
  if (is_big != sign) y = fp_neg(y, M);
  Jac<FPN> T{xm, y, one};
  for (int b = C.u2.nbits - 2; b >= 0; --b) {
    T = ec_double<FPN>(T, M);
    if ((C.u2.w[b >> 5] >> (b & 31)) & 1u) T = ec_madd<FPN>(T, xm, y, M);
  }
  const Fp Z2 = fe_sq<FPN>(T.Z, M);
  const bool ex = fp_eq(fe_mul<FPN>(fe_mul<FPN>(C.beta, xm, M), Z2, M), T.X);
  const bool ey = fp_eq(fe_mul<FPN>(fe_mul<FPN>(y, T.Z, M), Z2, M), fp_neg(T.Y, M));
  y_out = y;
  return is_sq && ex && ey && !fe_is_zero<FPN>(T.Z);
}

// x^((p+1)/4) for a team. The window table x^1..x^15 lies in tab (15 * FPN
// words the team shares: shared memory on the card) and is built in 4
// levels, x^(h+j) = x^h x^j for j <= h = 1, 2, 4, 8, the level's products
// split among the members; then every member walks the windows itself
// (4 squarings and a product where the digit is not 0: one chain, nothing
// to share).
template <class Team>
CTT_HD Fp fp_sqrt_exp_team(Team& tm, uint32_t* tab, const Fp& x, const G1DecompressConsts& C) {
  const MdP& M = C.md;
  if (tm.rank == 0) slot_store(tab, 0, x);
  tm.sync();
  for (int h = 1; h < 16; h *= 2) {
    const Fp xh = slot_load(tab, h - 1);
    for (int j = 1 + tm.rank; j <= h && h + j < 16; j += Team::T)
      slot_store(tab, h + j - 1, fe_mul_eo<FPN>(xh, slot_load(tab, j - 1), M));
    tm.sync();
  }
  Fp acc = slot_load(tab, C.sqrt_win[C.sqrt_nwin - 1] - 1);
#pragma unroll 1
  for (int i = C.sqrt_nwin - 2; i >= 0; --i) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = fe_mul_eo<FPN>(acc, acc, M);
    const int w = C.sqrt_win[i];
    if (w) acc = fe_mul_eo<FPN>(acc, slot_load(tab, w - 1), M);
  }
  return acc;
}

// g1_decompress_lane's result for a team (ec.cuh's Solo, the card's SmTeam):
// the root as above; y^2 and y's canonical form in one level; the ladder
// over ec_double_team (3 levels) and, at the set bits of u^2, ec_madd_team
// (5 levels); the comparison's 5 products in 2 levels. tab: the team's
// 15 * FPN words for the window table.
template <class Team>
CTT_HD bool g1_decompress_team(Team& tm, uint32_t* tab, const Fp& xm, bool sign, Fp& y_out,
                               const G1DecompressConsts& C) {
  const MdP& M = C.md;
  const Fp one = fe_one<FPN>(M);
  const Fp four = fe_add<FPN>(fe_add<FPN>(one, one, M), fe_add<FPN>(one, one, M), M);
  const Fp rhs =
      fe_add<FPN>(fe_mul_eo<FPN>(fe_mul_eo<FPN>(xm, xm, M), xm, M), four, M);
  Fp y = fp_sqrt_exp_team(tm, tab, rhs, C);
  Fp canon_one = fe_zero<FPN>();
  canon_one.v[0] = 1;
  Fp sq[2];
  mul_level<FPN, 2>(tm, {y, y}, {y, canon_one}, sq, M);
  const bool is_sq = fp_eq(sq[0], rhs);
  if (fp_geq(sq[1], C.half) != sign) y = fp_neg(y, M);
  Jac<FPN> T{xm, y, one};
#pragma unroll 1
  for (int b = C.u2.nbits - 2; b >= 0; --b) {
    T = ec_double_team<FPN>(tm, T, M);
    if ((C.u2.w[b >> 5] >> (b & 31)) & 1u) T = ec_madd_team<FPN>(tm, T, xm, y, M);
  }
  Fp c1[3], c2[2];
  mul_level<FPN, 3>(tm, {T.Z, C.beta, y}, {T.Z, xm, T.Z}, c1, M);
  mul_level<FPN, 2>(tm, {c1[1], c1[2]}, {c1[0], c1[0]}, c2, M);
  const bool ex = fp_eq(c2[0], T.X);
  const bool ey = fp_eq(c2[1], fp_neg(T.Y, M));
  y_out = y;
  return is_sq && ex && ey && !fe_is_zero<FPN>(T.Z);
}

// A member's share of a lane's outputs: y's words l = rank mod T, and ok
// (1 or 0) by the last member.
template <class Team>
CTT_HD void g1_store_team(const Team& tm, uint32_t* y, int32_t* ok, const Fp& yi, bool good) {
#pragma unroll
  for (int l = 0; l < FPN; ++l)
    if (l % Team::T == tm.rank) y[l] = yi.v[l];
  if (tm.rank == Team::T - 1) *ok = good ? 1 : 0;
}

}  // namespace ctt
