// Modular inverse by Bernstein-Yang divsteps (safegcd), in constant time.
//
// K9's lane (field_kernels.cu fermat_inv_kernel). The reference inverts by
// Fermat, x^(p-2) (constantine_tpu/ops/pallas_ec.py:1095-1144,
// PallasAffine.fermat_inv); upstream Constantine inverts by this algorithm
// (arithmetic/limbs_exgcd.nim). For a lane in Montgomery form, aR, fe_inv
// returns a^-1 R canonical, the limbs of the reference's power: the inverse
// is unique and both results are reduced. 0 gives 0.
//
// The algorithm (Bernstein, Yang, "Fast constant-time gcd computation and
// modular inversion", TCHES 2019, with the layout of libsecp256k1's modinv32
// and modinv64): start from (delta, f, g) = (1, p, x), d = 0, e = 1, so that
// f = d x and g = e x mod p. A divstep is
//   delta > 0 and g odd:  (1 - delta, g, (g - f)/2)
//   otherwise:            (1 + delta, f, (g + (g mod 2) f)/2).
// B = INV_BITS of them depend only on delta and the low B bits of f and g,
// so they run on one word (divsteps below) and give a 2x2 matrix t with
// entries of at most B bits, |u| + |v| <= 2^B and |q| + |r| <= 2^B, such that
// [f', g'] = t [f, g] / 2^B. The same t moves [d, e], each made divisible by
// 2^B by adding the multiple of p that clears its low B bits (so d and e
// stay in (-2p, p)). Once g = 0, f = +-1 (the gcd) and x^-1 = +-d mod p.
//
// The count. Theorem 11.2 of that paper: if f is odd and f^2 + 4 g^2 <=
// 5 * 2^(2 d), then g = 0 after floor((49 d + 57) / 17) divsteps from
// delta = 1 when d >= 46 (floor((49 d + 80) / 17) below 46). With f = p <
// 2^d and 0 <= g < p this is 1,101 divsteps for BLS12-381's p (d = 381) and
// 738 for its r (d = 255). The loop runs ceil(that / B) batches whatever the
// input (37 for p and 25 for r); a divstep after g = 0 leaves f and d as
// they are. No branch and no loop bound depends on the data, so the lanes of
// a warp run the same instructions.
//
// Numbers are signed, in L limbs of B bits: limbs 0..L-2 in [0, 2^B) and a
// signed top limb; limb products are B x B -> 2B-bit signed.
#pragma once

#include "ec.cuh"

namespace ctt {

// Divsteps a batch, and the limb types: 30 on 32-bit words with 64-bit
// products. (62 on 64-bit words with __int128 products, which
// scripts/torch_scaled_doubles_inv_teams.py builds from a copy of this file
// with these four lines changed, is 2.3-2.6x slower on the H100: PERF.md.)
constexpr int INV_BITS = 30;
using SgS = int32_t;    // a limb or a matrix entry, signed
using SgU = uint32_t;   // the same, unsigned
using SgW = int64_t;    // a product of two limbs, and a carry

// A signed number of 32N + 2 bits (d and e lie in (-2p, p)) in B-bit limbs.
template <int N>
struct Sg {
  static constexpr int L = (32 * N + 2 + INV_BITS - 1) / INV_BITS;
  SgS v[L];
};

// The batch's transition matrix, scaled by 2^B.
struct Trans {
  SgS u, v, q, r;
};

template <int N>
struct InvConsts {
  Sg<N> p;       // the modulus
  SgU pinv;      // p^-1 mod 2^B
  Fe<N> r3;      // R^3 mod p
  int batches;   // ceil(divsteps_bound(bits of p) / B)
};

// Bernstein-Yang's divstep count for a modulus of d bits (Theorem 11.2).
CTT_HD constexpr int divsteps_bound(int d) {
  return d >= 46 ? (49 * d + 57) / 17 : (49 * d + 80) / 17;
}

template <int N>
CTT_HD uint32_t word_or0(const uint32_t* w, int k) {
  return k < N ? w[k] : 0u;
}

// N canonical 32-bit words -> B-bit limbs (the top limb takes what is left).
template <int N>
CTT_HD Sg<N> sg_from_words(const uint32_t* w) {
  constexpr uint64_t mask = (1ull << INV_BITS) - 1;
  Sg<N> r;
#pragma unroll
  for (int i = 0; i < Sg<N>::L; ++i) {
    const int bit = INV_BITS * i, k = bit / 32, s = bit % 32;
    uint64_t x = ((uint64_t)word_or0<N>(w, k) | ((uint64_t)word_or0<N>(w, k + 1) << 32)) >> s;
    if (s > 0) x |= (uint64_t)word_or0<N>(w, k + 2) << ((64 - s) & 63);
    r.v[i] = (SgS)(x & mask);
  }
  return r;
}

// B-bit limbs of a number in [0, 2^(32N)) -> N words.
template <int N>
CTT_HD Fe<N> sg_to_words(const Sg<N>& a) {
  constexpr int L = Sg<N>::L;
  Fe<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int bit = 32 * j, i = bit / INV_BITS, s = bit % INV_BITS;
    uint64_t x = (uint64_t)a.v[i] >> s;
    if (i + 1 < L) x |= (uint64_t)a.v[i + 1 < L ? i + 1 : i] << (INV_BITS - s);
    if (i + 2 < L && 2 * INV_BITS - s < 32)
      x |= (uint64_t)a.v[i + 2 < L ? i + 2 : i] << ((2 * INV_BITS - s) & 63);
    r.v[j] = (uint32_t)x;
  }
  return r;
}

// The constants of fe_inv for the modulus of M; r3 is R^3 mod p in N words.
template <int N>
CTT_HD InvConsts<N> inv_consts(const Mod<N>& M, const uint32_t* r3) {
  InvConsts<N> C;
  C.p = sg_from_words<N>(M.p);
  const SgU p0 = (SgU)C.p.v[0];
  SgU x = p0;                                         // p0 x = 1 mod 8 for odd p0
  for (int i = 0; i < 6; ++i) x *= (SgU)2 - p0 * x;   // the precision doubles
  C.pinv = x & (SgU)((1ull << INV_BITS) - 1);
  for (int i = 0; i < N; ++i) C.r3.v[i] = r3[i];
  int d = 32 * N;
  while (d > 0 && !((M.p[(d - 1) / 32] >> ((d - 1) % 32)) & 1u)) --d;
  C.batches = (divsteps_bound(d) + INV_BITS - 1) / INV_BITS;
  return C;
}

// B divsteps on the low words f, g (f odd) from eta = -delta. Returns the
// new eta and sets t with t [f0, g0] = 2^B [f, g]; branch-free.
CTT_HD SgS divsteps(SgS eta, SgU f, SgU g, Trans& t) {
  constexpr int top = 8 * sizeof(SgS) - 1;
  SgU u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < INV_BITS; ++i) {
    const SgU c1 = (SgU)(eta >> top);   // all ones where delta > 0
    const SgU c2 = (SgU)0 - (g & 1u);   // all ones where g is odd
    // g += (delta > 0 ? -f : f) where g is odd, and the rows alike
    const SgU x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    // the swap: delta > 0 and g odd. f becomes the old g (f + (g - f)),
    // delta 1 - delta (eta -eta - 1); otherwise delta 1 + delta
    const SgU sw = c1 & c2;
    eta = (eta ^ (SgS)sw) - 1 - (SgS)sw;
    f += g & sw;
    u += q & sw;
    v += r & sw;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (SgS)u;
  t.v = (SgS)v;
  t.q = (SgS)q;
  t.r = (SgS)r;
  return eta;
}

// [f, g] = t [f, g] / 2^B, exact.
template <int N>
CTT_HD void update_fg(Sg<N>& f, Sg<N>& g, const Trans& t) {
  constexpr int L = Sg<N>::L;
  constexpr SgS mask = (SgS)((1ull << INV_BITS) - 1);
  SgW cf = (SgW)t.u * f.v[0] + (SgW)t.v * g.v[0];
  SgW cg = (SgW)t.q * f.v[0] + (SgW)t.r * g.v[0];
  cf >>= INV_BITS;
  cg >>= INV_BITS;
#pragma unroll
  for (int i = 1; i < L; ++i) {
    cf += (SgW)t.u * f.v[i] + (SgW)t.v * g.v[i];
    cg += (SgW)t.q * f.v[i] + (SgW)t.r * g.v[i];
    f.v[i - 1] = (SgS)cf & mask;
    g.v[i - 1] = (SgS)cg & mask;
    cf >>= INV_BITS;
    cg >>= INV_BITS;
  }
  f.v[L - 1] = (SgS)cf;
  g.v[L - 1] = (SgS)cg;
}

// [d, e] = (t [d, e] + p [md, me]) / 2^B, md and me chosen so the division is
// exact; d, e in (-2p, p) in and out.
template <int N>
CTT_HD void update_de(Sg<N>& d, Sg<N>& e, const Trans& t, const InvConsts<N>& C) {
  constexpr int L = Sg<N>::L;
  constexpr int top = 8 * sizeof(SgS) - 1;
  constexpr SgS mask = (SgS)((1ull << INV_BITS) - 1);
  // start from [u, q] where d < 0, plus [v, r] where e < 0
  const SgS sd = d.v[L - 1] >> top, se = e.v[L - 1] >> top;
  SgS md = (t.u & sd) + (t.v & se);
  SgS me = (t.q & sd) + (t.r & se);
  SgW cd = (SgW)t.u * d.v[0] + (SgW)t.v * e.v[0];
  SgW ce = (SgW)t.q * d.v[0] + (SgW)t.r * e.v[0];
  md -= (SgS)((C.pinv * (SgU)cd + (SgU)md) & (SgU)mask);
  me -= (SgS)((C.pinv * (SgU)ce + (SgU)me) & (SgU)mask);
  cd += (SgW)C.p.v[0] * md;
  ce += (SgW)C.p.v[0] * me;
  cd >>= INV_BITS;
  ce >>= INV_BITS;
#pragma unroll
  for (int i = 1; i < L; ++i) {
    cd += (SgW)t.u * d.v[i] + (SgW)t.v * e.v[i] + (SgW)C.p.v[i] * md;
    ce += (SgW)t.q * d.v[i] + (SgW)t.r * e.v[i] + (SgW)C.p.v[i] * me;
    d.v[i - 1] = (SgS)cd & mask;
    e.v[i - 1] = (SgS)ce & mask;
    cd >>= INV_BITS;
    ce >>= INV_BITS;
  }
  d.v[L - 1] = (SgS)cd;
  e.v[L - 1] = (SgS)ce;
}

// a += p where c is all ones, then carry the limbs back into [0, 2^B).
template <int N>
CTT_HD void sg_add_p_carry(Sg<N>& a, SgS c, const InvConsts<N>& C) {
  constexpr int L = Sg<N>::L;
  constexpr SgS mask = (SgS)((1ull << INV_BITS) - 1);
#pragma unroll
  for (int i = 0; i < L; ++i) a.v[i] += C.p.v[i] & c;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    a.v[i + 1] += a.v[i] >> INV_BITS;
    a.v[i] &= mask;
  }
}

// fsign * d mod p in [0, p), for d in (-2p, p) and fsign 0 (f = 1) or all
// ones (f = -1).
template <int N>
CTT_HD void sg_normalize(Sg<N>& d, SgS fsign, const InvConsts<N>& C) {
  constexpr int L = Sg<N>::L;
  constexpr int top = 8 * sizeof(SgS) - 1;
  sg_add_p_carry<N>(d, d.v[L - 1] >> top, C);   // (-p, p)
#pragma unroll
  for (int i = 0; i < L; ++i) d.v[i] = (d.v[i] ^ fsign) - fsign;
  sg_add_p_carry<N>(d, (SgS)0, C);              // carry the negation
  sg_add_p_carry<N>(d, d.v[L - 1] >> top, C);   // [0, p)
}

// a^-1 R for a = aR in Montgomery form (canonical, < p); 0 gives 0.
template <int N>
CTT_HD Fe<N> fe_inv(const Fe<N>& a, const InvConsts<N>& C, const Mod<N>& M) {
  constexpr int L = Sg<N>::L;
  constexpr int top = 8 * sizeof(SgS) - 1;
  Sg<N> f = C.p, g = sg_from_words<N>(a.v), d, e;
#pragma unroll
  for (int i = 0; i < L; ++i) d.v[i] = e.v[i] = 0;
  e.v[0] = 1;
  SgS eta = -1;   // delta = 1
#pragma unroll 1
  for (int b = 0; b < C.batches; ++b) {
    Trans t;
    eta = divsteps(eta, (SgU)f.v[0], (SgU)g.v[0], t);
    update_fg<N>(f, g, t);
    update_de<N>(d, e, t, C);
  }
  sg_normalize<N>(d, f.v[L - 1] >> top, C);       // (aR)^-1 as an integer
  return fe_mul<N>(sg_to_words<N>(d), C.r3, M);   // (aR)^-1 R^3 R^-1
}

}  // namespace ctt
