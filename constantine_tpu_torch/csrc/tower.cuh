// Fp2, Fp6 and Fp12 over BLS12-381 Fp, for the pairing kernels K11 and K12.
//
// Replaces the kernel-side tower of constantine_tpu/ops/pallas_pairing.py
// (f2*/f6*/f12* over _CKF), with the same formulas, so every value is
// limb-identical to the port's plain towers (ops/towers.py) and to the
// JAX package's:
//   Fp2  = Fp[u]/(u^2 + 1)            (c0, c1)
//   Fp6  = Fp2[v]/(v^3 - xi), xi = 1+u (c0, c1, c2)
//   Fp12 = Fp6[w]/(w^2 - v)           (c0, c1); the six Fp2 coefficients in
//   memory order have w-degrees 0, 2, 4, 1, 3, 5.
// An Fp12 in memory is 12 Fp elements of 12 limbs, in that order.
//
// The field code is ec.cuh's (K2). The large tower products are functions
// of their own on the card (CTT_NOINL), so each Miller or final-
// exponentiation step calls them instead of inlining a few hundred
// multiplies at every site: that bounds the code size and the build time;
// the cost is the call and spills of a 144-word Fp12 to local memory.
//
// Like ec.cuh, the header also compiles with g++ (ec_host.cpp), which is
// how the CPU tests hold these formulas against the plain versions.
#pragma once

#include "ec.cuh"

#if defined(__CUDACC__)
#define CTT_NOINL __host__ __device__ __noinline__
#else
#define CTT_NOINL inline
#endif

namespace ctt {

constexpr int FPN = 12;
using Fp = Fe<FPN>;
using MdP = Mod<FPN>;

struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

// -- Fp extras ----------------------------------------------------------------

CTT_HD Fp fp_neg(const Fp& a, const MdP& M) { return fe_sub<FPN>(fe_zero<FPN>(), a, M); }

CTT_HD bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FPN; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// a / 2 mod p: (a + p*odd(a)) >> 1; a + p < 2^382 needs no extra word.
CTT_HD Fp fp_div2(const Fp& a, const MdP& M) {
  const uint32_t mask = 0u - (a.v[0] & 1u);
  uint32_t t[FPN];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FPN; ++i) {
    const uint64_t s = (uint64_t)a.v[i] + (M.p[i] & mask) + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < FPN - 1; ++i) r.v[i] = (t[i] >> 1) | (t[i + 1] << 31);
  r.v[FPN - 1] = t[FPN - 1] >> 1;
  return r;
}

// A host-known exponent: little-endian words and its bit length.
struct FpExp {
  uint32_t w[FPN];
  int nbits;
};

// x^e, most significant bit first (acc starts at x: the top bit is 1).
CTT_HD Fp fp_pow(const Fp& x, const FpExp& e, const MdP& M) {
  Fp acc = x;
  for (int b = e.nbits - 2; b >= 0; --b) {
    acc = fe_sq<FPN>(acc, M);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) acc = fe_mul<FPN>(acc, x, M);
  }
  return acc;
}

// -- Fp2 ------------------------------------------------------------------------

CTT_HD Fp2 f2add(const Fp2& a, const Fp2& b, const MdP& M) {
  return {fe_add<FPN>(a.c0, b.c0, M), fe_add<FPN>(a.c1, b.c1, M)};
}
CTT_HD Fp2 f2sub(const Fp2& a, const Fp2& b, const MdP& M) {
  return {fe_sub<FPN>(a.c0, b.c0, M), fe_sub<FPN>(a.c1, b.c1, M)};
}
CTT_HD Fp2 f2neg(const Fp2& a, const MdP& M) { return {fp_neg(a.c0, M), fp_neg(a.c1, M)}; }
CTT_HD Fp2 f2dbl(const Fp2& a, const MdP& M) { return f2add(a, a, M); }
CTT_HD Fp2 f2triple(const Fp2& a, const MdP& M) { return f2add(f2dbl(a, M), a, M); }
CTT_HD Fp2 f2conj(const Fp2& a, const MdP& M) { return {a.c0, fp_neg(a.c1, M)}; }
CTT_HD Fp2 f2div2(const Fp2& a, const MdP& M) { return {fp_div2(a.c0, M), fp_div2(a.c1, M)}; }
CTT_HD Fp2 f2zero() { return {fe_zero<FPN>(), fe_zero<FPN>()}; }
CTT_HD Fp2 f2one(const MdP& M) { return {fe_one<FPN>(M), fe_zero<FPN>()}; }

// Karatsuba over u^2 = -1: 3 multiplies.
CTT_HD Fp2 f2mul(const Fp2& a, const Fp2& b, const MdP& M) {
  const Fp v0 = fe_mul<FPN>(a.c0, b.c0, M);
  const Fp v1 = fe_mul<FPN>(a.c1, b.c1, M);
  const Fp t = fe_mul<FPN>(fe_add<FPN>(a.c0, a.c1, M), fe_add<FPN>(b.c0, b.c1, M), M);
  return {fe_sub<FPN>(v0, v1, M), fe_sub<FPN>(fe_sub<FPN>(t, v0, M), v1, M)};
}

// Complex squaring: 2 multiplies.
CTT_HD Fp2 f2sq(const Fp2& a, const MdP& M) {
  const Fp c0 = fe_mul<FPN>(fe_add<FPN>(a.c0, a.c1, M), fe_sub<FPN>(a.c0, a.c1, M), M);
  const Fp t = fe_mul<FPN>(a.c0, a.c1, M);
  return {c0, fe_add<FPN>(t, t, M)};
}

// xi * a, xi = 1 + u.
CTT_HD Fp2 f2xi(const Fp2& a, const MdP& M) {
  return {fe_sub<FPN>(a.c0, a.c1, M), fe_add<FPN>(a.c0, a.c1, M)};
}

CTT_HD Fp2 f2mul_fp(const Fp2& a, const Fp& s, const MdP& M) {
  return {fe_mul<FPN>(a.c0, s, M), fe_mul<FPN>(a.c1, s, M)};
}

// 1/a through the norm a0^2 + a1^2 (u^2 = -1) and Fermat over Fp.
CTT_HD Fp2 f2inv(const Fp2& a, const FpExp& pm2, const MdP& M) {
  const Fp norm = fe_add<FPN>(fe_sq<FPN>(a.c0, M), fe_sq<FPN>(a.c1, M), M);
  const Fp ninv = fp_pow(norm, pm2, M);
  return {fe_mul<FPN>(a.c0, ninv, M), fp_neg(fe_mul<FPN>(a.c1, ninv, M), M)};
}

// -- Fp6 ------------------------------------------------------------------------

CTT_HD Fp6 f6add(const Fp6& a, const Fp6& b, const MdP& M) {
  return {f2add(a.c0, b.c0, M), f2add(a.c1, b.c1, M), f2add(a.c2, b.c2, M)};
}
CTT_HD Fp6 f6sub(const Fp6& a, const Fp6& b, const MdP& M) {
  return {f2sub(a.c0, b.c0, M), f2sub(a.c1, b.c1, M), f2sub(a.c2, b.c2, M)};
}
CTT_HD Fp6 f6neg(const Fp6& a, const MdP& M) {
  return {f2neg(a.c0, M), f2neg(a.c1, M), f2neg(a.c2, M)};
}
// v * a = (xi a2, a0, a1).
CTT_HD Fp6 f6mul_v(const Fp6& a, const MdP& M) { return {f2xi(a.c2, M), a.c0, a.c1}; }

// Karatsuba cubic: 6 Fp2 multiplies.
CTT_NOINL Fp6 f6mul(const Fp6& a, const Fp6& b, const MdP& M) {
  const Fp2 v0 = f2mul(a.c0, b.c0, M);
  const Fp2 v1 = f2mul(a.c1, b.c1, M);
  const Fp2 v2 = f2mul(a.c2, b.c2, M);
  const Fp2 m12 = f2mul(f2add(a.c1, a.c2, M), f2add(b.c1, b.c2, M), M);
  const Fp2 m01 = f2mul(f2add(a.c0, a.c1, M), f2add(b.c0, b.c1, M), M);
  const Fp2 m02 = f2mul(f2add(a.c0, a.c2, M), f2add(b.c0, b.c2, M), M);
  const Fp2 t0 = f2sub(f2sub(m12, v1, M), v2, M);
  const Fp2 t1 = f2sub(f2sub(m01, v0, M), v1, M);
  const Fp2 t2 = f2sub(f2sub(m02, v0, M), v2, M);
  return {f2add(v0, f2xi(t0, M), M), f2add(t1, f2xi(v2, M), M), f2add(t2, v1, M)};
}

// Chung-Hasan SQR2.
CTT_NOINL Fp6 f6sq(const Fp6& a, const MdP& M) {
  const Fp2 t = f2sub(f2add(a.c0, a.c2, M), a.c1, M);
  const Fp2 s0 = f2sq(a.c0, M);
  const Fp2 ab = f2mul(a.c0, a.c1, M);
  const Fp2 s2 = f2sq(t, M);
  const Fp2 bc = f2mul(a.c1, a.c2, M);
  const Fp2 s4 = f2sq(a.c2, M);
  const Fp2 s1 = f2dbl(ab, M);
  const Fp2 s3 = f2dbl(bc, M);
  return {f2add(s0, f2xi(s3, M), M), f2add(s1, f2xi(s4, M), M),
          f2sub(f2sub(f2add(f2add(s1, s2, M), s3, M), s0, M), s4, M)};
}

// a * (b1 v + b2 v^2): c0 = xi (a1 b2 + a2 b1), c1 = a0 b1 + xi a2 b2,
// c2 = a0 b2 + a1 b1.
CTT_HD Fp6 f6mul_sparse12(const Fp6& a, const Fp2& b1, const Fp2& b2, const MdP& M) {
  const Fp2 p01 = f2mul(a.c0, b1, M);
  const Fp2 p02 = f2mul(a.c0, b2, M);
  const Fp2 p11 = f2mul(a.c1, b1, M);
  const Fp2 p12 = f2mul(a.c1, b2, M);
  const Fp2 p21 = f2mul(a.c2, b1, M);
  const Fp2 p22 = f2mul(a.c2, b2, M);
  return {f2xi(f2add(p12, p21, M), M), f2add(p01, f2xi(p22, M), M), f2add(p02, p11, M)};
}

CTT_HD Fp6 f6mul_fp2(const Fp6& a, const Fp2& s, const MdP& M) {
  return {f2mul(a.c0, s, M), f2mul(a.c1, s, M), f2mul(a.c2, s, M)};
}

CTT_HD Fp6 f6inv(const Fp6& a, const FpExp& pm2, const MdP& M) {
  const Fp2 v0 = f2sub(f2sq(a.c0, M), f2xi(f2mul(a.c1, a.c2, M), M), M);
  const Fp2 v1 = f2sub(f2xi(f2sq(a.c2, M), M), f2mul(a.c0, a.c1, M), M);
  const Fp2 v2 = f2sub(f2sq(a.c1, M), f2mul(a.c0, a.c2, M), M);
  const Fp2 fv = f2add(f2mul(a.c0, v0, M),
                       f2xi(f2add(f2mul(a.c2, v1, M), f2mul(a.c1, v2, M), M), M), M);
  const Fp2 finv = f2inv(fv, pm2, M);
  return {f2mul(v0, finv, M), f2mul(v1, finv, M), f2mul(v2, finv, M)};
}

// -- Fp12 -----------------------------------------------------------------------

CTT_HD Fp12 f12one(const MdP& M) {
  return {{f2one(M), f2zero(), f2zero()}, {f2zero(), f2zero(), f2zero()}};
}

CTT_HD Fp12 f12conj(const Fp12& a, const MdP& M) { return {a.c0, f6neg(a.c1, M)}; }

// Karatsuba quadratic: 3 Fp6 multiplies.
CTT_NOINL Fp12 f12mul(const Fp12& a, const Fp12& b, const MdP& M) {
  const Fp6 v0 = f6mul(a.c0, b.c0, M);
  const Fp6 v1 = f6mul(a.c1, b.c1, M);
  const Fp6 t = f6mul(f6add(a.c0, a.c1, M), f6add(b.c0, b.c1, M), M);
  return {f6add(v0, f6mul_v(v1, M), M), f6sub(f6sub(t, v0, M), v1, M)};
}

// c1 = 2 a0 a1; c0 = (a0 + a1)(a0 + v a1) - t - v t, t = a0 a1.
CTT_NOINL Fp12 f12sq(const Fp12& a, const MdP& M) {
  const Fp6 t = f6mul(a.c0, a.c1, M);
  const Fp6 u = f6mul(f6add(a.c0, a.c1, M), f6add(a.c0, f6mul_v(a.c1, M), M), M);
  return {f6sub(f6sub(u, t, M), f6mul_v(t, M), M), f6add(t, t, M)};
}

// f * line for the M-twist line (lA, 0, 0) + (0, lC, lB) w: 15 Fp2 multiplies.
CTT_NOINL Fp12 f12sparse_line(const Fp12& f, const Fp2& lA, const Fp2& lC, const Fp2& lB,
                              const MdP& M) {
  const Fp6 v0 = f6mul_fp2(f.c0, lA, M);
  const Fp6 v1 = f6mul_sparse12(f.c1, lC, lB, M);
  const Fp6 s{lA, lC, lB};
  const Fp6 t = f6mul(f6add(f.c0, f.c1, M), s, M);
  return {f6add(v0, f6mul_v(v1, M), M), f6sub(f6sub(t, v0, M), v1, M)};
}

// Granger-Scott cyclotomic squaring (unitary input): three Fp4 squarings.
CTT_HD void sq4(const Fp2& x, const Fp2& y, Fp2& c0, Fp2& c1, const MdP& M) {
  const Fp2 xx = f2sq(x, M);
  const Fp2 yy = f2sq(y, M);
  c0 = f2add(xx, f2xi(yy, M), M);
  c1 = f2sub(f2sub(f2sq(f2add(x, y, M), M), xx, M), yy, M);
}

CTT_HD Fp2 m32(const Fp2& v, const Fp2& b, const MdP& M) {  // 3v - 2b
  const Fp2 t = f2sub(v, b, M);
  return f2add(f2dbl(t, M), v, M);
}

CTT_HD Fp2 p32(const Fp2& v, const Fp2& b, const MdP& M) {  // 3v + 2b
  const Fp2 t = f2add(v, b, M);
  return f2add(f2dbl(t, M), v, M);
}

CTT_NOINL Fp12 f12cyc_sq(const Fp12& a, const MdP& M) {
  Fp2 v00, v01, v10, v11, v20, v21;
  sq4(a.c0.c0, a.c1.c1, v00, v01, M);
  sq4(a.c1.c0, a.c0.c2, v10, v11, M);
  sq4(a.c0.c1, a.c1.c2, v20, v21, M);
  return {{m32(v00, a.c0.c0, M), m32(v10, a.c0.c1, M), m32(v20, a.c0.c2, M)},
          {p32(f2xi(v21, M), a.c1.c0, M), p32(v01, a.c1.c1, M), p32(v11, a.c1.c2, M)}};
}

// f^(p^k): conjugate every Fp2 coefficient for odd k, then multiply
// coefficient j by gamma[j] (gamma[0] == 1 is skipped).
CTT_NOINL Fp12 f12frob(const Fp12& a, const Fp2* gamma, bool odd, const MdP& M) {
  Fp2 c[6] = {a.c0.c0, a.c0.c1, a.c0.c2, a.c1.c0, a.c1.c1, a.c1.c2};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (odd) c[k] = f2conj(c[k], M);
    if (k > 0) c[k] = f2mul(c[k], gamma[k], M);
  }
  return {{c[0], c[1], c[2]}, {c[3], c[4], c[5]}};
}

// 1/a through the norms down to Fp (Fermat there): a0^2 - v a1^2 in Fp6,
// then Fp2, then Fp.
CTT_HD Fp12 f12inv(const Fp12& a, const FpExp& pm2, const MdP& M) {
  const Fp6 d = f6sub(f6sq(a.c0, M), f6mul_v(f6sq(a.c1, M), M), M);
  const Fp6 dinv = f6inv(d, pm2, M);
  return {f6mul(a.c0, dinv, M), f6neg(f6mul(a.c1, dinv, M), M)};
}

// Coefficient k (0..11) of an Fp12 in memory order.
CTT_HD Fp& f12at(Fp12& f, int k) {
  Fp6& h = k < 6 ? f.c0 : f.c1;
  const int j = k % 6;
  Fp2& e = j < 2 ? h.c0 : (j < 4 ? h.c1 : h.c2);
  return (j & 1) ? e.c1 : e.c0;
}

CTT_HD Fp fp_load(const uint32_t* src) {
  Fp r;
#pragma unroll
  for (int l = 0; l < FPN; ++l) r.v[l] = src[l];
  return r;
}

CTT_HD void fp_store(uint32_t* dst, const Fp& a) {
#pragma unroll
  for (int l = 0; l < FPN; ++l) dst[l] = a.v[l];
}

// (12, 12) row-major words <-> Fp12.
CTT_HD Fp12 f12load(const uint32_t* src) {
  Fp12 f;
#pragma unroll
  for (int k = 0; k < 12; ++k) f12at(f, k) = fp_load(src + k * FPN);
  return f;
}

CTT_HD void f12store(uint32_t* dst, Fp12 f) {
#pragma unroll
  for (int k = 0; k < 12; ++k) fp_store(dst + k * FPN, f12at(f, k));
}

}  // namespace ctt
