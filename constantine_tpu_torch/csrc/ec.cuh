// Field and point arithmetic shared by every kernel of the port (K2).
//
// Replaces constantine_tpu/ops/pallas_ec.py:_KF, the in-kernel library that
// the TPU kernels inline: Montgomery multiply, add/sub/double mod p, and the
// a = 0 Jacobian group law ec_double (dbl-2009-l), ec_madd (madd-2007-bl)
// and ec_add (add-2007-bl), with the same formulas and the same degenerate-
// case selects as the reference, so every output is limb-identical.
//
// Layout: an element is N little-endian 32-bit limbs in Montgomery form with
// R = 2^(32N) -- the reference's R, since its 16-bit digits pair into these
// limbs. Only m0 differs: -p^-1 mod 2^32 instead of mod 2^16.
//
// What bounds it on an H100: integer multiply-add issue. A 12-limb multiply
// is about 300 32x32->64 products (CIOS: N^2 for a*b, N^2 + N for the
// reduction), and an EC step is 7-16 multiplies, so the kernels do hundreds
// of operations per byte they move. The design keeps everything in
// registers: the header is plain __forceinline__ code on structs of limbs,
// the carry chains are PTX add.cc/addc/mad.lo.cc/madc.hi (one carry flag,
// no 64-bit temporaries), and the reduction needs no extra top word because
// p < 2^(32N-1) (the "no-carry" CIOS bound). The degenerate doubling of the
// complete add is a per-thread branch (the reference's @pl.when(any lane)).
//
// The same code compiles on the host with g++ (portable uint64 arithmetic
// replaces the PTX), which is how the tests check it without a card.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define CTT_HD __host__ __device__ __forceinline__
#else
#define CTT_HD inline
#endif

namespace ctt {

// Modulus constants, passed to kernels by value. Host layout of the words
// array the wrappers hand over: p[0..N), m0, one[0..N).
template <int N>
struct Mod {
  uint32_t p[N];
  uint32_t m0;      // -p^-1 mod 2^32
  uint32_t one[N];  // R mod p (Montgomery one)
};

template <int N>
CTT_HD Mod<N> mod_from_words(const uint32_t* w) {
  Mod<N> m;
  for (int i = 0; i < N; ++i) m.p[i] = w[i];
  m.m0 = w[N];
  for (int i = 0; i < N; ++i) m.one[i] = w[N + 1 + i];
  return m;
}

template <int N>
struct Fe {
  uint32_t v[N];
};

template <int N>
struct Jac {
  Fe<N> X, Y, Z;
};

template <int N>
CTT_HD Fe<N> fe_zero() {
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = 0;
  return r;
}

template <int N>
CTT_HD Fe<N> fe_one(const Mod<N>& M) {
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = M.one[i];
  return r;
}

template <int N>
CTT_HD bool fe_is_zero(const Fe<N>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a.v[i];
  return acc == 0;
}

template <int N>
CTT_HD Fe<N> fe_sel(bool c, const Fe<N>& a, const Fe<N>& b) {
  Fe<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// a + b mod p (inputs < p).
template <int N>
CTT_HD Fe<N> fe_add(const Fe<N>& a, const Fe<N>& b, const Mod<N>& M) {
  Fe<N> s, d;
  uint32_t carry, borrow;
#if defined(__CUDA_ARCH__)
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s.v[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(s.v[i]) : "r"(a.v[i]), "r"(b.v[i]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(carry));
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d.v[0]) : "r"(s.v[0]), "r"(M.p[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d.v[i]) : "r"(s.v[i]), "r"(M.p[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
#else
  uint64_t c = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  carry = (uint32_t)c;
  uint64_t br = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t t = (uint64_t)s.v[i] - M.p[i] - br;
    d.v[i] = (uint32_t)t;
    br = t >> 63;
  }
  borrow = br ? 0xFFFFFFFFu : 0u;
#endif
  return fe_sel<N>(carry != 0 || borrow == 0, d, s);
}

// a - b mod p (inputs < p).
template <int N>
CTT_HD Fe<N> fe_sub(const Fe<N>& a, const Fe<N>& b, const Mod<N>& M) {
  Fe<N> d;
#if defined(__CUDA_ARCH__)
  uint32_t borrow;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d.v[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d.v[i]) : "r"(a.v[i]), "r"(b.v[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
  // add p masked by the borrow (0 or all ones)
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(d.v[0]) : "r"(M.p[0] & borrow));
#pragma unroll
  for (int i = 1; i < N - 1; ++i)
    asm volatile("addc.cc.u32 %0, %0, %1;" : "+r"(d.v[i]) : "r"(M.p[i] & borrow));
  asm volatile("addc.u32 %0, %0, %1;" : "+r"(d.v[N - 1]) : "r"(M.p[N - 1] & borrow));
#else
  uint64_t br = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - br;
    d.v[i] = (uint32_t)t;
    br = t >> 63;
  }
  uint32_t mask = br ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t t = (uint64_t)d.v[i] + (M.p[i] & mask) + c;
    d.v[i] = (uint32_t)t;
    c = t >> 32;
  }
#endif
  return d;
}

template <int N>
CTT_HD Fe<N> fe_dbl(const Fe<N>& a, const Mod<N>& M) {
  return fe_add<N>(a, a, M);
}

// Montgomery product a*b*R^-1 mod p, CIOS over 32-bit limbs (inputs < p).
// Needs p < 2^(32N-1): then every partial sum fits N+1 words and the
// result is < 2p before the one conditional subtraction.
template <int N>
CTT_HD Fe<N> fe_mul(const Fe<N>& a, const Fe<N>& b, const Mod<N>& M) {
  uint32_t t[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) t[j] = 0;
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b.v[i];
    // t[0..N] += a * bi   (t[N] == 0 here)
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(a.v[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < N; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(a.v[j]), "r"(bi));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[N]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a.v[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < N - 1; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(a.v[j]), "r"(bi));
    asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[N]) : "r"(a.v[N - 1]), "r"(bi));
    // t += m * p, which clears t[0]
    const uint32_t m = t[0] * M.m0;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(m), "r"(M.p[0]));
#pragma unroll
    for (int j = 1; j < N; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(m), "r"(M.p[j]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[N]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(m), "r"(M.p[0]));
#pragma unroll
    for (int j = 1; j < N - 1; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(m), "r"(M.p[j]));
    asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[N]) : "r"(m), "r"(M.p[N - 1]));
    // divide by 2^32
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = t[j + 1];
    t[N] = 0;
  }
#else
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    t[N] += (uint32_t)c;
    const uint32_t m = t[0] * M.m0;
    uint64_t s = (uint64_t)m * M.p[0] + t[0];
    c = s >> 32;
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    t[N - 1] = t[N] + (uint32_t)c;
    t[N] = 0;
  }
#endif
  // result < 2p < 2^(32N): subtract p once if it fits
  Fe<N> r, d;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = t[j];
  uint32_t borrow;
#if defined(__CUDA_ARCH__)
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d.v[0]) : "r"(r.v[0]), "r"(M.p[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d.v[i]) : "r"(r.v[i]), "r"(M.p[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
#else
  uint64_t br = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t x = (uint64_t)r.v[i] - M.p[i] - br;
    d.v[i] = (uint32_t)x;
    br = x >> 63;
  }
  borrow = (uint32_t)br;
#endif
  return fe_sel<N>(borrow == 0, d, r);
}

template <int N>
CTT_HD Fe<N> fe_sq(const Fe<N>& a, const Mod<N>& M) {
  return fe_mul<N>(a, a, M);
}

// -- a = 0 short-Weierstrass group law, Jacobian coordinates ---------------

template <int N>
CTT_HD Jac<N> jac_infinity(const Mod<N>& M) {
  return Jac<N>{fe_one<N>(M), fe_one<N>(M), fe_zero<N>()};
}

// dbl-2009-l. Z = 0 in gives Z = 0 out; Y = 0 gives infinity.
template <int N>
CTT_HD Jac<N> ec_double(const Jac<N>& P, const Mod<N>& M) {
  const Fe<N> A = fe_sq<N>(P.X, M);
  const Fe<N> B = fe_sq<N>(P.Y, M);
  const Fe<N> C = fe_sq<N>(B, M);
  const Fe<N> t = fe_sq<N>(fe_add<N>(P.X, B, M), M);
  const Fe<N> D = fe_dbl<N>(fe_sub<N>(fe_sub<N>(t, A, M), C, M), M);
  const Fe<N> E = fe_add<N>(fe_dbl<N>(A, M), A, M);
  const Fe<N> Fq = fe_sq<N>(E, M);
  Jac<N> R;
  R.X = fe_sub<N>(Fq, fe_dbl<N>(D, M), M);
  R.Y = fe_sub<N>(fe_mul<N>(E, fe_sub<N>(D, R.X, M), M),
                  fe_dbl<N>(fe_dbl<N>(fe_dbl<N>(C, M), M), M), M);
  R.Z = fe_dbl<N>(fe_mul<N>(P.Y, P.Z, M), M);
  return R;
}

// Jacobian P + affine (x2, y2), madd-2007-bl made complete by selects.
// The affine point must not be infinity (as in the reference kernel).
template <int N>
CTT_HD Jac<N> ec_madd(const Jac<N>& P, const Fe<N>& X2, const Fe<N>& Y2,
                      const Mod<N>& M) {
  const Fe<N> Z1Z1 = fe_sq<N>(P.Z, M);
  const Fe<N> U2 = fe_mul<N>(X2, Z1Z1, M);
  const Fe<N> S2 = fe_mul<N>(fe_mul<N>(Y2, P.Z, M), Z1Z1, M);
  const Fe<N> H = fe_sub<N>(U2, P.X, M);
  const Fe<N> HH = fe_sq<N>(H, M);
  const Fe<N> I = fe_dbl<N>(fe_dbl<N>(HH, M), M);
  const Fe<N> J = fe_mul<N>(H, I, M);
  const Fe<N> R = fe_dbl<N>(fe_sub<N>(S2, P.Y, M), M);
  const Fe<N> V = fe_mul<N>(P.X, I, M);
  const bool p_inf = fe_is_zero<N>(P.Z);
  const bool h0 = fe_is_zero<N>(H);
  const bool r0 = fe_is_zero<N>(R);
  if (p_inf) return Jac<N>{X2, Y2, fe_one<N>(M)};
  if (h0 && !r0) return jac_infinity<N>(M);
  if (h0 && r0) return ec_double<N>(P, M);
  Jac<N> O;
  O.X = fe_sub<N>(fe_sub<N>(fe_sq<N>(R, M), J, M), fe_dbl<N>(V, M), M);
  O.Y = fe_sub<N>(fe_mul<N>(R, fe_sub<N>(V, O.X, M), M),
                  fe_dbl<N>(fe_mul<N>(P.Y, J, M), M), M);
  O.Z = fe_sub<N>(fe_sub<N>(fe_sq<N>(fe_add<N>(P.Z, H, M), M), Z1Z1, M), HH, M);
  return O;
}

// Complete Jacobian P + Q (add-2007-bl made complete by selects).
template <int N>
CTT_HD Jac<N> ec_add(const Jac<N>& P, const Jac<N>& Q, const Mod<N>& M) {
  const bool p_inf = fe_is_zero<N>(P.Z);
  const bool q_inf = fe_is_zero<N>(Q.Z);
  // the reference applies the q_inf select last, so it wins over p_inf
  if (q_inf) return P;
  if (p_inf) return Q;
  const Fe<N> Z1Z1 = fe_sq<N>(P.Z, M);
  const Fe<N> Z2Z2 = fe_sq<N>(Q.Z, M);
  const Fe<N> U1 = fe_mul<N>(P.X, Z2Z2, M);
  const Fe<N> U2 = fe_mul<N>(Q.X, Z1Z1, M);
  const Fe<N> S1 = fe_mul<N>(fe_mul<N>(P.Y, Q.Z, M), Z2Z2, M);
  const Fe<N> S2 = fe_mul<N>(fe_mul<N>(Q.Y, P.Z, M), Z1Z1, M);
  const Fe<N> H = fe_sub<N>(U2, U1, M);
  const Fe<N> R = fe_dbl<N>(fe_sub<N>(S2, S1, M), M);
  const bool h0 = fe_is_zero<N>(H);
  const bool r0 = fe_is_zero<N>(R);
  if (h0 && !r0) return jac_infinity<N>(M);
  if (h0 && r0) return ec_double<N>(P, M);
  const Fe<N> I = fe_sq<N>(fe_dbl<N>(H, M), M);
  const Fe<N> J = fe_mul<N>(H, I, M);
  const Fe<N> V = fe_mul<N>(U1, I, M);
  Jac<N> O;
  O.X = fe_sub<N>(fe_sub<N>(fe_sq<N>(R, M), J, M), fe_dbl<N>(V, M), M);
  O.Y = fe_sub<N>(fe_mul<N>(R, fe_sub<N>(V, O.X, M), M),
                  fe_dbl<N>(fe_mul<N>(S1, J, M), M), M);
  O.Z = fe_mul<N>(fe_sub<N>(fe_sub<N>(fe_sq<N>(fe_add<N>(P.Z, Q.Z, M), M), Z1Z1, M),
                            Z2Z2, M), H, M);
  return O;
}

}  // namespace ctt
