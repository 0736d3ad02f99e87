// Field and point arithmetic shared by every kernel of the port (K2).
//
// Replaces constantine_tpu/ops/pallas_ec.py:_KF, the in-kernel library that
// the TPU kernels inline: Montgomery multiply, add/sub/double mod p, and the
// a = 0 Jacobian group law ec_double (dbl-2009-l), ec_madd (madd-2007-bl)
// and ec_add (add-2007-bl), with the same formulas and the same degenerate-
// case selects as the reference, so every output is limb-identical. Below
// them, the same group law in levels of independent products for a team of
// threads over the two-chain multiply fe_mul_eo: the scalar-multiplication
// ladder of ec_scalar_mul, the team add of ec_add, the team madd and lane
// walk of flush_scan, merge_scan's runs, bucket_reduce's lanes and the
// lanes of double_k and scaled_doubles.
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

#include <stddef.h>
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

// -- fe_mul_eo: the same product over two carry chains ---------------------
//
// The team group law below (the ladder, K3 add, K4) and the pairing
// programs' products (program.cuh) call it; every other kernel uses
// fe_mul. fe_mul's CIOS row is one chain of 4N dependent carry
// instructions. Here the row's products a[j] * b[i] are split by the
// parity of j (sppark's mont_t layout): the
// even j fill words (j, j+1) of an accumulator `ev` without overlapping,
// the odd j words (j-1, j) of `od`, which stands one word higher, so each
// half is a chain of N instructions independent of the other; the same
// for m * p. The value is ev + 2^32 od; dividing by 2^32 after a row swaps
// the two roles and shifts the old `ev` down two words inside the next
// row's odd chain. The bound p < 2^(32N-2) keeps every partial sum below
// 2^(32(N+1)), so `od` never carries out of its top word. Returns the
// canonical a * b * R^-1 mod p, the limbs of fe_mul.
//
// The carry flag: PTX's CC on the device (the asm is volatile, so the
// compiler keeps each chain in order), a variable on the host.
struct Cc {
  uint32_t c = 0;
};

CTT_HD uint32_t mad_lo_cc(Cc& f, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
  f.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CTT_HD uint32_t madc_lo_cc(Cc& f, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + f.c;
  f.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CTT_HD uint32_t madc_hi_cc(Cc& f, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + f.c;
  f.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CTT_HD uint32_t madc_hi(Cc& f, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + f.c);
#endif
}

CTT_HD uint32_t add_cc(Cc& f, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint64_t s = (uint64_t)a + b;
  f.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CTT_HD uint32_t addc_cc(Cc& f, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint64_t s = (uint64_t)a + b + f.c;
  f.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

CTT_HD uint32_t addc(Cc& f, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a + b + f.c;
#endif
}

// ev += m * p[even j], od += m * p[odd j], m clearing ev[0].
template <int N>
CTT_HD void eo_redc(Cc& f, uint32_t* ev, uint32_t* od, const Mod<N>& M) {
  const uint32_t m = ev[0] * M.m0;
  od[0] = mad_lo_cc(f, M.p[1], m, od[0]);
  od[1] = madc_hi_cc(f, M.p[1], m, od[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    od[j] = madc_lo_cc(f, M.p[j + 1], m, od[j]);
    od[j + 1] = madc_hi_cc(f, M.p[j + 1], m, od[j + 1]);
  }
  ev[0] = mad_lo_cc(f, M.p[0], m, ev[0]);
  ev[1] = madc_hi_cc(f, M.p[0], m, ev[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    ev[j] = madc_lo_cc(f, M.p[j], m, ev[j]);
    ev[j + 1] = madc_hi_cc(f, M.p[j], m, ev[j + 1]);
  }
  od[N - 1] = addc(f, od[N - 1], 0);
}

// One row after the first: ev is the last row's od, od its ev (ev[0] = 0).
template <int N>
CTT_HD void eo_row(Cc& f, uint32_t* ev, uint32_t* od, const uint32_t* a, uint32_t bi,
                   const Mod<N>& M) {
  ev[0] = add_cc(f, ev[0], od[1]);
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    od[j] = madc_lo_cc(f, a[j + 1], bi, od[j + 2]);
    od[j + 1] = madc_hi_cc(f, a[j + 1], bi, od[j + 3]);
  }
  od[N - 2] = madc_lo_cc(f, a[N - 1], bi, 0);
  od[N - 1] = madc_hi(f, a[N - 1], bi, 0);
  ev[0] = mad_lo_cc(f, a[0], bi, ev[0]);
  ev[1] = madc_hi_cc(f, a[0], bi, ev[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    ev[j] = madc_lo_cc(f, a[j], bi, ev[j]);
    ev[j + 1] = madc_hi_cc(f, a[j], bi, ev[j + 1]);
  }
  od[N - 1] = addc(f, od[N - 1], 0);
  eo_redc<N>(f, ev, od, M);
}

template <int N>
CTT_HD Fe<N> fe_mul_eo(const Fe<N>& a, const Fe<N>& b, const Mod<N>& M) {
  static_assert(N % 2 == 0, "the even/odd split takes an even limb count");
  uint32_t ev[N], od[N];
  Cc f;
  const uint32_t b0 = b.v[0];
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    ev[j] = a.v[j] * b0;
    ev[j + 1] = (uint32_t)(((uint64_t)a.v[j] * b0) >> 32);
    od[j] = a.v[j + 1] * b0;
    od[j + 1] = (uint32_t)(((uint64_t)a.v[j + 1] * b0) >> 32);
  }
  eo_redc<N>(f, ev, od, M);
#pragma unroll
  for (int i = 1; i < N; i += 2) {
    eo_row<N>(f, od, ev, a.v, b.v[i], M);
    if (i + 1 < N) eo_row<N>(f, ev, od, a.v, b.v[i + 1], M);
  }
  // the last row left its value in od + 2^32 ev with od[0] = 0
  Fe<N> r, d;
  r.v[0] = add_cc(f, ev[0], od[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r.v[j] = addc_cc(f, ev[j], od[j + 1]);
  r.v[N - 1] = addc(f, ev[N - 1], 0);
  // r < 2p: subtract p once if it fits
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
    const uint64_t x = (uint64_t)r.v[i] - M.p[i] - br;
    d.v[i] = (uint32_t)x;
    br = x >> 63;
  }
  borrow = (uint32_t)br;
#endif
  return fe_sel<N>(borrow == 0, d, r);
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


template <int N>
CTT_HD Jac<N> jac_sel(bool c, const Jac<N>& a, const Jac<N>& b) {
  return Jac<N>{fe_sel<N>(c, a.X, b.X), fe_sel<N>(c, a.Y, b.Y), fe_sel<N>(c, a.Z, b.Z)};
}

// -- [k]Q in one launch: the ladder's step for a team of threads per lane ---
//
// ec_scalar_mul (ec_kernels.cu) walks every bit of k with the accumulator
// on chip. A bit is ec_double of the accumulator, then ec_add of Q, then a
// branch-free select on the bit: the operations of ec_double and ec_add, so
// the Jacobian limbs equal the per-bit K3 loop's. One thread runs that as a
// chain of 23 dependent multiplies a bit. Here the bit's 21 products (the
// add's S1 = Y1 Z2^3 uses Q's Z^3, computed once a lane) fall into 7 levels
// of independent products, and a team of T threads computes a level's
// products side by side while every member repeats the cheap linear
// operations: at T = 4 the chain is 7 multiplies a bit.
//
// A team type has T, rank, sync() (wait for the team), put(p) (this
// member's product of the round, then sync), get(j) (product j < T of the
// round) and next().

// The team of one: ec_host.cpp's g++ build of the team code.
template <int N>
struct Solo {
  static constexpr int T = 1;
  int rank = 0;
  Fe<N> last;
  CTT_HD void sync() const {}
  CTT_HD void put(const Fe<N>& p) { last = p; }
  CTT_HD Fe<N> get(int) const { return last; }
  CTT_HD void next() {}
};

#if defined(__CUDACC__)
// The card's team: kT threads of one block. A team within a warp (kT
// divides 32) syncs with __syncwarp over its mask; a team of whole warps
// with the named barrier `bar` (1 + its index in the block). Two sets of T
// product slots in shared memory alternate between rounds, so one sync a
// round both publishes mul_level's products and keeps the next round's
// writes behind every member's reads of the last.
template <int N, int kT>
struct SmTeam {
  static constexpr int T = kT;
  uint32_t* slots;
  unsigned mask;
  int rank;
  int par = 0;
  int bar = 1;
  __device__ __forceinline__ void sync() const {
    if constexpr (kT <= 32)
      __syncwarp(mask);
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kT) : "memory");
  }
  __device__ __forceinline__ void put(const Fe<N>& p) {
    uint32_t* s = slots + (par * T + rank) * N;
#pragma unroll
    for (int l = 0; l < N; ++l) s[l] = p.v[l];
    sync();
  }
  __device__ __forceinline__ Fe<N> get(int j) const {
    const uint32_t* s = slots + (par * T + j) * N;
    Fe<N> r;
#pragma unroll
    for (int l = 0; l < N; ++l) r.v[l] = s[l];
    return r;
  }
  __device__ __forceinline__ void next() { par ^= 1; }
};
#endif

// out[i] = a[i] * b[i] for the K independent products of one level: member
// r computes products r, r + T, ... (a member without one repeats the
// round's first), and every member gets them all. A level of one product
// is computed by every member, with no exchange.
template <int N, int K, class Team>
CTT_HD void mul_level(Team& tm, const Fe<N> (&a)[K], const Fe<N> (&b)[K], Fe<N> (&out)[K],
                      const Mod<N>& M) {
  if constexpr (K == 1) {
    out[0] = fe_mul_eo<N>(a[0], b[0], M);
  } else {
#pragma unroll
    for (int r0 = 0; r0 < K; r0 += Team::T) {
      Fe<N> x = a[r0], y = b[r0];
#pragma unroll
      for (int j = 1; j < Team::T; ++j) {
        const int i = r0 + j < K ? r0 + j : r0;
        x = fe_sel<N>(tm.rank == j, a[i], x);
        y = fe_sel<N>(tm.rank == j, b[i], y);
      }
      tm.put(fe_mul_eo<N>(x, y, M));
#pragma unroll
      for (int j = 0; j < Team::T; ++j)
        if (r0 + j < K) out[r0 + j] = tm.get(j);
      tm.next();
    }
  }
}

// ec_double in 3 levels: X^2, Y^2, Y Z | B^2, (X + B)^2, E^2 | E (D - X3).
// E = 3A is known after level 1, so E^2 joins level 2; Y -> Y^2 -> (X + B)^2
// -> E (D - X3) is a chain of three products, the fewest dbl-2009-l allows.
template <int N, class Team>
CTT_HD Jac<N> ec_double_team(Team& tm, const Jac<N>& P, const Mod<N>& M) {
  Fe<N> l1[3], l2[3], l3[1];
  mul_level<N, 3>(tm, {P.X, P.Y, P.Y}, {P.X, P.Y, P.Z}, l1, M);
  const Fe<N> A = l1[0], B = l1[1];
  const Fe<N> xb = fe_add<N>(P.X, B, M);
  const Fe<N> E = fe_add<N>(fe_dbl<N>(A, M), A, M);
  mul_level<N, 3>(tm, {B, xb, E}, {B, xb, E}, l2, M);
  const Fe<N> C = l2[0];
  const Fe<N> D = fe_dbl<N>(fe_sub<N>(fe_sub<N>(l2[1], A, M), C, M), M);
  Jac<N> R;
  R.X = fe_sub<N>(l2[2], fe_dbl<N>(D, M), M);
  mul_level<N, 1>(tm, {E}, {fe_sub<N>(D, R.X, M)}, l3, M);
  R.Y = fe_sub<N>(l3[0], fe_dbl<N>(fe_dbl<N>(fe_dbl<N>(C, M), M), M), M);
  R.Z = fe_dbl<N>(l1[2], M);
  return R;
}

// One bit: D = ec_double(acc), S = ec_add(D, Q), returns bit ? S : D. Q2, Q3
// are Q.Z^2 and Q.Z^3. The double's levels and the add's interleave (Z1 =
// D.Z is known after level 1, X1 = D.X after 3, Y1 = D.Y after 4):
//   1  X^2, Y^2, Y Z
//   2  B^2, (X + B)^2, Z1^2, Y2 Z1
//   3  E^2, (Z1 + Z2)^2, U2 = X2 Z1^2, S2 = Y2 Z1 Z1^2
//   4  E (D - X3), U1 = X1 Z2^2
//   5  S1 = Y1 Z2^3, I = (2H)^2
//   6  R^2, J = H I, V = U1 I, Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
//   7  R (V - X3), S1 J
// The degenerate cases are ec_add's: Q at infinity gives D, D at infinity
// gives Q, D == -Q infinity, and D == Q the doubling of D, computed only
// when a lane takes it (the reference's pl.when); the team shares a lane,
// so it takes each branch together.
template <int N, class Team>
CTT_HD Jac<N> ladder_step(Team& tm, const Jac<N>& acc, const Jac<N>& Q, const Fe<N>& Q2,
                          const Fe<N>& Q3, bool bit, const Mod<N>& M) {
  Fe<N> l1[3], l2[4], l3[4], l4[2], l5[2], l6[4], l7[2];
  mul_level<N, 3>(tm, {acc.X, acc.Y, acc.Y}, {acc.X, acc.Y, acc.Z}, l1, M);
  const Fe<N> A = l1[0], B = l1[1];
  Jac<N> D;
  D.Z = fe_dbl<N>(l1[2], M);
  const Fe<N> xb = fe_add<N>(acc.X, B, M);
  const Fe<N> zz = fe_add<N>(D.Z, Q.Z, M);
  mul_level<N, 4>(tm, {B, xb, D.Z, Q.Y}, {B, xb, D.Z, D.Z}, l2, M);
  const Fe<N> C = l2[0], Z1Z1 = l2[2];
  const Fe<N> Dd = fe_dbl<N>(fe_sub<N>(fe_sub<N>(l2[1], A, M), C, M), M);
  const Fe<N> E = fe_add<N>(fe_dbl<N>(A, M), A, M);
  mul_level<N, 4>(tm, {E, zz, Q.X, l2[3]}, {E, zz, Z1Z1, Z1Z1}, l3, M);
  D.X = fe_sub<N>(l3[0], fe_dbl<N>(Dd, M), M);
  mul_level<N, 2>(tm, {E, D.X}, {fe_sub<N>(Dd, D.X, M), Q2}, l4, M);
  D.Y = fe_sub<N>(l4[0], fe_dbl<N>(fe_dbl<N>(fe_dbl<N>(C, M), M), M), M);
  const Fe<N> U1 = l4[1];
  const Fe<N> H = fe_sub<N>(l3[2], U1, M);
  const Fe<N> H2 = fe_dbl<N>(H, M);
  mul_level<N, 2>(tm, {D.Y, H2}, {Q3, H2}, l5, M);
  const Fe<N> S1 = l5[0], I = l5[1];
  const Fe<N> R = fe_dbl<N>(fe_sub<N>(l3[3], S1, M), M);
  const Fe<N> zh = fe_sub<N>(fe_sub<N>(l3[1], Z1Z1, M), Q2, M);
  mul_level<N, 4>(tm, {R, H, U1, zh}, {R, I, I, H}, l6, M);
  const Fe<N> J = l6[1], V = l6[2];
  Jac<N> S;
  S.X = fe_sub<N>(fe_sub<N>(l6[0], J, M), fe_dbl<N>(V, M), M);
  S.Z = l6[3];
  mul_level<N, 2>(tm, {R, S1}, {fe_sub<N>(V, S.X, M), J}, l7, M);
  S.Y = fe_sub<N>(l7[0], fe_dbl<N>(l7[1], M), M);
  const bool q_inf = fe_is_zero<N>(Q.Z), p_inf = fe_is_zero<N>(D.Z);
  const bool h0 = fe_is_zero<N>(H), r0 = fe_is_zero<N>(R);
  if (!q_inf && !p_inf && h0 && r0) S = ec_double_team<N>(tm, D, M);
  S = jac_sel<N>(h0 && !r0, jac_infinity<N>(M), S);
  S = jac_sel<N>(p_inf, Q, S);
  S = jac_sel<N>(q_inf, D, S);
  return jac_sel<N>(bit, S, D);
}

// [k]Q over nbits bits from the top: word w of the lane's canonical 32-bit
// scalar limbs is k[w * stride]. Constant-time in k: every bit doubles,
// adds and selects, and the loop count is the public nbits.
template <int N, class Team>
CTT_HD Jac<N> ec_scalar_mul(Team& tm, const uint32_t* k, size_t stride, int nbits,
                            const Jac<N>& Q, const Mod<N>& M) {
  const Fe<N> Q2 = fe_sq<N>(Q.Z, M);
  const Fe<N> Q3 = fe_mul<N>(Q.Z, Q2, M);
  Jac<N> acc = jac_infinity<N>(M);
  for (int b = nbits - 1; b >= 0; --b) {
    const bool bit = (k[(size_t)(b >> 5) * stride] >> (b & 31)) & 1u;
    acc = ladder_step<N>(tm, acc, Q, Q2, Q3, bit, M);
  }
  return acc;
}

// -- ec_add and ec_madd for a team --------------------------------------------
//
// One thread runs ec_add's 16 multiplies and ec_madd's 11 one after the
// other. Their products fall into 5 levels of independent ones; the order
// of independent products does not change a limb (every value is
// canonical), so these return ec_add's and ec_madd's limbs. The degenerate
// cases are theirs: the doubling (H = R = 0 with both operands finite) is
// computed only when the lane takes it, and the team, which shares the
// lane, takes it together; then the selects in the reference's order.

// ec_add in 5 levels (16 products; at T = 4 a level is one round):
//   1  Z1^2, Z2^2, Y1 Z2, Y2 Z1
//   2  U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2 Z2^2, S2 = Y2 Z1 Z1^2
//   3  I = (2H)^2, R^2, (Z1 + Z2)^2
//   4  J = H I, V = U1 I, Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
//   5  R (V - X3), S1 J
template <int N, class Team>
CTT_HD Jac<N> ec_add_team(Team& tm, const Jac<N>& P, const Jac<N>& Q, const Mod<N>& M) {
  Fe<N> l1[4], l2[4], l3[3], l4[3], l5[2];
  mul_level<N, 4>(tm, {P.Z, Q.Z, P.Y, Q.Y}, {P.Z, Q.Z, Q.Z, P.Z}, l1, M);
  const Fe<N> Z1Z1 = l1[0], Z2Z2 = l1[1];
  mul_level<N, 4>(tm, {P.X, Q.X, l1[2], l1[3]}, {Z2Z2, Z1Z1, Z2Z2, Z1Z1}, l2, M);
  const Fe<N> U1 = l2[0], S1 = l2[2];
  const Fe<N> H = fe_sub<N>(l2[1], U1, M);
  const Fe<N> R = fe_dbl<N>(fe_sub<N>(l2[3], S1, M), M);
  const Fe<N> H2 = fe_dbl<N>(H, M), zz = fe_add<N>(P.Z, Q.Z, M);
  mul_level<N, 3>(tm, {H2, R, zz}, {H2, R, zz}, l3, M);
  const Fe<N> zh = fe_sub<N>(fe_sub<N>(l3[2], Z1Z1, M), Z2Z2, M);
  mul_level<N, 3>(tm, {H, U1, zh}, {l3[0], l3[0], H}, l4, M);
  const Fe<N> J = l4[0], V = l4[1];
  Jac<N> O;
  O.X = fe_sub<N>(fe_sub<N>(l3[1], J, M), fe_dbl<N>(V, M), M);
  mul_level<N, 2>(tm, {R, S1}, {fe_sub<N>(V, O.X, M), J}, l5, M);
  O.Y = fe_sub<N>(l5[0], fe_dbl<N>(l5[1], M), M);
  O.Z = l4[2];
  const bool p_inf = fe_is_zero<N>(P.Z), q_inf = fe_is_zero<N>(Q.Z);
  const bool h0 = fe_is_zero<N>(H), r0 = fe_is_zero<N>(R);
  if (!p_inf && !q_inf && h0 && r0) O = ec_double_team<N>(tm, P, M);
  O = jac_sel<N>(h0 && !r0, jac_infinity<N>(M), O);
  O = jac_sel<N>(p_inf, Q, O);
  return jac_sel<N>(q_inf, P, O);
}

// ec_madd in 5 levels (11 products; at T = 4 a level is one round, at T = 2
// level 3 takes two):
//   1  Z1^2, Y2 Z1
//   2  U2 = X2 Z1^2, S2 = Y2 Z1 Z1^2
//   3  H^2, R^2, (Z1 + H)^2
//   4  J = H I, V = X1 I
//   5  R (V - X3), Y1 J
template <int N, class Team>
CTT_HD Jac<N> ec_madd_team(Team& tm, const Jac<N>& P, const Fe<N>& X2, const Fe<N>& Y2,
                           const Mod<N>& M) {
  Fe<N> l1[2], l2[2], l3[3], l4[2], l5[2];
  mul_level<N, 2>(tm, {P.Z, Y2}, {P.Z, P.Z}, l1, M);
  const Fe<N> Z1Z1 = l1[0];
  mul_level<N, 2>(tm, {X2, l1[1]}, {Z1Z1, Z1Z1}, l2, M);
  const Fe<N> H = fe_sub<N>(l2[0], P.X, M);
  const Fe<N> R = fe_dbl<N>(fe_sub<N>(l2[1], P.Y, M), M);
  const Fe<N> zh = fe_add<N>(P.Z, H, M);
  mul_level<N, 3>(tm, {H, R, zh}, {H, R, zh}, l3, M);
  const Fe<N> HH = l3[0];
  const Fe<N> I = fe_dbl<N>(fe_dbl<N>(HH, M), M);
  mul_level<N, 2>(tm, {H, P.X}, {I, I}, l4, M);
  const Fe<N> J = l4[0], V = l4[1];
  Jac<N> O;
  O.X = fe_sub<N>(fe_sub<N>(l3[1], J, M), fe_dbl<N>(V, M), M);
  mul_level<N, 2>(tm, {R, P.Y}, {fe_sub<N>(V, O.X, M), J}, l5, M);
  O.Y = fe_sub<N>(l5[0], fe_dbl<N>(l5[1], M), M);
  O.Z = fe_sub<N>(fe_sub<N>(l3[2], Z1Z1, M), HH, M);
  const bool p_inf = fe_is_zero<N>(P.Z);
  const bool h0 = fe_is_zero<N>(H), r0 = fe_is_zero<N>(R);
  if (!p_inf && h0 && r0) O = ec_double_team<N>(tm, P, M);
  O = jac_sel<N>(h0 && !r0, jac_infinity<N>(M), O);
  return jac_sel<N>(p_inf, Jac<N>{X2, Y2, fe_one<N>(M)}, O);
}

// Word l of a planar column: base[l * stride].
template <int N>
CTT_HD Fe<N> load_col(const uint32_t* base, size_t stride) {
  Fe<N> r;
#pragma unroll
  for (int l = 0; l < N; ++l) r.v[l] = base[l * stride];
  return r;
}

// Stores P's 3N words at base[l * stride] of ox, oy, oz, word w (X's limbs,
// then Y's, then Z's) by member w mod T.
template <int N, class Team>
CTT_HD void store_split(const Team& tm, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                        size_t stride, const Jac<N>& P) {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (l % Team::T == tm.rank) ox[l * stride] = P.X.v[l];
    if ((N + l) % Team::T == tm.rank) oy[l * stride] = P.Y.v[l];
    if ((2 * N + l) % Team::T == tm.rank) oz[l * stride] = P.Z.v[l];
  }
}

// -- double_k's lane (K3 double) and scaled_doubles' lane (K7) -------------------
//
// Lane i of the planar (N, n) point columns x, y, z becomes 2^k P_i: k
// doublings over ec_double_team, one after the other (each needs the last)
// with P in registers between them, then the team's members split the
// store. Infinity (Z = 0) stays infinity and Y = 0 becomes it, as in
// ec_double, whose limbs every doubling gives; k = 0 is a copy.
template <int N, class Team>
CTT_HD void double_k_lane(Team& tm, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                          uint32_t* ox, uint32_t* oy, uint32_t* oz, int n, int k, int i,
                          const Mod<N>& M) {
  const size_t sn = (size_t)n;
  Jac<N> P{load_col<N>(x + i, sn), load_col<N>(y + i, sn), load_col<N>(z + i, sn)};
  for (int s = 0; s < k; ++s) P = ec_double_team<N>(tm, P, M);
  store_split<N>(tm, ox + i, oy + i, oz + i, sn, P);
}

// K7: lane w of (N, W) becomes 2^(c w) P_w; lane 0 (and c = 0) is a copy.
template <int N, class Team>
CTT_HD void scaled_doubles_lane(Team& tm, const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                int W, int c, int w, const Mod<N>& M) {
  double_k_lane<N>(tm, x, y, z, ox, oy, oz, W, c * w, w, M);
}

// -- flush_scan's lane ---------------------------------------------------------
//
// The stream is planar: keys (K, nl), entries xy (K, 2N, nl) (x limbs, then
// y limbs), outputs (K, N, nl) each. Lane m sweeps keys[0..K, m], and slot
// (k, m) holds its accumulator after entry k: madd(acc, entry) while the
// key stays, a restart at (x, y, 1) when it changes (the reference's
// kf.sel(same, g, X2/Y2/one)). The team walks the lane's K >= 1 steps. A
// restart feeds the madd infinity, whose select gives (x, y, 1), so the
// team's warp stays converged; the next entry is loaded a step ahead, since
// it does not depend on the accumulator.
template <int N, class Team>
CTT_HD void flush_lane(Team& tm, const int32_t* keys, const uint32_t* xy, uint32_t* ex,
                       uint32_t* ey, uint32_t* ez, int K, int nl, int m, const Mod<N>& M) {
  const size_t snl = (size_t)nl;
  Jac<N> acc = jac_infinity<N>(M);
  int key = keys[m];
  Fe<N> X2 = load_col<N>(xy + m, snl), Y2 = load_col<N>(xy + N * snl + m, snl);
  bool restart = true;
  for (int k = 0;; ++k) {
    const int kn = k + 1 < K ? k + 1 : k;
    const int nkey = keys[kn * snl + m];
    const uint32_t* en = xy + kn * 2 * N * snl + m;
    const Fe<N> nX = load_col<N>(en, snl), nY = load_col<N>(en + N * snl, snl);
    acc = ec_madd_team<N>(tm, jac_sel<N>(restart, jac_infinity<N>(M), acc), X2, Y2, M);
    const size_t o = k * N * snl + m;
    store_split<N>(tm, ex + o, ey + o, ez + o, snl, acc);
    restart = nkey != key;
    if (k + 1 >= K) break;
    key = nkey;
    X2 = nX;
    Y2 = nY;
  }
}

// -- bucket_reduce's lane (K6) ---------------------------------------------------
//
// ec_add's result where it needs no product: Q at infinity gives P, P at
// infinity gives Q (ec_add's selects, in its order); else ec_add_team.
template <int N, class Team>
CTT_HD Jac<N> ec_add_sel_team(Team& tm, const Jac<N>& P, const Jac<N>& Q, const Mod<N>& M) {
  if (fe_is_zero<N>(Q.Z)) return P;
  if (fe_is_zero<N>(P.Z)) return Q;
  return ec_add_team<N>(tm, P, Q, M);
}

// The buckets are planar, B (T, N, nl) x 3; lane c's run = sum_t B[t] and
// wsum = sum_t (T-1-t) B[t] go to r and w (N, nl) x 3. The reference's loop
// from infinity: at step t, wsum <- wsum + run, then run <- run + B[t]. The
// step's two adds read only the old run, so two teams of a lane run them side
// by side: role 0 carries wsum, role 1 run (loading the next bucket a step
// ahead). After every step but the last, role 1's members hand the new run to
// role 0 through `hand` (two sets of 3N words, by the step's parity: one
// barrier of both teams a step, pair_sync(), publishes the run and keeps the
// next write behind the last read). Both roles call the add at one place, so
// a warp's teams add together; an add with an operand at infinity is a select
// (the first step's two, and empty buckets'), a branch that depends only on
// which values are infinity, the same for a team's members; the doubling (P
// == Q, both finite) stays inside ec_add_team. Every product is canonical, so
// run and wsum keep the loop's Jacobian limbs.
template <int N, class Team, class Sync>
CTT_HD void bucket_lane(Team& tm, int role, uint32_t* hand, Sync&& pair_sync, const uint32_t* bx,
                        const uint32_t* by, const uint32_t* bz, uint32_t* rx, uint32_t* ry,
                        uint32_t* rz, uint32_t* wx, uint32_t* wy, uint32_t* wz, int T, int nl,
                        int c, const Mod<N>& M) {
  const size_t snl = (size_t)nl;
  auto bucket = [&](int t) {
    const size_t o = (size_t)t * N * snl + c;
    return Jac<N>{load_col<N>(bx + o, snl), load_col<N>(by + o, snl), load_col<N>(bz + o, snl)};
  };
  Jac<N> acc = jac_infinity<N>(M);
  Jac<N> Q = role ? bucket(0) : acc;
  for (int t = 0;; ++t) {
    const Jac<N> Qn = role && t + 1 < T ? bucket(t + 1) : Q;
    acc = ec_add_sel_team<N>(tm, acc, Q, M);
    if (t + 1 >= T) break;
    uint32_t* h = hand + (t & 1) * 3 * N;
    if (role) store_split<N>(tm, h, h + N, h + 2 * N, 1, acc);
    pair_sync();
    Q = role ? Qn : Jac<N>{load_col<N>(h, 1), load_col<N>(h + N, 1), load_col<N>(h + 2 * N, 1)};
  }
  if (role)
    store_split<N>(tm, rx + c, ry + c, rz + c, snl, acc);
  else
    store_split<N>(tm, wx + c, wy + c, wz + c, snl, acc);
}

// -- merge_scan's runs ----------------------------------------------------------
//
// The stream is planar: keys (K, nl), entries qx, qy, qz (K, N, nl) each
// (Jacobian partial sums), outputs the same. Lane m's scan starts from
// infinity under key -1; at each slot Q' is the entry with its Z zeroed
// where key <= 0, and acc becomes ec_add(acc, Q') where the key equals the
// last one, else Q'. Every slot holds its post-step acc.
//
// A team owns the runs of equal keys that start in slots [k0, k1) of lane m
// and carries each to its end, past k1 if need be; the slots before the
// first of them belong to a run that started earlier, and its team writes
// them. The team computes products only where they change the result:
//   - a restart is Q' (a select);
//   - under a key <= 0, Q' is at infinity, so every add returns acc: the
//     whole run is its first slot (or infinity, for a run of key -1 at
//     slot 0, which the scan adds into its starting infinity), and its
//     entries are never loaded;
//   - an add of an entry at infinity returns acc, an add into acc at
//     infinity returns the entry (ec_add's own selects).
// What is left is ec_add_team, at one place in the loop, so the teams of a
// warp that add at the same step of their runs add together. Each branch
// depends only on the keys and on which partial sums are infinity, the
// same for every member of the team, and every slot gets the limbs of the
// sequential scan (the reference kernel runs the add and selects at every
// slot, branch-free).
template <int N, class Team>
CTT_HD void merge_runs(Team& tm, const int32_t* keys, const uint32_t* qx, const uint32_t* qy,
                       const uint32_t* qz, uint32_t* ex, uint32_t* ey, uint32_t* ez, int K,
                       int nl, int m, int k0, int k1, const Mod<N>& M) {
  const size_t snl = (size_t)nl;
  int s = k0;
  if (k0 > 0) {
    const int before = keys[(k0 - 1) * snl + m];
    while (s < k1 && keys[s * snl + m] == before) ++s;
  }
  if (s >= k1) return;
  Jac<N> acc = jac_infinity<N>(M);
  int key = s == 0 ? -1 : keys[(s - 1) * snl + m];
  int kk = keys[s * snl + m];
  for (int k = s;; ++k) {
    const bool restart = kk != key;
    const int kn = k + 1 < K ? keys[(k + 1) * snl + m] : 0;
    const size_t o = k * N * snl + m;
    if (restart || kk > 0) {
      Jac<N> Q{load_col<N>(qx + o, snl), load_col<N>(qy + o, snl), fe_zero<N>()};
      if (kk > 0) Q.Z = load_col<N>(qz + o, snl);
      const bool add = !restart && !fe_is_zero<N>(Q.Z) && !fe_is_zero<N>(acc.Z);
      if (add)
        acc = ec_add_team<N>(tm, acc, Q, M);
      else if (restart || !fe_is_zero<N>(Q.Z))
        acc = Q;
    }
    store_split<N>(tm, ex + o, ey + o, ez + o, snl, acc);
    if (k + 1 >= K || (kn != kk && k + 1 >= k1)) break;
    key = kk;
    kk = kn;
  }
}

}  // namespace ctt
