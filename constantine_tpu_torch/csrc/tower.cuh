// Fp helpers of the kernels K11-K13, and Fp2, Fp6 and Fp12 over BLS12-381
// Fp as formulas that build the pairing kernels' programs (program.cuh).
//
// The tower replaces the kernel-side tower of
// constantine_tpu/ops/pallas_pairing.py (f2*/f6*/f12* over _CKF), with the
// same formulas, so every value is limb-identical to the port's plain
// towers (ops/towers.py) and to the JAX package's:
//   Fp2  = Fp[u]/(u^2 + 1)            (c0, c1)
//   Fp6  = Fp2[v]/(v^3 - xi), xi = 1+u (c0, c1, c2)
//   Fp12 = Fp6[w]/(w^2 - v)           (c0, c1); the six Fp2 coefficients in
//   memory order have w-degrees 0, 2, 4, 1, 3, 5.
// An Fp12 in memory is 12 Fp elements of 12 limbs, in that order.
//
// On the card no tower function runs: SymTower runs on the host over node
// ids of a Builder, and what it records -- each Fp product, each sum -- is
// what a team computes in rounds. The formulas are the one-thread ones
// (Karatsuba Fp2/Fp6/Fp12 products, Chung-Hasan squaring, Granger-Scott
// cyclotomic squaring, the M-twist sparse line product, inverses through
// the norms), so the program's Fp elements equal theirs.
#pragma once

#include "program.cuh"

namespace ctt {

// -- Fp extras (K13 and the kernels' loads) --------------------------------------

CTT_HD Fp fp_neg(const Fp& a, const MdP& M) { return fe_sub<FPN>(fe_zero<FPN>(), a, M); }

CTT_HD bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FPN; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// x^e, most significant bit first (acc starts at x: the top bit is 1).
CTT_HD Fp fp_pow(const Fp& x, const FpExp& e, const MdP& M) {
  Fp acc = x;
  for (int b = e.nbits - 2; b >= 0; --b) {
    acc = fe_sq<FPN>(acc, M);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) acc = fe_mul<FPN>(acc, x, M);
  }
  return acc;
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

// -- the tower over a Builder's nodes ---------------------------------------------

struct S2 {
  int c0, c1;
};
struct S6 {
  S2 c0, c1, c2;
};
struct S12 {
  S6 c0, c1;
};

// Coefficient k (0..11) of an Fp12 in memory order.
inline int& s12at(S12& f, int k) {
  S6& h = k < 6 ? f.c0 : f.c1;
  const int j = k % 6;
  S2& e = j < 2 ? h.c0 : (j < 4 ? h.c1 : h.c2);
  return (j & 1) ? e.c1 : e.c0;
}

struct SymTower {
  Builder& b;

  // Fp2
  S2 f2add(const S2& x, const S2& y) { return {b.add(x.c0, y.c0), b.add(x.c1, y.c1)}; }
  S2 f2sub(const S2& x, const S2& y) { return {b.sub(x.c0, y.c0), b.sub(x.c1, y.c1)}; }
  S2 f2neg(const S2& x) { return {b.neg(x.c0), b.neg(x.c1)}; }
  S2 f2scale(const S2& x, int c) { return {b.scale(x.c0, c), b.scale(x.c1, c)}; }
  S2 f2conj(const S2& x) { return {x.c0, b.neg(x.c1)}; }
  S2 f2half(const S2& x) { return {b.half(x.c0), b.half(x.c1)}; }
  S2 f2zero() { return {b.zero(), b.zero()}; }
  S2 f2one() { return {b.one, b.zero()}; }

  // Karatsuba over u^2 = -1: 3 multiplies.
  S2 f2mul(const S2& x, const S2& y) {
    const int v0 = b.mul(x.c0, y.c0);
    const int v1 = b.mul(x.c1, y.c1);
    const int t = b.mul(b.add(x.c0, x.c1), b.add(y.c0, y.c1));
    return {b.sub(v0, v1), b.sub(b.sub(t, v0), v1)};
  }

  // Complex squaring: 2 multiplies.
  S2 f2sq(const S2& x) {
    const int t = b.mul(x.c0, x.c1);
    return {b.mul(b.add(x.c0, x.c1), b.sub(x.c0, x.c1)), b.add(t, t)};
  }

  // xi * a, xi = 1 + u.
  S2 f2xi(const S2& x) { return {b.sub(x.c0, x.c1), b.add(x.c0, x.c1)}; }

  S2 f2mul_fp(const S2& x, int s) { return {b.mul(x.c0, s), b.mul(x.c1, s)}; }

  // 1/a through the norm a0^2 + a1^2 (u^2 = -1) and the inverse over Fp.
  S2 f2inv(const S2& x) {
    const int ninv = b.inv(b.add(b.mul(x.c0, x.c0), b.mul(x.c1, x.c1)));
    return {b.mul(x.c0, ninv), b.neg(b.mul(x.c1, ninv))};
  }

  // Fp6
  S6 f6add(const S6& x, const S6& y) {
    return {f2add(x.c0, y.c0), f2add(x.c1, y.c1), f2add(x.c2, y.c2)};
  }
  S6 f6sub(const S6& x, const S6& y) {
    return {f2sub(x.c0, y.c0), f2sub(x.c1, y.c1), f2sub(x.c2, y.c2)};
  }
  S6 f6neg(const S6& x) { return {f2neg(x.c0), f2neg(x.c1), f2neg(x.c2)}; }
  // v * a = (xi a2, a0, a1).
  S6 f6mul_v(const S6& x) { return {f2xi(x.c2), x.c0, x.c1}; }

  // Karatsuba cubic: 6 Fp2 multiplies.
  S6 f6mul(const S6& x, const S6& y) {
    const S2 v0 = f2mul(x.c0, y.c0);
    const S2 v1 = f2mul(x.c1, y.c1);
    const S2 v2 = f2mul(x.c2, y.c2);
    const S2 m12 = f2mul(f2add(x.c1, x.c2), f2add(y.c1, y.c2));
    const S2 m01 = f2mul(f2add(x.c0, x.c1), f2add(y.c0, y.c1));
    const S2 m02 = f2mul(f2add(x.c0, x.c2), f2add(y.c0, y.c2));
    const S2 t0 = f2sub(f2sub(m12, v1), v2);
    const S2 t1 = f2sub(f2sub(m01, v0), v1);
    const S2 t2 = f2sub(f2sub(m02, v0), v2);
    return {f2add(v0, f2xi(t0)), f2add(t1, f2xi(v2)), f2add(t2, v1)};
  }

  // Chung-Hasan SQR2.
  S6 f6sq(const S6& x) {
    const S2 t = f2sub(f2add(x.c0, x.c2), x.c1);
    const S2 s0 = f2sq(x.c0);
    const S2 ab = f2mul(x.c0, x.c1);
    const S2 s2 = f2sq(t);
    const S2 bc = f2mul(x.c1, x.c2);
    const S2 s4 = f2sq(x.c2);
    const S2 s1 = f2scale(ab, 2);
    const S2 s3 = f2scale(bc, 2);
    return {f2add(s0, f2xi(s3)), f2add(s1, f2xi(s4)),
            f2sub(f2sub(f2add(f2add(s1, s2), s3), s0), s4)};
  }

  // a * (b1 v + b2 v^2): c0 = xi (a1 b2 + a2 b1), c1 = a0 b1 + xi a2 b2,
  // c2 = a0 b2 + a1 b1.
  S6 f6mul_sparse12(const S6& x, const S2& b1, const S2& b2) {
    const S2 p01 = f2mul(x.c0, b1), p02 = f2mul(x.c0, b2);
    const S2 p11 = f2mul(x.c1, b1), p12 = f2mul(x.c1, b2);
    const S2 p21 = f2mul(x.c2, b1), p22 = f2mul(x.c2, b2);
    return {f2xi(f2add(p12, p21)), f2add(p01, f2xi(p22)), f2add(p02, p11)};
  }

  S6 f6mul_fp2(const S6& x, const S2& s) {
    return {f2mul(x.c0, s), f2mul(x.c1, s), f2mul(x.c2, s)};
  }

  S6 f6inv(const S6& x) {
    const S2 v0 = f2sub(f2sq(x.c0), f2xi(f2mul(x.c1, x.c2)));
    const S2 v1 = f2sub(f2xi(f2sq(x.c2)), f2mul(x.c0, x.c1));
    const S2 v2 = f2sub(f2sq(x.c1), f2mul(x.c0, x.c2));
    const S2 fv = f2add(f2mul(x.c0, v0), f2xi(f2add(f2mul(x.c2, v1), f2mul(x.c1, v2))));
    const S2 finv = f2inv(fv);
    return {f2mul(v0, finv), f2mul(v1, finv), f2mul(v2, finv)};
  }

  // Fp12
  S12 f12one() { return {{f2one(), f2zero(), f2zero()}, {f2zero(), f2zero(), f2zero()}}; }
  S12 f12conj(const S12& x) { return {x.c0, f6neg(x.c1)}; }

  // Karatsuba quadratic: 3 Fp6 multiplies.
  S12 f12mul(const S12& x, const S12& y) {
    const S6 v0 = f6mul(x.c0, y.c0);
    const S6 v1 = f6mul(x.c1, y.c1);
    const S6 t = f6mul(f6add(x.c0, x.c1), f6add(y.c0, y.c1));
    return {f6add(v0, f6mul_v(v1)), f6sub(f6sub(t, v0), v1)};
  }

  // c1 = 2 a0 a1; c0 = (a0 + a1)(a0 + v a1) - t - v t, t = a0 a1.
  S12 f12sq(const S12& x) {
    const S6 t = f6mul(x.c0, x.c1);
    const S6 u = f6mul(f6add(x.c0, x.c1), f6add(x.c0, f6mul_v(x.c1)));
    return {f6sub(f6sub(u, t), f6mul_v(t)), f6add(t, t)};
  }

  // f * line for the M-twist line (lA, 0, 0) + (0, lC, lB) w: 15 Fp2 multiplies.
  S12 f12sparse_line(const S12& f, const S2& lA, const S2& lC, const S2& lB) {
    const S6 v0 = f6mul_fp2(f.c0, lA);
    const S6 v1 = f6mul_sparse12(f.c1, lC, lB);
    const S6 t = f6mul(f6add(f.c0, f.c1), S6{lA, lC, lB});
    return {f6add(v0, f6mul_v(v1)), f6sub(f6sub(t, v0), v1)};
  }

  // Granger-Scott cyclotomic squaring (unitary input): three Fp4 squarings.
  void sq4(const S2& x, const S2& y, S2& c0, S2& c1) {
    const S2 xx = f2sq(x);
    const S2 yy = f2sq(y);
    c0 = f2add(xx, f2xi(yy));
    c1 = f2sub(f2sub(f2sq(f2add(x, y)), xx), yy);
  }
  S2 m32(const S2& v, const S2& x) { return f2add(f2scale(f2sub(v, x), 2), v); }  // 3v - 2b
  S2 p32(const S2& v, const S2& x) { return f2add(f2scale(f2add(v, x), 2), v); }  // 3v + 2b

  S12 f12cyc_sq(const S12& a) {
    S2 v00, v01, v10, v11, v20, v21;
    sq4(a.c0.c0, a.c1.c1, v00, v01);
    sq4(a.c1.c0, a.c0.c2, v10, v11);
    sq4(a.c0.c1, a.c1.c2, v20, v21);
    return {{m32(v00, a.c0.c0), m32(v10, a.c0.c1), m32(v20, a.c0.c2)},
            {p32(f2xi(v21), a.c1.c0), p32(v01, a.c1.c1), p32(v11, a.c1.c2)}};
  }

  // f^(p^k): conjugate every Fp2 coefficient for odd k, then multiply
  // coefficient j by gamma[j] (gamma[0] == 1 is skipped).
  S12 f12frob(const S12& a, const S2* gamma, bool odd) {
    S2 c[6] = {a.c0.c0, a.c0.c1, a.c0.c2, a.c1.c0, a.c1.c1, a.c1.c2};
    for (int k = 0; k < 6; ++k) {
      if (odd) c[k] = f2conj(c[k]);
      if (k > 0) c[k] = f2mul(c[k], gamma[k]);
    }
    return {{c[0], c[1], c[2]}, {c[3], c[4], c[5]}};
  }

  // 1/a through the norms down to Fp: a0^2 - v a1^2 in Fp6, then Fp2, then Fp.
  S12 f12inv(const S12& a) {
    const S6 d = f6sub(f6sq(a.c0), f6mul_v(f6sq(a.c1)));
    const S6 dinv = f6inv(d);
    return {f6mul(a.c0, dinv), f6neg(f6mul(a.c1, dinv))};
  }
};

}  // namespace ctt
