// One lane of the BLS12-381 optimal-ate pairing: the Miller loop (K11) and
// the final exponentiation (K12), over tower.cuh.
//
// Replaces the kernel bodies of constantine_tpu/ops/pallas_pairing.py:
// _miller_fn (the fused double/add steps and sparse line products,
// _dbl_step/_add_step/_emit_line/f12sparse_line) and _final_exp_fn (easy
// part with the Fp12 inverse by Fermat on the norm, then the hard part).
// The TPU runs the hard part as a microcode interpreter over a host-built
// program (_build_hard_program); here it is straight-line code with a loop
// per pow-x chain, computing the same (x-1)^2 (x+p) (x^2+p^2-1) + 3
// decomposition. G2 is in homogeneous projective coordinates on the
// M-twist; lines are scaled as in the reference, so the Miller value is
// limb-identical to the plain version in ops/pairing.py (it is not
// canonical: other line scalings give values that differ by factors the
// final exponentiation kills).
#pragma once

#include "tower.cuh"

namespace ctt {

// Constants of the pairing, passed to the kernels by value.
struct PairingConsts {
  MdP md;
  Fp2 gamma1[6];   // Frobenius p: xi^(j (p-1)/6), coefficient order
  Fp2 gamma2[6];   // Frobenius p^2
  FpExp pm2;       // p - 2 (Fermat inverse)
  uint32_t x_lo, x_hi;  // |x|
  int x_bits;      // bit length of |x|
  int x_neg;       // x < 0: conjugate the Miller value and each pow-x
};

// Projective doubling of T and the tangent line's (sA, sB, sC):
// sA = 2YZ^2, sB = -3X^2 Z, sC = 3X^3 - 2Y^2 Z.
CTT_NOINL void dbl_step(Fp2& X, Fp2& Y, Fp2& Z, Fp2& sA, Fp2& sB, Fp2& sC, const Fp2& b2,
                        const MdP& M) {
  const Fp2 B = f2sq(Y, M);
  const Fp2 C = f2sq(Z, M);
  const Fp2 E = f2triple(f2mul(b2, C, M), M);             // 3 b' Z^2
  const Fp2 F3 = f2triple(E, M);
  const Fp2 A = f2div2(f2mul(X, Y, M), M);                 // XY/2
  const Fp2 G = f2div2(f2add(B, F3, M), M);                // (B + 3E)/2
  const Fp2 H = f2sub(f2sub(f2sq(f2add(Y, Z, M), M), B, M), C, M);  // 2YZ
  const Fp2 XX = f2sq(X, M);
  const Fp2 XX3 = f2triple(XX, M);
  sA = f2mul(H, Z, M);
  sC = f2sub(f2mul(XX3, X, M), f2mul(f2dbl(B, M), Z, M), M);
  sB = f2neg(f2mul(XX3, Z, M), M);
  const Fp2 X3 = f2mul(A, f2sub(B, F3, M), M);
  const Fp2 Y3 = f2sub(f2sq(G, M), f2triple(f2sq(E, M), M), M);
  Z = f2mul(B, H, M);
  X = X3;
  Y = Y3;
}

// Mixed addition T + Q (Q affine) and the chord line:
// theta = Y - yQ Z, lam = X - xQ Z; sA = lam, sB = -theta,
// sC = theta xQ - lam yQ.
CTT_NOINL void add_step(Fp2& X, Fp2& Y, Fp2& Z, Fp2& sA, Fp2& sB, Fp2& sC, const Fp2& xQ,
                        const Fp2& yQ, const MdP& M) {
  const Fp2 theta = f2sub(Y, f2mul(yQ, Z, M), M);
  const Fp2 lam = f2sub(X, f2mul(xQ, Z, M), M);
  const Fp2 t2 = f2sq(theta, M);
  const Fp2 l2 = f2sq(lam, M);
  const Fp2 l3c = f2mul(l2, lam, M);
  const Fp2 l2X = f2mul(l2, X, M);
  const Fp2 H = f2add(f2sub(f2mul(t2, Z, M), f2dbl(l2X, M), M), l3c, M);
  const Fp2 X3 = f2mul(lam, H, M);
  const Fp2 Y3 = f2sub(f2mul(theta, f2sub(l2X, H, M), M), f2mul(Y, l3c, M), M);
  Z = f2mul(l3c, Z, M);
  X = X3;
  Y = Y3;
  sA = lam;
  sC = f2sub(f2mul(theta, xQ, M), f2mul(lam, yQ, M), M);
  sB = f2neg(theta, M);
}

// f * line(P) for the M-twist: lA = yP xi sA, lB = xP sB, lC = sC.
CTT_HD Fp12 mul_line(const Fp12& f, const Fp2& sA, const Fp2& sB, const Fp2& sC,
                     const Fp& xP, const Fp& yP, const MdP& M) {
  return f12sparse_line(f, f2mul_fp(f2xi(sA, M), yP, M), sC, f2mul_fp(sB, xP, M), M);
}

// f_{|x|,Q}(P), conjugated for x < 0: one doubling step per bit of |x|
// after the leading one, and an addition step where the bit is set.
CTT_HD Fp12 miller_loop_lane(const Fp& xP, const Fp& yP, const Fp2& xQ, const Fp2& yQ,
                             const PairingConsts& C) {
  const MdP& M = C.md;
  const Fp one = fe_one<FPN>(M);
  const Fp four = fe_add<FPN>(fe_add<FPN>(one, one, M), fe_add<FPN>(one, one, M), M);
  const Fp2 b2{four, four};                                // b' = 4(1 + u)
  const uint64_t x = ((uint64_t)C.x_hi << 32) | C.x_lo;
  Fp12 f = f12one(M);
  Fp2 X = xQ, Y = yQ, Z = f2one(M);
  Fp2 sA, sB, sC;
  for (int i = C.x_bits - 2; i >= 0; --i) {
    f = f12sq(f, M);
    dbl_step(X, Y, Z, sA, sB, sC, b2, M);
    f = mul_line(f, sA, sB, sC, xP, yP, M);
    if ((x >> i) & 1u) {
      add_step(X, Y, Z, sA, sB, sC, xQ, yQ, M);
      f = mul_line(f, sA, sB, sC, xP, yP, M);
    }
  }
  return C.x_neg ? f12conj(f, M) : f;
}

// f^x in the cyclotomic subgroup: cyclotomic squarings over the bits of
// |x| after the leading one, conjugated for x < 0.
CTT_HD Fp12 pow_x(const Fp12& f, const PairingConsts& C) {
  const MdP& M = C.md;
  const uint64_t x = ((uint64_t)C.x_hi << 32) | C.x_lo;
  Fp12 acc = f;
  for (int i = C.x_bits - 2; i >= 0; --i) {
    acc = f12cyc_sq(acc, M);
    if ((x >> i) & 1u) acc = f12mul(acc, f, M);
  }
  return C.x_neg ? f12conj(acc, M) : acc;
}

// f^(3 (p^12 - 1)/r): the easy part f^((p^6 - 1)(p^2 + 1)), then the hard
// part as (x-1)^2 (x+p) (x^2+p^2-1) + 3 (asserted in ops/pairing.py).
CTT_HD Fp12 final_exp_lane(const Fp12& f, const PairingConsts& C) {
  const MdP& M = C.md;
  Fp12 g = f12mul(f12conj(f, M), f12inv(f, C.pm2, M), M);     // f^(p^6 - 1)
  g = f12mul(f12frob(g, C.gamma2, false, M), g, M);             // ^(p^2 + 1)
  Fp12 t1 = f12mul(pow_x(g, C), f12conj(g, M), M);              // g^(x-1)
  t1 = f12mul(pow_x(t1, C), f12conj(t1, M), M);                 // g^((x-1)^2)
  const Fp12 t2 = f12mul(pow_x(t1, C), f12frob(t1, C.gamma1, true, M), M);  // ^(x+p)
  Fp12 acc = pow_x(pow_x(t2, C), C);                            // t2^(x^2)
  acc = f12mul(acc, f12frob(t2, C.gamma2, false, M), M);        // * t2^(p^2)
  acc = f12mul(acc, f12conj(t2, M), M);                         // / t2
  acc = f12mul(acc, f12cyc_sq(g, M), M);                        // * g^2
  return f12mul(acc, g, M);                                     // * g
}

}  // namespace ctt
