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
#pragma once

#include "tower.cuh"

namespace ctt {

struct G1DecompressConsts {
  MdP md;
  Fp beta;          // cube root of unity of the GLV endomorphism, Montgomery
  Fp half;          // (p + 1)/2, canonical
  FpExp sqrt_exp;   // (p + 1)/4
  FpExp u2;         // u^2
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

}  // namespace ctt
