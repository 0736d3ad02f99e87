// Host build of ec.cuh for the tests: the header's portable arithmetic
// behind a plain C interface, so it can be held against the port's plain
// PyTorch versions on a machine without nvcc or a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libec_host.so ec_host.cpp
//
// Arrays are row-major (n, 12) u32 limbs in Montgomery form; mod_words is
// p[12], m0, one[12] as in ec.cuh.
#include "ec.cuh"

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
