// Host build of tower.cuh, pairing.cuh and g1.cuh for the tests: the lane
// functions of K11, K12 and K13 and the Fp12 products behind a plain C
// interface, so they can be held against the port's plain PyTorch versions
// on a machine without nvcc or a card.
//
//   g++ -O1 -std=c++17 -shared -fPIC -o libpairing_host.so pairing_host.cpp
//
// Arrays are row-major u32 limbs in Montgomery form: Fp (n, 12), Fp2
// (n, 2, 12), Fp12 (n, 12, 12). consts is the kernels' constants struct as
// ops/cuda_pairing.py and ops/cuda_g1.py pack it.
#include <cstddef>

#include "g1.cuh"
#include "pairing.cuh"

using namespace ctt;

namespace {
constexpr int W12 = 12 * FPN;
}  // namespace

extern "C" int ctt_host_pairing_consts_size() { return (int)sizeof(PairingConsts); }
extern "C" int ctt_host_g1_consts_size() { return (int)sizeof(G1DecompressConsts); }

// op: 0 mul, 1 square, 2 cyclotomic square, 3 conj, 4 Frobenius p,
// 5 Frobenius p^2, 6 inverse, 7 sparse line (b holds lA, lC, lB in its
// first three Fp2 coefficients)
extern "C" void ctt_host_fp12_op(const void* consts, int op, const uint32_t* a,
                                 const uint32_t* b, uint32_t* out, int n) {
  const PairingConsts& C = *(const PairingConsts*)consts;
  const MdP& M = C.md;
  for (int i = 0; i < n; ++i) {
    const Fp12 x = f12load(a + (size_t)i * W12);
    const Fp12 y = f12load(b + (size_t)i * W12);
    Fp12 r;
    switch (op) {
      case 0: r = f12mul(x, y, M); break;
      case 1: r = f12sq(x, M); break;
      case 2: r = f12cyc_sq(x, M); break;
      case 3: r = f12conj(x, M); break;
      case 4: r = f12frob(x, C.gamma1, true, M); break;
      case 5: r = f12frob(x, C.gamma2, false, M); break;
      case 6: r = f12inv(x, C.pm2, M); break;
      default: r = f12sparse_line(x, y.c0.c0, y.c0.c1, y.c0.c2, M); break;
    }
    f12store(out + (size_t)i * W12, r);
  }
}

extern "C" void ctt_host_miller_loop(const void* consts, const uint32_t* xp,
                                     const uint32_t* yp, const uint32_t* xq,
                                     const uint32_t* yq, uint32_t* out, int n) {
  const PairingConsts& C = *(const PairingConsts*)consts;
  for (int i = 0; i < n; ++i) {
    const Fp2 xQ{fp_load(xq + (size_t)i * 2 * FPN), fp_load(xq + (size_t)i * 2 * FPN + FPN)};
    const Fp2 yQ{fp_load(yq + (size_t)i * 2 * FPN), fp_load(yq + (size_t)i * 2 * FPN + FPN)};
    f12store(out + (size_t)i * W12, miller_loop_lane(fp_load(xp + (size_t)i * FPN),
                                                     fp_load(yp + (size_t)i * FPN), xQ, yQ, C));
  }
}

extern "C" void ctt_host_final_exp(const void* consts, const uint32_t* f, uint32_t* out,
                                   int n) {
  const PairingConsts& C = *(const PairingConsts*)consts;
  for (int i = 0; i < n; ++i)
    f12store(out + (size_t)i * W12, final_exp_lane(f12load(f + (size_t)i * W12), C));
}

extern "C" void ctt_host_g1_decompress(const void* consts, const uint32_t* xm,
                                       const int32_t* sign, uint32_t* y, int32_t* ok, int n) {
  const G1DecompressConsts& C = *(const G1DecompressConsts*)consts;
  for (int i = 0; i < n; ++i) {
    Fp yi;
    ok[i] = g1_decompress_lane(fp_load(xm + (size_t)i * FPN), sign[i] != 0, yi, C) ? 1 : 0;
    fp_store(y + (size_t)i * FPN, yi);
  }
}
