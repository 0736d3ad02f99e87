// K3': the NTT butterfly and the four-step twiddle product, one element of
// work each, shared by the CUDA kernels (ntt_kernels.cu) and the host build
// the tests use (ntt_host.cpp).
//
// Replaces constantine_tpu/ops/pallas_ec.py:_elemwise as instantiated at
// constantine_tpu/ops/ntt.py:168 (ntt_bfly: s = a + b*w, d = a - b*w) and
// :198 (ntt_twm: x*t), over Fr with the field code of ec.cuh.
//
// Layout: a transform stage works on a natural-layout (batch, ns, lanes, N)
// array of Montgomery limbs and transforms along ns. Butterfly j (of batch *
// ns/2 * lanes) has lane l = j % lanes, and q = j / lanes splits into the
// batch row b = q / (ns/2) and t = q % (ns/2); t sits in block t / h at
// offset k = t % h, so its elements are i0 = block * 2h + k and i1 = i0 + h
// along ns, and its twiddle is tw[k]. The reference's reshape to (ns/m, 2,
// m/2) and concatenate of (s, d) put s at i0 and d at i1, which is what the
// stores below do, so a stage needs no copy around it. With lanes = 1 this is
// the batched radix-2 stage (ops/ntt.py:88-109); with lanes = n2 or n1 it is
// one of the four-step's middle-axis stages (:146-161).
#pragma once

#include <stddef.h>

#include "ec.cuh"

namespace ctt {

template <int N>
CTT_HD Fe<N> ntt_load(const uint32_t* base, int idx) {
  Fe<N> r;
#pragma unroll
  for (int l = 0; l < N; ++l) r.v[l] = base[(size_t)idx * N + l];
  return r;
}

template <int N>
CTT_HD void ntt_store(uint32_t* base, int idx, const Fe<N>& v) {
#pragma unroll
  for (int l = 0; l < N; ++l) base[(size_t)idx * N + l] = v.v[l];
}

// Butterfly j of a stage with half-block h. x and out may be the same array:
// each butterfly reads its two elements before it writes them.
template <int N>
CTT_HD void ntt_bfly_at(const Mod<N>& M, const uint32_t* x, uint32_t* out,
                        const uint32_t* tw, int j, int ns, int lanes, int h) {
  const int l = j % lanes;
  const int q = j / lanes;
  const int half = ns >> 1;
  const int b = q / half;
  const int t = q - b * half;
  const int k = t % h;
  const int i0 = (t - k) * 2 + k;  // block (t / h) * 2h + k
  const int e0 = (b * ns + i0) * lanes + l;
  const int e1 = e0 + h * lanes;
  const Fe<N> a = ntt_load<N>(x, e0);
  const Fe<N> bw = fe_mul<N>(ntt_load<N>(x, e1), ntt_load<N>(tw, k), M);
  ntt_store<N>(out, e0, fe_add<N>(a, bw, M));
  ntt_store<N>(out, e1, fe_sub<N>(a, bw, M));
}

// Element i of the four-step's pointwise product with the twiddle matrix.
template <int N>
CTT_HD void ntt_twm_at(const Mod<N>& M, const uint32_t* x, const uint32_t* t,
                       uint32_t* out, int i) {
  ntt_store<N>(out, i, fe_mul<N>(ntt_load<N>(x, i), ntt_load<N>(t, i), M));
}

}  // namespace ctt
