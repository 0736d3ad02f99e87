// K3': the NTT butterfly, one element of work each, and a pass of stages over
// a tile in shared memory, shared by the CUDA kernels (ntt_kernels.cu) and the
// host build the tests use (ntt_host.cpp).
//
// Replaces constantine_tpu/ops/pallas_ec.py:_elemwise as instantiated at
// constantine_tpu/ops/ntt.py:168 (ntt_bfly: s = a + b*w, d = a - b*w) and
// :198 (ntt_twm: x*t, the four-step's twiddle matrix, here a factor of the
// pass's store), over Fr with the field code of ec.cuh.
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

// -- ntt_stages: a pass of stages in one block's shared memory ---------------
//
// The pass bit-reverses axis ns of x (batch, ns, lanes, N) and runs stages
// 0 .. stages - 1 of the DIT on it. Those stages pair elements only within
// runs of S = 2^stages rows along ns, so a block takes a tile of S rows (rows
// j S .. j S + S - 1 of the reversed array) by G lanes (l0 .. l0 + G - 1) of
// one batch row b: it loads the tile, gathering row i from x's row brp[j S +
// i], runs the stages on it and stores it to out's rows j S .. j S + S - 1.
// Stage u's butterfly q (of S/2 x G) is ntt_bfly_at's with h = 2^u on the
// tile: lane g = q mod G, t = q / G, k = t mod h, rows i0 = (t - k) 2 + k and
// i0 + h, twiddle k of stage u's table, which sits at row 2^u - 1 of tw (the
// stage tables packed: 1, 2, 4, ... rows). So every butterfly is the per-stage
// kernel's operation on the same operands, and the limbs do not change.
//
// Three compile-time options, each off in the plain pass:
//   InFac       the load factor: the element gathered from x's (b, row, lane)
//               is multiplied by in_fac[row * lanes + lane] (in_period =
//               ns * lanes) or in_fac[0] (in_period = 1) before the stages: a
//               coset transform's shift powers s^i;
//   OutFac      the store factor: each element is multiplied by the factor
//               of its place in out (the row's element index, period ns *
//               lanes, or 1) after the stages: the four-step's twiddle
//               matrix, 1/n, a coset iNTT's n^-1 s^-k;
//   Transposed  out is (batch, lanes, ns): tile element (i, g) goes to row
//               l0 + g, column j S + i, so each tile lane writes S contiguous
//               elements (the four-step's transpose).
// A factor multiplies the tile in place, an element a work item, as a phase
// of its own between the load (or the last stage) and the next phase.
//
// Element (i, g) of the tile is at tile + (i G + g)(N + 1): the odd stride
// puts the words that neighbouring threads read in different banks. A phase
// is the load, a factor, a stage, or the store; its work item w goes to
// thread w mod nthr, and the block's threads meet at a barrier between phases.
struct NttTile {
  int ns, lanes, S, G;  // the array's rows and lanes, the tile's rows and lanes
  int b, j, l0;         // the tile's batch row, run of rows and first lane
};

// A pass's factors: tables of (period, N) words, period 1 or ns * lanes
// (null where the option is off).
struct NttFactors {
  const uint32_t* in;
  int in_period;
  const uint32_t* out;
  int out_period;
};

// Threads a block of a pass: one a butterfly of a stage, whole warps, at
// most NTT_STAGE_THREADS (more butterflies loop).
constexpr int NTT_STAGE_THREADS = 512;

CTT_HD int ntt_stage_threads(int S, int G) {
  const int half = S / 2 * G;
  return half >= NTT_STAGE_THREADS ? NTT_STAGE_THREADS : half <= 32 ? 32 : (half + 31) / 32 * 32;
}

// The tile of block `blk` of batch * (ns / S) * (lanes / G).
CTT_HD NttTile ntt_tile_at(int blk, int ns, int lanes, int S, int G) {
  const int groups = lanes / G, runs = ns / S;
  const int q = blk / groups;
  return NttTile{ns, lanes, S, G, q / runs, q % runs, (blk % groups) * G};
}

// Phases of a pass: the load, a factor each, the stages, the store.
template <bool InFac, bool OutFac>
CTT_HD int ntt_tile_phases(int stages) {
  return stages + 2 + (InFac ? 1 : 0) + (OutFac ? 1 : 0);
}

template <int N>
CTT_HD void ntt_tile_load(const NttTile& t, const uint32_t* x, const int64_t* brp,
                          uint32_t* tile, int tid, int nthr) {
  const int row = t.G * N;
  for (int w = tid; w < t.S * row; w += nthr) {
    const int i = w / row, c = w - i * row;
    const size_t src = (((size_t)t.b * t.ns + (size_t)brp[t.j * t.S + i]) * t.lanes + t.l0) * N;
    tile[(i * t.G + c / N) * (N + 1) + c % N] = x[src + c];
  }
}

// Tile element e = i G + g times fac[f], in place.
template <int N>
CTT_HD void ntt_tile_mul(const Mod<N>& M, uint32_t* tile, int e, const uint32_t* fac, size_t f) {
  uint32_t* el = tile + e * (N + 1);
  Fe<N> a;
#pragma unroll
  for (int l = 0; l < N; ++l) a.v[l] = el[l];
  const Fe<N> r = fe_mul<N>(a, ntt_load<N>(fac, (int)f), M);
#pragma unroll
  for (int l = 0; l < N; ++l) el[l] = r.v[l];
}

// The load factor: element (i, g) came from x's row brp[j S + i], lane l0 + g.
template <int N>
CTT_HD void ntt_tile_in_factor(const NttTile& t, const Mod<N>& M, const int64_t* brp,
                               const NttFactors& fac, uint32_t* tile, int tid, int nthr) {
  for (int e = tid; e < t.S * t.G; e += nthr) {
    const int i = e / t.G, g = e - i * t.G;
    const size_t f = fac.in_period == 1 ? 0 : (size_t)brp[t.j * t.S + i] * t.lanes + t.l0 + g;
    ntt_tile_mul<N>(M, tile, e, fac.in, f);
  }
}

// Where element (i, g) of the tile goes in its batch row of out.
template <bool Transposed>
CTT_HD size_t ntt_tile_dst(const NttTile& t, int i, int g) {
  return Transposed ? (size_t)(t.l0 + g) * t.ns + (size_t)t.j * t.S + i
                    : ((size_t)t.j * t.S + i) * t.lanes + t.l0 + g;
}

// The store factor, by the element's place in out.
template <int N, bool Transposed>
CTT_HD void ntt_tile_out_factor(const NttTile& t, const Mod<N>& M, const NttFactors& fac,
                                uint32_t* tile, int tid, int nthr) {
  for (int e = tid; e < t.S * t.G; e += nthr) {
    const int i = e / t.G, g = e - i * t.G;
    ntt_tile_mul<N>(M, tile, e, fac.out,
                    fac.out_period == 1 ? 0 : ntt_tile_dst<Transposed>(t, i, g));
  }
}

template <int N>
CTT_HD void ntt_tile_stage(const NttTile& t, const Mod<N>& M, const uint32_t* tw,
                           uint32_t* tile, int u, int tid, int nthr) {
  const int h = 1 << u, nb = (t.S >> 1) * t.G;
  const uint32_t* twu = tw + (size_t)(h - 1) * N;
  for (int q = tid; q < nb; q += nthr) {
    const int g = q % t.G, s = q / t.G;
    const int k = s & (h - 1);
    uint32_t* e0 = tile + (((s - k) * 2 + k) * t.G + g) * (N + 1);
    uint32_t* e1 = e0 + h * t.G * (N + 1);
    Fe<N> a, b;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      a.v[l] = e0[l];
      b.v[l] = e1[l];
    }
    const Fe<N> bw = fe_mul<N>(b, ntt_load<N>(twu, k), M);
    const Fe<N> s0 = fe_add<N>(a, bw, M), s1 = fe_sub<N>(a, bw, M);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      e0[l] = s0.v[l];
      e1[l] = s1.v[l];
    }
  }
}

// The store, a word a work item: natural, the tile's rows (G N contiguous
// words each); transposed, the tile's lanes (S N contiguous words each).
template <int N, bool Transposed>
CTT_HD void ntt_tile_store(const NttTile& t, const uint32_t* tile, uint32_t* out, int tid,
                           int nthr) {
  if (Transposed) {
    const int run = t.S * N;
    for (int w = tid; w < t.G * run; w += nthr) {
      const int g = w / run, c = w - g * run, i = c / N;
      const size_t dst = (((size_t)t.b * t.lanes + t.l0 + g) * t.ns + (size_t)t.j * t.S) * N;
      out[dst + c] = tile[(i * t.G + g) * (N + 1) + c - i * N];
    }
  } else {
    const int row = t.G * N;
    for (int w = tid; w < t.S * row; w += nthr) {
      const int i = w / row, c = w - i * row;
      const size_t dst = (((size_t)t.b * t.ns + (size_t)t.j * t.S + i) * t.lanes + t.l0) * N;
      out[dst + c] = tile[(i * t.G + c / N) * (N + 1) + c % N];
    }
  }
}

// Phase p of a pass of `stages` stages (ntt_tile_phases of them): 0 the load,
// then the load factor, stages 0 .. stages - 1, the store factor, the store.
template <int N, bool InFac, bool OutFac, bool Transposed>
CTT_HD void ntt_tile_phase(const NttTile& t, const Mod<N>& M, const uint32_t* x,
                           uint32_t* out, const uint32_t* tw, const int64_t* brp,
                           const NttFactors& fac, uint32_t* tile, int stages, int p, int tid,
                           int nthr) {
  if (p == 0) {
    ntt_tile_load<N>(t, x, brp, tile, tid, nthr);
    return;
  }
  if (InFac && p == 1) {
    ntt_tile_in_factor<N>(t, M, brp, fac, tile, tid, nthr);
    return;
  }
  const int u = p - 1 - (InFac ? 1 : 0);
  if (u < stages)
    ntt_tile_stage<N>(t, M, tw, tile, u, tid, nthr);
  else if (OutFac && u == stages)
    ntt_tile_out_factor<N, Transposed>(t, M, fac, tile, tid, nthr);
  else
    ntt_tile_store<N, Transposed>(t, tile, out, tid, nthr);
}

}  // namespace ctt
