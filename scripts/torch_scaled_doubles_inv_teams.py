#!/usr/bin/env python3
"""K7 scaled_doubles' team size and doubling, and K9's inverse, on one
NVIDIA card.

    python3 scripts/torch_scaled_doubles_inv_teams.py

K7. The port runs a window's c*w doublings with a team of SM_TEAM threads
over ec.cuh's ec_double_team, 3 levels of products (csrc/ec_kernels.cu).
This script builds, from copies of csrc/, K7's lane with a team of T = 1, 2
and 4 threads a window (`ctt_sd_at`), once over the 3-level doubling and
once over the 4-level one it replaced (E^2 in a level of its own), and the
parent's kernel, one thread a window over ec_double (T = 0). At the online
commit's (W, c) = (15, 9) and the 2^16 MSM's (11, 12), on seeded Jacobian
points with an infinity lane and a Y = 0 lane, it holds every variant
exactly against the port's kernel, times it with CUDA events and prints the
chain floor: the longest lane's doublings x the rounds of a doubling for
the team x fe_mul_eo's latency in a lone thread (the chain kernel of
scripts/torch_scalar_mul_teams.py, built beside).

K9. Builds the inverse four ways (`ctt_inv_at`): the parent's Fermat power
(square-and-multiply over p - 2, fe_mul), a lone thread's 4-bit window
Fermat (K12's fp_pow_window: fe_mul_eo for Fp; fe_mul for Fr, whose r is
above fe_mul_eo's 2^254 bound), and inv.cuh's safegcd with batches of 30
divsteps on 32-bit words (the port's) and, from a copy of csrc/ with
inv.cuh's INV_BITS and limb types patched, of 62 on 64-bit words with
__int128 products. Over Fp and Fr at 512,
16 and 1 lanes (seeded values; 0, 1 and p - 1 among the 512) it holds each
exactly against the port's kernel and times it.

Prints ptxas's registers and spills of every variant. Exits non-zero if a
build fails or a variant differs (its entry says DIFFERS). Needs the port
beside it and a CUDA card.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from constantine_tpu_torch import build  # noqa: E402
from torch_scalar_mul_teams import events_ms, mul_latency, start_mul_chain  # noqa: E402

SHAPES = ((15, 9), (11, 12))
K7_TEAMS = (1, 2, 4)
# (name, library, which): inv is built from csrc/ as it is, inv62 from a copy
# with inv.cuh's batch width and limb types patched
K9_VARIANTS = (("parent's Fermat", "inv", 0), ("window Fermat", "inv", 1),
               ("safegcd 30", "inv", 2), ("safegcd 62", "inv62", 2))
LANES = (512, 16, 1)
P_, I_ = ctypes.c_void_p, ctypes.c_int

SD_CU = r"""
#include <cuda_runtime.h>
#include "ec.cuh"
using namespace ctt;

namespace {
constexpr int NL = 12, LANES = 16;   // windows a block, whatever the team size
using J = Jac<NL>;
using MD = Mod<NL>;

template <int kT>
__global__ void __launch_bounds__(LANES * kT)
sd_team_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
               uint32_t* oy, uint32_t* oz, int W, int c) {
  constexpr int WORDS = 2 * kT * NL + 1;
  const int team = threadIdx.x / kT;
  const int w = blockIdx.x * LANES + team;
  if (w >= W) return;
  __shared__ uint32_t slots[LANES * WORDS];
  const int rank = threadIdx.x % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, kT> tm{slots + team * WORDS, mask, rank};
  scaled_doubles_lane<NL>(tm, x, y, z, ox, oy, oz, W, c, w, md);
}

// the parent's K7: one thread a window over ec_double (fe_mul)
__global__ void sd_thread_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                 uint32_t* ox, uint32_t* oy, uint32_t* oz, int W, int c) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  J P{load_col<NL>(x + w, W), load_col<NL>(y + w, W), load_col<NL>(z + w, W)};
  for (int s = 0; s < c * w; ++s) P = ec_double<NL>(P, md);
  Solo<NL> tm;
  store_split<NL>(tm, ox + w, oy + w, oz + w, W, P);
}

template <int kT>
void launch(const MD& md, const void* x, const void* y, const void* z, void* ox, void* oy,
            void* oz, int W, int c, cudaStream_t s) {
  sd_team_kernel<kT><<<(W + LANES - 1) / LANES, LANES * kT, 0, s>>>(
      md, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, W, c);
}
}  // namespace

// T = 1, 2, 4: a team of T a window; T = 0: one thread a window.
extern "C" int ctt_sd_at(const uint32_t* w, const void* x, const void* y, const void* z,
                         void* ox, void* oy, void* oz, int W, int c, int T, void* stream) {
  const MD md = mod_from_words<NL>(w);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 0:
      sd_thread_kernel<<<(W + 127) / 128, 128, 0, s>>>(
          md, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox,
          (uint32_t*)oy, (uint32_t*)oz, W, c);
      break;
    case 1: launch<1>(md, x, y, z, ox, oy, oz, W, c, s); break;
    case 2: launch<2>(md, x, y, z, ox, oy, oz, W, c, s); break;
    case 4: launch<4>(md, x, y, z, ox, oy, oz, W, c, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

# ec_double_team as the parent had it: 4 levels, E^2 in a level of its own.
THREE_LEVELS = """  mul_level<N, 3>(tm, {B, xb, E}, {B, xb, E}, l2, M);
  const Fe<N> C = l2[0];
  const Fe<N> D = fe_dbl<N>(fe_sub<N>(fe_sub<N>(l2[1], A, M), C, M), M);
  Jac<N> R;
  R.X = fe_sub<N>(l2[2], fe_dbl<N>(D, M), M);
  mul_level<N, 1>(tm, {E}, {fe_sub<N>(D, R.X, M)}, l3, M);
  R.Y = fe_sub<N>(l3[0], fe_dbl<N>(fe_dbl<N>(fe_dbl<N>(C, M), M), M), M);"""
FOUR_LEVELS = """  Fe<N> l2b[2], l3b[1], l4b[1];
  mul_level<N, 2>(tm, {B, xb}, {B, xb}, l2b, M);
  const Fe<N> C = l2b[0];
  const Fe<N> D = fe_dbl<N>(fe_sub<N>(fe_sub<N>(l2b[1], A, M), C, M), M);
  mul_level<N, 1>(tm, {E}, {E}, l3b, M);
  Jac<N> R;
  R.X = fe_sub<N>(l3b[0], fe_dbl<N>(D, M), M);
  mul_level<N, 1>(tm, {E}, {fe_sub<N>(D, R.X, M)}, l4b, M);
  R.Y = fe_sub<N>(l4b[0], fe_dbl<N>(fe_dbl<N>(fe_dbl<N>(C, M), M), M), M);"""

INV_CU = r"""
#include <cuda_runtime.h>
#include "inv.cuh"
using namespace ctt;

namespace {
constexpr int THREADS = 128;

template <int N>
struct Exp {
  uint32_t e[N];
  int nbits;
};

template <int N>
__device__ Fe<N> load_lane(const uint32_t* x, int n, int i) {
  Fe<N> r;
  for (int l = 0; l < N; ++l) r.v[l] = x[(size_t)l * n + i];
  return r;
}

template <int N>
__device__ void store_lane(uint32_t* o, int n, int i, const Fe<N>& v) {
  for (int l = 0; l < N; ++l) o[(size_t)l * n + i] = v.v[l];
}

// the parent's K9: square-and-multiply, most significant bit first, fe_mul
template <int N>
__global__ void fermat_bits_kernel(Mod<N> md, Exp<N> ex, const uint32_t* x, uint32_t* out,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe<N> base = load_lane<N>(x, n, i);
  Fe<N> acc = fe_one<N>(md);
  for (int b = ex.nbits - 1; b >= 0; --b) {
    acc = fe_sq<N>(acc, md);
    if ((ex.e[b >> 5] >> (b & 31)) & 1u) acc = fe_mul<N>(acc, base, md);
  }
  store_lane<N>(out, n, i, acc);
}

template <int N, bool kEo>
__device__ __forceinline__ Fe<N> mul_as(const Fe<N>& a, const Fe<N>& b, const Mod<N>& M) {
  if constexpr (kEo) return fe_mul_eo<N>(a, b, M);
  else return fe_mul<N>(a, b, M);
}

// a lone thread's 4-bit window power (program.cuh fp_pow_window)
template <int N, bool kEo>
__global__ void fermat_window_kernel(Mod<N> md, Exp<N> ex, const uint32_t* x, uint32_t* out,
                                     int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<N> tab[16];
  tab[0] = fe_one<N>(md);
  tab[1] = load_lane<N>(x, n, i);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) tab[k] = mul_as<N, kEo>(tab[k - 1], tab[1], md);
  const int nw = (ex.nbits + 3) / 4;
  auto win = [&](int j) { return (ex.e[j >> 3] >> ((j & 7) * 4)) & 15; };
  Fe<N> acc = tab[win(nw - 1)];
#pragma unroll 1
  for (int j = nw - 2; j >= 0; --j) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = mul_as<N, kEo>(acc, acc, md);
    const int w = win(j);
    if (w) acc = mul_as<N, kEo>(acc, tab[w], md);
  }
  store_lane<N>(out, n, i, acc);
}

// inv.cuh's fe_inv at the INV_BITS of the copy it is built from
template <int N>
__global__ void safegcd_kernel(Mod<N> md, InvConsts<N> ic, const uint32_t* x, uint32_t* out,
                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store_lane<N>(out, n, i, fe_inv<N>(load_lane<N>(x, n, i), ic, md));
}

template <int N>
int launch(int which, const uint32_t* w, const uint32_t* ew, int nbits, const uint32_t* r3,
           const void* x, void* out, int n, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(w);
  Exp<N> ex;
  for (int l = 0; l < N; ++l) ex.e[l] = ew[l];
  ex.nbits = nbits;
  const int blocks = (n + THREADS - 1) / THREADS;
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  switch (which) {
    case 0: fermat_bits_kernel<N><<<blocks, THREADS, 0, s>>>(md, ex, xi, o, n); break;
    case 1: fermat_window_kernel<N, N == 12><<<blocks, THREADS, 0, s>>>(md, ex, xi, o, n); break;
    case 2: safegcd_kernel<N><<<blocks, THREADS, 0, s>>>(md, inv_consts<N>(md, r3), xi, o, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
}  // namespace

// which: 0 the parent's Fermat, 1 window Fermat, 2 safegcd at INV_BITS.
extern "C" int ctt_inv_at(int nl, int which, const uint32_t* w, const uint32_t* exp_words,
                          int nbits, const uint32_t* r3, const void* x, void* out, int n,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (nl == 8) return launch<8>(which, w, exp_words, nbits, r3, x, out, n, s);
  if (nl == 12) return launch<12>(which, w, exp_words, nbits, r3, x, out, n, s);
  return (int)cudaErrorInvalidValue;
}
"""


# inv.cuh's batch width and limb types, and the 62-bit variant's.
INV_30 = """constexpr int INV_BITS = 30;
using SgS = int32_t;    // a limb or a matrix entry, signed
using SgU = uint32_t;   // the same, unsigned
using SgW = int64_t;    // a product of two limbs, and a carry"""
INV_62 = """constexpr int INV_BITS = 62;
using SgS = int64_t;
using SgU = uint64_t;
using SgW = __int128;"""


def start_builds(out_dir: Path):
    """nvcc of the variant libraries and the multiply chain, all started
    together: {name: (so, process)}."""
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, text, patch in (("sd3", SD_CU, None),
                              ("sd4", SD_CU, ("ec.cuh", THREE_LEVELS, FOUR_LEVELS)),
                              ("inv", INV_CU, None),
                              ("inv62", INV_CU, ("inv.cuh", INV_30, INV_62))):
        d = out_dir / name
        shutil.copytree(build.CSRC, d)
        if patch:
            header, old, new = patch
            src = (d / header).read_text()
            if src.count(old) != 1:
                raise RuntimeError(f"{header} no longer holds the text this variant patches")
            (d / header).write_text(src.replace(old, new))
        cu = d / f"{name}_variants.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    src, proc = start_mul_chain(out_dir)
    procs["mul_chain"] = src.with_suffix(".so"), proc
    return procs


def finish_builds(procs):
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 or not so.exists():
            print(f"[nvcc {name}] failed\n{log}", flush=True)
            return None
        for line in build.ptxas_summary(log):
            print(f"[nvcc {name}] {line}", flush=True)
        lib = ctypes.CDLL(str(so))
        if name.startswith("sd"):
            lib.ctt_sd_at.argtypes = [P_] * 7 + [I_, I_, I_, P_]
            lib.ctt_sd_at.restype = I_
        elif name.startswith("inv"):
            lib.ctt_inv_at.argtypes = [I_, I_, P_, P_, I_, P_, P_, P_, I_, P_]
            lib.ctt_inv_at.restype = I_
        libs[name] = lib
    return libs


def k7_rounds(T, levels):
    """Rounds of one doubling for a team of T: each level of k products
    takes ceil(k / T)."""
    return sum(-(-k // T) for k in levels)


def window_points(ctx, W, dev):
    """Planar (12, W) Jacobian columns of W seeded points [k]G doubled once
    (Z != 1); lane 1 at infinity, lane 3 with Y = 0."""
    from constantine_tpu_torch.utils import refmath as rm
    g, F = ctx.g1, ctx.fp
    rng = np.random.default_rng(W)
    pts = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 62, size=W)]
    P = g.double(g.from_affine((F.encode([q[0] for q in pts], dev),
                                F.encode([q[1] for q in pts], dev))))
    P = tuple(v.T.contiguous() for v in P)
    P[2][:, 1] = 0
    P[1][:, 3] = 0
    return P


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    procs = start_builds(build.BUILD_DIR / "sd_inv_teams")
    build.build_all(verbose=True)
    libs = finish_builds(procs)
    if libs is None:
        return 1
    from constantine_tpu_torch.named.precompute import get_curve
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    sid = torch.cuda.current_stream(dev).cuda_stream
    lat_us, exact, _ = mul_latency(libs["mul_chain"], ctx, dev, True)
    print(f"fe_mul_eo: {lat_us:.4f} us a multiply in a lone thread's dependent chain "
          f"({'exact' if exact else 'DIFFERS'})", flush=True)
    ok = exact
    pec = ctx.g1.pec
    mod = ctypes.c_void_p(ctx.fp.mod_words.ctypes.data)
    for W, c in SHAPES:
        P = window_points(ctx, W, dev)
        port = pec.scaled_doubles(P, c, W)
        outs = tuple(torch.empty_like(v) for v in port)

        def sd(lib, T):
            rc = lib.ctt_sd_at(mod, *map(build.ptr, (*P, *outs)), W, c, T, sid)
            if rc != 0:
                raise RuntimeError(f"ctt_sd_at T={T}: CUDA error {rc}")

        row = [f"port {events_ms(lambda: pec.scaled_doubles(P, c, W), 10):.4f}"]
        for name, levels in (("sd3", (3, 3, 1)), ("sd4", (3, 2, 1, 1))):
            for T in K7_TEAMS:
                sd(libs[name], T)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(outs, port))
                ok &= same
                floor = c * (W - 1) * k7_rounds(T, levels) * lat_us * 1e-3
                row.append(f"{len(levels)} levels T={T} "
                           f"{events_ms(lambda: sd(libs[name], T), 10):.4f} (floor {floor:.4f})"
                           + ("" if same else " DIFFERS"))
        sd(libs["sd3"], 0)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, port))
        ok &= same
        row.append(f"one thread over ec_double (the parent's) "
                   f"{events_ms(lambda: sd(libs['sd3'], 0), 5):.4f}" + ("" if same else " DIFFERS"))
        print(f"scaled_doubles W={W} c={c} (longest lane {c * (W - 1)} doublings): ms a call "
              "(CUDA events), each variant against the port's kernel, chain floor = doublings x "
              "rounds a doubling x fe_mul_eo: " + ", ".join(row), flush=True)
    for F in (ctx.fp, ctx.fr):
        aff = F.affine
        m = F.p_int
        rng = np.random.default_rng(F.NL)
        vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(48), "big") % m for _ in range(509)]
        x512 = F.encode(vals, dev).T.contiguous()
        ew = np.ascontiguousarray(np.frombuffer(aff.exp_int.to_bytes(4 * F.NL, "little"),
                                                dtype="<u4").astype(np.uint32))
        r3 = np.ascontiguousarray(aff._r3_words)
        d = m.bit_length()
        steps = (49 * d + 57) // 17
        for n in LANES:
            x = x512[:, 512 - n:].contiguous() if n < 512 else x512
            port = aff.fermat_inv(x)
            out = torch.empty_like(x)

            def inv(lib, which):
                rc = libs[lib].ctt_inv_at(F.NL, which, ctypes.c_void_p(F.mod_words.ctypes.data),
                                            ctypes.c_void_p(ew.ctypes.data), aff.exp_bits,
                                            ctypes.c_void_p(r3.ctypes.data), build.ptr(x),
                                            build.ptr(out), n, sid)
                if rc != 0:
                    raise RuntimeError(f"ctt_inv_at {lib} {which}: CUDA error {rc}")

            row = [f"port {events_ms(lambda: aff.fermat_inv(x), 20):.4f}"]
            for name, lib, which in K9_VARIANTS:
                inv(lib, which)
                torch.cuda.synchronize()
                same = torch.equal(out, port)
                ok &= same
                row.append(f"{name} {events_ms(lambda: inv(lib, which), 20):.4f}"
                           + ("" if same else " DIFFERS"))
            print(f"fermat_inv {F.name} n={n} ({steps} divsteps: {-(-steps // 30)} batches of 30, "
                  f"{-(-steps // 62)} of 62): ms a call (CUDA events), each variant against the "
                  "port's kernel: " + ", ".join(row), flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
