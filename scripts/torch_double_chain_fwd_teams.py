#!/usr/bin/env python3
"""K3 double_k's team and K8 chain_fwd's scan, on one NVIDIA card.

    python3 scripts/torch_double_chain_fwd_teams.py                 # variants
    python3 scripts/torch_double_chain_fwd_teams.py --calls-only --root DIR

K3 double. The port runs a lane's k doublings in one launch, a team of
SM_TEAM = 4 threads a lane over ec.cuh's ec_double_team (3 rounds of
products a doubling), 16 lanes a block (csrc/ec_kernels.cu). Built here
from ec.cuh (`ctt_dk_at`): double_k_lane at a team of T = 1, 2 and 4 with 16
lanes a block, and at T = 4 with 8 and 32 lanes a block; and the parent's
kernel, one thread a lane over ec_double (7 dependent products a doubling).
At a table layer's n = 4,096 with k = 1 and 12 and at the MSM tails' (1, 2),
(15, 2), (16, 4), (11, 3) and (17, 2), on seeded Jacobian points with an infinity
lane and a Y = 0 lane, each is held exactly against the port's kernel and
timed on the device, beside the chain floor: the rounds of a doubling for
the team x k x fe_mul_eo's latency in a lone thread (the chain kernel of
scripts/torch_scalar_mul_teams.py, built beside).

K8. The port runs the forward chain as a prefix scan in shared memory over
segments of S links, a thread a segment (csrc/chain.cuh chain_fwd_phase:
the segment's product, a Hillis-Steele scan across the C / S segments, a
walk down the segment; 2 (S - 1) + log2(C / S) products deep, about 2C a
lane at S > 1, C log C at S = 1, the plain scan), at (S, G) = (2, 4)
below 2,048 lanes and (4, 16) from there (csrc/field_kernels.cu). Built
here (`ctt_fwd_at`): the same phases at S = 1, 2, 4, 8 links a thread and
G = 4, 8, 16 lanes a block, and the parent's kernel, one thread a lane
walking the chain, C deep. At the paths' Fr (C, NL, Mw) = (32, 8, 512) and
(32, 8, 8,192) and the setup's Fp (32, 12, 3,072), each exact against the
port's kernel, timed on the device.

K9 alone against K8 + K9 + K10: Field inversion of 4,096, 8,192 and 16,384
Fr lanes by one fermat_inv launch (safegcd, a thread a lane) and by
CudaAffine.batch_inv_packed (the chains, K9 on 512 lanes, the unwind), both
the unique inverse, so exact against each other; device time of each.

--calls-only times, through whichever port lies at --root (this tree or an
unpacked copy of another commit), ECGroup.double at n = 4,096, a table
layer (n = 4,096, k = 12: ECGroup.double_k where the tree has it, else 12
ECGroup.double calls), the setup's 22 layers (the loop of
PrecomputedMSM._precompute, host clock), the whole table build
(PrecomputedMSM on the 4,096 Lagrange points, host clock), CudaEC.double_k
at the tail's shapes, CudaAffine.chain_fwd at the three K8 shapes and
batch_inv_packed at 16,384 and 262,144 Fr lanes: host-clock ms a call
(synchronised), the host's ms to enqueue a call (calls back to back) and the
device's ms a call. It builds only field_kernels.cu and ec_kernels.cu.
Prints one JSON line ("calls: {...}").

Prints ptxas's registers and spills of every kernel built. Exits non-zero
if a build fails or a variant differs. Needs a CUDA card.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
P_, I_ = ctypes.c_void_p, ctypes.c_int
# (n, k): a table layer's 4,096 points at k = 1 and 12, and the MSM tails of
# the commit, online commit, batch of 16, 2^16 MSM and batch verify
DK_SHAPES = ((4096, 1), (4096, 12), (1, 2), (15, 2), (16, 4), (11, 3), (17, 2))
K8_SHAPES = ((8, 32, 512), (8, 32, 8192), (12, 32, 3072))                 # (NL, C, Mw)
INV_LANES = (4096, 8192, 16384)
# (label, T, lanes a block); T = 0: the parent's one thread a lane
DK_VARIANTS = (("T = 1, 16 lanes a block", 1, 16), ("T = 2, 16 lanes", 2, 16),
               ("T = 4, 8 lanes", 4, 8), ("T = 4, 16 lanes", 4, 16), ("T = 4, 32 lanes", 4, 32),
               ("one thread a lane (the parent's)", 0, 128))
# rounds of product latency a doubling for a team of T (levels of 3, 3, 1
# products; one thread: 7 products)
DK_ROUNDS = {1: 7, 2: 5, 4: 3, 0: 7}
# K8: (links a thread, lanes a block); S = 1 is the plain scan over links.
# The port's kernel takes (2, 4) below CHAIN_FWD_WIDE lanes, (4, 16) from there.
CHAIN_FWD_WIDE = int(re.search(r"constexpr int CHAIN_FWD_WIDE = (\d+);", (
    HERE / "constantine_tpu_torch" / "csrc" / "field_kernels.cu").read_text()).group(1))
K8_VARIANTS = tuple((S, G) for S in (1, 2, 4, 8) for G in (4, 8, 16))

VARIANTS_CU = r"""
#include <cuda_runtime.h>
#include "chain.cuh"
#include "ec.cuh"
using namespace ctt;

namespace {
constexpr int NL = 12;
using J = Jac<NL>;
using MD = Mod<NL>;

// K3 double: a team of kT a lane, LANES lanes a block
template <int kT, int LANES>
__global__ void __launch_bounds__(LANES * kT)
dk_team_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
               uint32_t* oy, uint32_t* oz, int n, int k) {
  constexpr int WORDS = 2 * kT * NL + 1;
  const int team = threadIdx.x / kT;
  const int i = blockIdx.x * LANES + team;
  if (i >= n) return;
  __shared__ uint32_t slots[LANES * WORDS];
  const int rank = threadIdx.x % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, kT> tm{slots + team * WORDS, mask, rank};
  double_k_lane<NL>(tm, x, y, z, ox, oy, oz, n, k, i, md);
}

// the parent's K3 double: one thread a lane over ec_double (fe_mul)
__global__ void dk_thread_kernel(MD md, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                 uint32_t* ox, uint32_t* oy, uint32_t* oz, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  J P{load_col<NL>(x + i, n), load_col<NL>(y + i, n), load_col<NL>(z + i, n)};
  for (int s = 0; s < k; ++s) P = ec_double<NL>(P, md);
  Solo<NL> tm;
  store_split<NL>(tm, ox + i, oy + i, oz + i, n, P);
}

template <int kT, int LANES>
void dk_launch(const MD& md, const void* x, const void* y, const void* z, void* ox, void* oy,
               void* oz, int n, int k, cudaStream_t s) {
  dk_team_kernel<kT, LANES><<<(n + LANES - 1) / LANES, LANES * kT, 0, s>>>(
      md, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, n, k);
}

// K8 over chain.cuh's phases, S links a thread and G lanes a block (the
// port's kernel at any (S, G))
template <int N, int S, int G>
__global__ void __launch_bounds__(G * CHAIN_MAX_C / S)
fwd_kernel(Mod<N> md, const uint32_t* __restrict__ d, uint32_t* __restrict__ pe,
           uint32_t* __restrict__ bp, int C, int Mw) {
  extern __shared__ uint32_t tile[];
  const int L = chain_levels((C + S - 1) / S);
  for (int p = 0; p <= L + 1; ++p) {
    chain_fwd_phase<N>(md, d, pe, bp, tile, C, S, Mw, G, blockIdx.x * G, threadIdx.x,
                       threadIdx.y, p);
    if (p <= L) __syncthreads();
  }
}

// the parent's K8: one thread a lane walks the chain
template <int N>
__global__ void fwd_parent_kernel(Mod<N> md, const uint32_t* __restrict__ d,
                                  uint32_t* __restrict__ pe, uint32_t* __restrict__ bp, int C,
                                  int Mw) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mw) return;
  Fe<N> run = fe_one<N>(md);
  for (int c = 0; c < C; ++c) {
    const size_t off = (size_t)c * N * Mw;
    store_lane<N>(pe + off, Mw, m, run);
    run = fe_mul<N>(run, load_lane<N>(d + off, Mw, m), md);
  }
  store_lane<N>(bp, Mw, m, run);
}

template <int N, int S, int G>
int fwd_sg(const Mod<N>& md, const uint32_t* d, uint32_t* pe, uint32_t* bp, int C, int Mw,
           cudaStream_t s) {
  const int n = (C + S - 1) / S;
  const int smem = (int)(chain_tile_words(n, N, G) * sizeof(uint32_t));
  cudaFuncSetAttribute(fwd_kernel<N, S, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fwd_kernel<N, S, G><<<(Mw + G - 1) / G, dim3(G, n), smem, s>>>(md, d, pe, bp, C, Mw);
  return (int)cudaGetLastError();
}

template <int N, int S>
int fwd_s(int G, const Mod<N>& md, const uint32_t* d, uint32_t* pe, uint32_t* bp, int C, int Mw,
          cudaStream_t s) {
  if (G == 4) return fwd_sg<N, S, 4>(md, d, pe, bp, C, Mw, s);
  if (G == 8) return fwd_sg<N, S, 8>(md, d, pe, bp, C, Mw, s);
  if (G == 16) return fwd_sg<N, S, 16>(md, d, pe, bp, C, Mw, s);
  return (int)cudaErrorInvalidValue;
}

template <int N>
int fwd_launch(int S, int G, const uint32_t* w, const uint32_t* d, uint32_t* pe, uint32_t* bp,
               int C, int Mw, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(w);
  if (C > CHAIN_MAX_C) return (int)cudaErrorInvalidValue;
  switch (S) {
    case 0:
      fwd_parent_kernel<N><<<(Mw + 127) / 128, 128, 0, s>>>(md, d, pe, bp, C, Mw);
      return (int)cudaGetLastError();
    case 1: return fwd_s<N, 1>(G, md, d, pe, bp, C, Mw, s);
    case 2: return fwd_s<N, 2>(G, md, d, pe, bp, C, Mw, s);
    case 4: return fwd_s<N, 4>(G, md, d, pe, bp, C, Mw, s);
    case 8: return fwd_s<N, 8>(G, md, d, pe, bp, C, Mw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace

// T = 1, 2, 4 with LANES lanes a block (16; 8 or 32 at T = 4): a team of T a
// lane; T = 0: one thread a lane.
extern "C" int ctt_dk_at(const uint32_t* w, const void* x, const void* y, const void* z,
                         void* ox, void* oy, void* oz, int n, int k, int T, int lanes,
                         void* stream) {
  const MD md = mod_from_words<NL>(w);
  const cudaStream_t s = (cudaStream_t)stream;
  if (T == 0) {
    dk_thread_kernel<<<(n + 127) / 128, 128, 0, s>>>(
        md, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, n, k);
  } else if (T == 1 && lanes == 16) {
    dk_launch<1, 16>(md, x, y, z, ox, oy, oz, n, k, s);
  } else if (T == 2 && lanes == 16) {
    dk_launch<2, 16>(md, x, y, z, ox, oy, oz, n, k, s);
  } else if (T == 4 && lanes == 8) {
    dk_launch<4, 8>(md, x, y, z, ox, oy, oz, n, k, s);
  } else if (T == 4 && lanes == 16) {
    dk_launch<4, 16>(md, x, y, z, ox, oy, oz, n, k, s);
  } else if (T == 4 && lanes == 32) {
    dk_launch<4, 32>(md, x, y, z, ox, oy, oz, n, k, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// S = 1, 2, 4, 8 links a thread at G = 4, 8 or 16 lanes a block: chain.cuh's
// scan; S = 0: the parent's one thread a lane.
extern "C" int ctt_fwd_at(int nl, int S, int G, const uint32_t* w, const void* d, void* pe,
                          void* bp, int C, int Mw, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  if (nl == 8) return fwd_launch<8>(S, G, w, u(d), (uint32_t*)pe, (uint32_t*)bp, C, Mw, s);
  if (nl == 12) return fwd_launch<12>(S, G, w, u(d), (uint32_t*)pe, (uint32_t*)bp, C, Mw, s);
  return (int)cudaErrorInvalidValue;
}
"""


def _import_port(root: Path):
    sys.path.insert(0, str(HERE / "scripts"))
    sys.path.insert(0, str(root))           # its port and chip_smoke.py first
    from constantine_tpu_torch import build
    from constantine_tpu_torch.named.precompute import get_curve
    return build, get_curve


def _rand(F, n, seed, dev):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "big") % F.p_int for _ in range(n)]
    if n >= 16:
        xs[:3] = [0, 1, F.p_int - 1]
    return F.encode(xs, dev)


def _chains(F, C, Mw, seed, dev):
    """(C, NL, Mw) planar chain elements from a seed."""
    return _rand(F, C * Mw, seed, dev).T.reshape(F.NL, C, Mw).transpose(0, 1).contiguous()


def _points(ctx, n, dev):
    """(NL, n) planar Jacobian columns: the first n of 4,096 seeded points
    [k]G doubled once (Z != 1), lane 1 at infinity and lane 3 with Y = 0
    where n has them."""
    from constantine_tpu_torch.utils import refmath as rm
    g, F = ctx.g1, ctx.fp
    rng = np.random.default_rng(n)
    base = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 62, size=16)]
    pts = [base[i % 16] for i in range(n)]
    P = g.double(g.from_affine((F.encode([q[0] for q in pts], dev),
                                F.encode([q[1] for q in pts], dev))))
    P = tuple(v.T.contiguous() for v in P)
    if n > 1:
        P[2][:, 1] = 0
    if n > 3:
        P[1][:, 3] = 0
    return P


def _host_ms(fn, reps):
    """Median host-clock ms of a call ending synchronised."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def calls(root: Path):
    """The tree's public calls, timed: {label: {"call_ms", "enqueue_ms",
    "device_ms"}}, and the setup's host-clock ms."""
    build, get_curve = _import_port(root)
    from chip_smoke import device_ms, enqueue_ms
    from constantine_tpu_torch.models.trusted_setup import get_settings
    from constantine_tpu_torch.ops.msm_precomp import PrecomputedMSM, best_precomp_window
    build.SOURCES = ("field_kernels", "ec_kernels")
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"field_kernels, ec_kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    g, fr = ctx.g1, ctx.fr
    res = {}

    def entry(label, fn, reps):
        res[label] = {"call_ms": _host_ms(fn, reps), "enqueue_ms": enqueue_ms(torch, fn, reps),
                      "device_ms": device_ms(torch, fn, reps)}

    P = tuple(v.T.contiguous() for v in _points(ctx, 4096, dev))     # (n, NL) Jacobian

    def layer(P, k=12):
        if hasattr(g, "double_k"):
            return g.double_k(P, k)
        for _ in range(k):
            P = g.double(P)
        return P

    entry("ECGroup.double n=4096", lambda: g.double(P), 20)
    entry("table layer (n=4096, k=12)", lambda: layer(P), 10)
    for n, k in DK_SHAPES[2:]:
        Pt = _points(ctx, n, dev)
        entry(f"CudaEC.double_k n={n} k={k}", lambda Pt=Pt, k=k: g.pec.double_k(Pt, k), 50)
    for NL, C, Mw in K8_SHAPES:
        F = ctx.fp if NL == 12 else fr
        d = _chains(F, C, Mw, C + Mw, dev)
        entry(f"chain_fwd ({C}, {NL}, {Mw})", lambda F=F, d=d: F.affine.chain_fwd(d), 20)
    for n in (16384, 262144):
        x = _rand(fr, n, n, dev).T.contiguous()
        x[:, :3] = fr.encode([1, 2, 3], dev).T                       # no zero lane
        entry(f"batch_inv_packed Fr n={n}", lambda x=x: fr.affine.batch_inv_packed(x), 10)
    # the setup's doubling: 22 layers of 12 doublings over the 4,096 Lagrange
    # points, then the whole table build (layers, one batched inversion)
    pts = get_settings(device="cuda").g1_lagrange_brp
    c = best_precomp_window(pts[0].shape[0])
    W = -(-255 // c) + 1

    def layers():
        cur = g.from_affine(pts)
        for _ in range(W - 1):
            cur = layer(cur, c)
        return cur

    res["setup layers (host clock)"] = {"call_ms": _host_ms(layers, 5), "layers": W - 1, "c": c}
    res["setup tables (host clock)"] = {"call_ms": _host_ms(lambda: PrecomputedMSM(g, pts), 3)}
    return res


def start_builds(build, out_dir: Path):
    """nvcc of the variants and of the multiply chain, started together:
    {name: (so, process)}."""
    from torch_scalar_mul_teams import start_mul_chain
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = {}
    cu = out_dir / "dk_fwd_variants.cu"
    cu.write_text(VARIANTS_CU)
    so = cu.with_suffix(".so")
    procs["variants"] = so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-Xptxas", "-v", "-o",
         str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    src, proc = start_mul_chain(out_dir)
    procs["mul_chain"] = src.with_suffix(".so"), proc
    return procs


def finish_builds(build, procs):
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 or not so.exists():
            print(f"[nvcc {name}] failed\n{log}", flush=True)
            return None
        for line in build.ptxas_summary(log):
            if name == "variants":
                print(f"[nvcc {name}] {line}", flush=True)
        lib = ctypes.CDLL(str(so))
        if name == "variants":
            lib.ctt_dk_at.argtypes = [P_] * 7 + [I_] * 4 + [P_]
            lib.ctt_dk_at.restype = I_
            lib.ctt_fwd_at.argtypes = [I_, I_, I_] + [P_] * 4 + [I_, I_, P_]
            lib.ctt_fwd_at.restype = I_
        libs[name] = lib
    return libs


def variants():
    build, get_curve = _import_port(HERE)
    from chip_smoke import device_ms
    from torch_scalar_mul_teams import mul_latency
    procs = start_builds(build, build.BUILD_DIR / "double_chain_fwd_teams")
    build.SOURCES = ("field_kernels", "ec_kernels")
    build.build_all(verbose=True)
    libs = finish_builds(build, procs)
    if libs is None:
        return 1
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ctx = get_curve("BLS12_381")
    fp, fr, pec = ctx.fp, ctx.fr, ctx.g1.pec
    lat_us, ok, _ = mul_latency(libs["mul_chain"], ctx, dev, True)
    print(f"fe_mul_eo: {lat_us:.4f} us a multiply in a lone thread's dependent chain "
          f"({'exact' if ok else 'DIFFERS'})", flush=True)
    lib = libs["variants"]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    # K3 double at a table layer and the tail's shapes
    for n, k in DK_SHAPES:
        P = _points(ctx, n, dev)
        port = pec.double_k(P, k)
        outs = tuple(torch.empty_like(v) for v in port)
        rows = [{"variant": "port (T = 4, 16 lanes)", "exact": True,
                 "device_ms": device_ms(torch, lambda: pec.double_k(P, k), 20)}]
        for label, T, lanes in DK_VARIANTS:
            def fn(T=T, lanes=lanes):
                check(lib.ctt_dk_at(fp.mod_ptr, *(v.data_ptr() for v in (*P, *outs)), n, k, T,
                                    lanes, stream()), label)
            fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, port))
            ok &= same
            rows.append({"variant": label, "exact": same, "device_ms": device_ms(torch, fn, 20),
                         "chain_floor_ms": DK_ROUNDS[T] * k * lat_us * 1e-3})
        print(f"K3 double n={n} k={k} (chain floor at T = 4: "
              f"{3 * k * lat_us * 1e-3:.4f} ms): {json.dumps(rows)}", flush=True)

    # K8 at the paths' shapes
    for NL, C, Mw in K8_SHAPES:
        F = fp if NL == 12 else fr
        d = _chains(F, C, Mw, C + Mw, dev)
        port = F.affine.chain_fwd(d)
        pe, bp = torch.empty_like(port[0]), torch.empty_like(port[1])
        ptrs = (d.data_ptr(), pe.data_ptr(), bp.data_ptr())
        S0, G0 = (2, 4) if Mw < CHAIN_FWD_WIDE else (4, 16)
        rows = [{"variant": f"port (S = {S0}, G = {G0})", "exact": True,
                 "device_ms": device_ms(torch, lambda: F.affine.chain_fwd(d), 20)}]
        fns = [(f"S = {S}, G = {G}" + (" (the plain scan)" if S == 1 else ""),
                lambda S=S, G=G: check(lib.ctt_fwd_at(NL, S, G, F.mod_ptr, *ptrs, C, Mw,
                                                      stream()), f"S {S} G {G}"))
               for S, G in K8_VARIANTS]
        fns.append(("one thread a lane (the parent's)", lambda: check(
            lib.ctt_fwd_at(NL, 0, 0, F.mod_ptr, *ptrs, C, Mw, stream()), "parent")))
        for label, fn in fns:
            pe.zero_()
            bp.zero_()
            fn()
            torch.cuda.synchronize()
            same = torch.equal(pe, port[0]) and torch.equal(bp, port[1])
            ok &= same
            rows.append({"variant": label, "exact": same, "device_ms": device_ms(torch, fn, 20)})
        print(f"K8 (C, NL, Mw) = ({C}, {NL}, {Mw}): {json.dumps(rows)}", flush=True)

    # K9 alone against K8 + K9 + K10
    for n in INV_LANES:
        x = _rand(fr, n, n, dev).T.contiguous()
        x[:, :3] = fr.encode([1, 2, 3], dev).T
        one = fr.affine.fermat_inv(x)
        same = torch.equal(one, fr.affine.batch_inv_packed(x))
        ok &= same
        print(f"Fr inversion of {n} lanes: fermat_inv alone device "
              f"{device_ms(torch, lambda: fr.affine.fermat_inv(x), 20)} ms, batch_inv_packed "
              f"(K8 + K9 + K10) device {device_ms(torch, lambda: fr.affine.batch_inv_packed(x), 20)}"
              f" ms ({'exact' if same else 'DIFFERS'})", flush=True)
    if not ok:
        print("a variant DIFFERS from the port's kernel", flush=True)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls-only", action="store_true")
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if args.calls_only:
        print(f"calls ({args.root}): {json.dumps(calls(args.root.resolve()))}", flush=True)
        return 0
    return variants()


if __name__ == "__main__":
    sys.exit(main())
