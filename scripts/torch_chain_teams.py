#!/usr/bin/env python3
"""K1 mont_prod's chains and K10 chain_bwd_inv's scan, on one NVIDIA card.

    python3 scripts/torch_chain_teams.py                 # everything
    python3 scripts/torch_chain_teams.py --calls-only --root DIR

K1. The port computes a chain (f0 ... f_{m-1})^(2^k) in one launch, a thread
an element over fe_mul_eo, K1_THREADS = 64 a block, 16-byte loads, a
broadcast factor read in place (csrc/field_kernels.cu). This script builds
field_kernels.cu again from copies of csrc/ patched to fe_mul and to 128
and 256 threads a block, holds each exactly against the port's kernel, and
times it (the device's time: calls queued behind a sleeping kernel) at the
setup's n = 90,112 (m = 2) and at z^N's n = 1 (m = 1, k = 12).

K10. The port runs the backward chain as a suffix scan in shared memory,
G = 4 (Fr) or 8 (Fp) lanes a block, a thread a link (csrc/chain.cuh).
Built here:
  A  the port's scan, and at G = 4, 8, 16, 32 lanes a block (copies of
     csrc/ patched);
  B  a Blelloch scan: an up-sweep and a down-sweep in place, 2 (C - 1)
     products a lane, 2 log2 C + 2 deep (power-of-two C);
  C  a team of T = 2 or 4 threads a lane walking the chain, a step's two
     products side by side (ec.cuh SmTeam, mul_level);
  D  the parent's kernel: one thread a lane walking the chain, 2C deep.
At the paths' Fr (C, NL, Mw) = (32, 8, 512) and (32, 8, 8,192) and the
setup's Fp (32, 12, 3,072), each exact against the port's kernel, timed on
the device.

--calls-only times, through whichever port lies at --root (this tree or an
unpacked copy of another commit), Field.mul at n = 1, 16, 4,096 and 90,112,
z^N of one Fr element (Field.prod(z, squarings=12) where the tree has it,
else 12 Field.square calls) and CudaAffine.chain_bwd_inv at the three
shapes: host-clock ms a call (synchronised), the host's ms to enqueue a
call (calls back to back, the wrapper's cost) and the device's ms a call. It
builds only field_kernels.cu. Prints one JSON line ("calls: {...}").

Prints ptxas's registers and spills of every kernel built. Exits non-zero
if a build fails or a variant differs. Needs a CUDA card.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
P_, I_ = ctypes.c_void_p, ctypes.c_int
K10_SHAPES = ((8, 32, 512), (8, 32, 8192), (12, 32, 3072))    # (NL, C, Mw)
THREADS = "constexpr int K1_THREADS = 64;"
CHAIN_G = "static constexpr int value = N == 8 ? 4 : 8;"
# field_kernels.cu patched: (text, replacement)
PATCHES = {"fe_mul": ("fe_mul_eo<N>(", "fe_mul<N>("),
           "threads 128": (THREADS, THREADS.replace("64", "128")),
           "threads 256": (THREADS, THREADS.replace("64", "256")),
           **{f"G {g}": (CHAIN_G, f"static constexpr int value = {g};") for g in (4, 8, 16, 32)}}

CHAIN_CU = r"""
#include <cuda_runtime.h>
#include "chain.cuh"
#include "ec.cuh"
using namespace ctt;

namespace {
constexpr int B_G = 16, TEAM_THREADS = 128;

// B: Blelloch over r = C - 1 - c (a suffix over c is a prefix over r),
// in place in one buffer; C a power of two.
template <int N>
__global__ void __launch_bounds__(B_G * CHAIN_MAX_C)
blelloch_kernel(Mod<N> md, const uint32_t* pe, const uint32_t* d, const uint32_t* bpinv,
                uint32_t* inv, int C, int Mw) {
  extern __shared__ uint32_t tile[];
  const int g = threadIdx.x, c = threadIdx.y, m = blockIdx.x * B_G + g, r = C - 1 - c;
  const bool live = m < Mw;
  const size_t link = (size_t)N * Mw;
  auto at = [&](int rr) { return chain_slot(tile, 0, rr, C, N, B_G); };
  if (live) store_lane<N>(at(r), B_G, g, load_lane<N>(d + c * link, Mw, m));
  __syncthreads();
  const int L = chain_levels(C);
  for (int u = 0; u < L; ++u) {
    const int s = 2 << u;
    if (live && (r + 1) % s == 0) {
      const Fe<N> a = load_lane<N>(at(r - s / 2), B_G, g), b = load_lane<N>(at(r), B_G, g);
      store_lane<N>(at(r), B_G, g, fe_mul<N>(a, b, md));
    }
    __syncthreads();
  }
  if (live && r == C - 1) store_lane<N>(at(r), B_G, g, fe_one<N>(md));
  __syncthreads();
  for (int u = L - 1; u >= 0; --u) {
    const int s = 2 << u;
    if (live && (r + 1) % s == 0) {
      const Fe<N> t = load_lane<N>(at(r - s / 2), B_G, g), b = load_lane<N>(at(r), B_G, g);
      store_lane<N>(at(r - s / 2), B_G, g, b);
      store_lane<N>(at(r), B_G, g, fe_mul<N>(t, b, md));
    }
    __syncthreads();
  }
  if (!live) return;
  const Fe<N> x = fe_mul<N>(load_lane<N>(bpinv, Mw, m), load_lane<N>(at(r), B_G, g), md);
  store_lane<N>(inv + c * link, Mw, m, fe_mul<N>(x, load_lane<N>(pe + c * link, Mw, m), md));
}

// C: a team of T a lane walks the chain, a step's two products in one level.
template <int N, int T>
__global__ void __launch_bounds__(TEAM_THREADS)
team_kernel(Mod<N> md, const uint32_t* pe, const uint32_t* d, const uint32_t* bpinv,
            uint32_t* inv, int C, int Mw) {
  constexpr int LANES = TEAM_THREADS / T, WORDS = 2 * T * N + 1;
  __shared__ uint32_t slots[LANES * WORDS];
  const int team = threadIdx.x / T, rank = threadIdx.x % T;
  const int m = blockIdx.x * LANES + team;
  if (m >= Mw) return;  // a whole team
  const unsigned mask = ((1u << T) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<N, T> tm{slots + team * WORDS, mask, rank};
  const size_t link = (size_t)N * Mw;
  Fe<N> run = load_lane<N>(bpinv, Mw, m);
  for (int c = C - 1; c >= 0; --c) {
    Fe<N> out[2];
    mul_level<N, 2>(tm, {run, run},
                    {load_lane<N>(pe + c * link, Mw, m), load_lane<N>(d + c * link, Mw, m)},
                    out, md);
    if (rank == 0) store_lane<N>(inv + c * link, Mw, m, out[0]);
    run = out[1];
  }
}

// D: the parent's kernel.
template <int N>
__global__ void parent_kernel(Mod<N> md, const uint32_t* __restrict__ pe,
                              const uint32_t* __restrict__ d,
                              const uint32_t* __restrict__ bpinv, uint32_t* __restrict__ inv,
                              int C, int Mw) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mw) return;
  Fe<N> run = load_lane<N>(bpinv, Mw, m);
  for (int c = C - 1; c >= 0; --c) {
    const size_t off = (size_t)c * N * Mw;
    store_lane<N>(inv + off, Mw, m, fe_mul<N>(run, load_lane<N>(pe + off, Mw, m), md));
    run = fe_mul<N>(run, load_lane<N>(d + off, Mw, m), md);
  }
}

template <int N>
int launch(int variant, const uint32_t* w, const uint32_t* pe, const uint32_t* d,
           const uint32_t* bpinv, uint32_t* inv, int C, int Mw, int T, cudaStream_t s) {
  const Mod<N> md = mod_from_words<N>(w);
  if (variant == 1) {
    if (C & (C - 1)) return (int)cudaErrorInvalidValue;
    const int smem = (int)(chain_tile_words(C, N, B_G) / 2 * sizeof(uint32_t));
    cudaFuncSetAttribute(blelloch_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    blelloch_kernel<N><<<(Mw + B_G - 1) / B_G, dim3(B_G, C), smem, s>>>(md, pe, d, bpinv, inv,
                                                                         C, Mw);
  } else if (variant == 2) {
    const int lanes = TEAM_THREADS / T, grid = (Mw + lanes - 1) / lanes;
    if (T == 2)
      team_kernel<N, 2><<<grid, TEAM_THREADS, 0, s>>>(md, pe, d, bpinv, inv, C, Mw);
    else if (T == 4)
      team_kernel<N, 4><<<grid, TEAM_THREADS, 0, s>>>(md, pe, d, bpinv, inv, C, Mw);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    parent_kernel<N><<<(Mw + 127) / 128, 128, 0, s>>>(md, pe, d, bpinv, inv, C, Mw);
  }
  return (int)cudaGetLastError();
}
}  // namespace

// variant 1 B, 2 C (a team of T), 0 D.
extern "C" int ctt_chain_at(int nl, int variant, const uint32_t* w, const void* pe, const void* d,
                            const void* bpinv, void* inv, int C, int Mw, int T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  if (nl == 8) return launch<8>(variant, w, u(pe), u(d), u(bpinv), (uint32_t*)inv, C, Mw, T, s);
  if (nl == 12)
    return launch<12>(variant, w, u(pe), u(d), u(bpinv), (uint32_t*)inv, C, Mw, T, s);
  return (int)cudaErrorInvalidValue;
}
"""

K10_VARIANTS = (("A: scan, G = 4 (Fr) / 8 (Fp) (port)", None, None),
                ("A: scan, G = 4", "G 4", None), ("A: scan, G = 8", "G 8", None),
                ("A: scan, G = 16", "G 16", None), ("A: scan, G = 32", "G 32", None), ("B: Blelloch, G = 16", "chain", (1, 0)),
                ("C: a team of 2 a lane", "chain", (2, 2)),
                ("C: a team of 4 a lane", "chain", (2, 4)),
                ("D: one thread a lane (the parent's)", "chain", (0, 0)))


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
    """The tree's public calls, timed: {label: {"call_ms", "device_ms"}}."""
    build, get_curve = _import_port(root)
    from chip_smoke import device_ms, enqueue_ms
    build.SOURCES = ("field_kernels",)
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"field_kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    fp, fr = ctx.fp, ctx.fr
    res = {}

    def entry(label, fn, reps):
        res[label] = {"call_ms": _host_ms(fn, reps), "enqueue_ms": enqueue_ms(torch, fn, reps),
                      "device_ms": device_ms(torch, fn, reps)}

    for n in (1, 16, 4096, 90112):
        a, b = _rand(fp, n, n, dev), _rand(fp, n, n + 1, dev)
        entry(f"Fp mul n={n}", lambda a=a, b=b: fp.mul(a, b), 50)
    z = _rand(fr, 1, 3, dev)
    if hasattr(fr, "prod"):
        zn = lambda: fr.prod(z, squarings=12)  # noqa: E731
    else:
        def zn():
            x = z
            for _ in range(12):
                x = fr.square(x)
            return x
    entry("Fr z^N (n=1)", zn, 50)
    for NL, C, Mw in K10_SHAPES:
        F = fp if NL == 12 else fr
        pe, d = (_rand(F, C * Mw, s, dev).T.reshape(NL, C, Mw).transpose(0, 1).contiguous()
                 for s in (C, Mw))
        bpinv = _rand(F, Mw, 9, dev).T.contiguous()
        entry(f"chain_bwd_inv ({C}, {NL}, {Mw})",
              lambda F=F, pe=pe, d=d, b=bpinv: F.affine.chain_bwd_inv(pe, d, b), 20)
    return res


def start_builds(build, out_dir: Path):
    """nvcc of field_kernels.cu from each patched copy of csrc/ and of the
    K10 variants, started together: {name: (so, process)}."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = {}
    for name, (text, repl) in PATCHES.items():
        d = out_dir / name.replace(" ", "_")
        shutil.copytree(build.CSRC, d)
        cu = d / "field_kernels.cu"
        src = cu.read_text()
        if text not in src:
            raise RuntimeError(f"patch {name!r}: {text!r} is not in field_kernels.cu")
        cu.write_text(src.replace(text, repl))
        so = d / "field_kernels.so"
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cu = out_dir / "chain_variants.cu"
    cu.write_text(CHAIN_CU)
    so = cu.with_suffix(".so")
    procs["chain"] = so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-Xptxas", "-v", "-o",
         str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_builds(build, procs):
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 or not so.exists():
            print(f"[nvcc {name}] failed\n{log}", flush=True)
            return None
        for line in build.ptxas_summary(log):
            if name == "chain" or "mont_mul" in line or "chain_bwd" in line:
                print(f"[nvcc {name}] {line}", flush=True)
        lib = ctypes.CDLL(str(so))
        if name == "chain":
            lib.ctt_chain_at.argtypes = [I_, I_] + [P_] * 5 + [I_] * 3 + [P_]
            lib.ctt_chain_at.restype = I_
        else:
            fn = lib.ctt_mont_prod
            fn.argtypes = [I_, P_, I_, I_] + [P_] * 4 + [I_] * 4 + [P_, I_, P_]
            fn.restype = I_
            fn = lib.ctt_chain_bwd_inv
            fn.argtypes = [I_] + [P_] * 5 + [I_, I_, P_]
            fn.restype = I_
        libs[name] = lib
    return libs


def variants():
    build, get_curve = _import_port(HERE)
    from chip_smoke import device_ms
    procs = start_builds(build, build.BUILD_DIR / "chain_teams")
    build.SOURCES = ("field_kernels",)
    build.build_all(verbose=True)
    libs = finish_builds(build, procs)
    if libs is None:
        return 1
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ctx = get_curve("BLS12_381")
    fp, fr = ctx.fp, ctx.fr
    ok = True

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    # K1: m = 2 at n = 90,112 over Fp; m = 1, k = 12 at n = 1 over Fr
    for F, m, k, n in ((fp, 2, 0, 90112), (fr, 1, 12, 1), (fp, 4, 0, 90112)):
        fs = [_rand(F, n, 100 + j, dev) for j in range(m)]
        port = F.prod(*fs, squarings=k)
        rows = []

        def launch(lib, out, fs=fs, m=m, k=k, n=n, F=F):
            ptrs = [f.data_ptr() for f in fs] + [0] * (4 - m)
            check(lib.ctt_mont_prod(F.NL, F.mod_ptr, m, k, *ptrs, *([n] * 4), out.data_ptr(), n,
                                    stream()), "ctt_mont_prod")
        for name in ("port", "fe_mul", "threads 128", "threads 256"):
            out = torch.empty_like(port)
            fn = ((lambda: F.prod(*fs, squarings=k)) if name == "port"
                  else (lambda lib=libs[name], out=out: launch(lib, out)))
            fn()
            same = name == "port" or torch.equal(out, port)
            ok &= same
            rows.append({"variant": name, "exact": same, "device_ms": device_ms(torch, fn, 50)})
        print(f"K1 m={m} k={k} n={n} ({F.name}): {json.dumps(rows)}", flush=True)

    # K10 at the paths' shapes
    for NL, C, Mw in K10_SHAPES:
        F = fp if NL == 12 else fr
        pe, d = (_rand(F, C * Mw, s, dev).T.reshape(NL, C, Mw).transpose(0, 1).contiguous()
                 for s in (C, Mw))
        bpinv = _rand(F, Mw, 9, dev).T.contiguous()
        port = F.affine.chain_bwd_inv(pe, d, bpinv)
        ptrs = [t.data_ptr() for t in (pe, d, bpinv)]
        rows = []
        for label, lib, how in K10_VARIANTS:
            out = torch.empty_like(port)
            if lib is None:
                fn = lambda: F.affine.chain_bwd_inv(pe, d, bpinv)  # noqa: E731
            elif how is None:
                fn = (lambda lib=libs[lib], out=out: check(lib.ctt_chain_bwd_inv(
                    NL, F.mod_ptr, *ptrs, out.data_ptr(), C, Mw, stream()), label))
            else:
                fn = (lambda lib=libs[lib], out=out, how=how: check(lib.ctt_chain_at(
                    NL, how[0], F.mod_ptr, *ptrs, out.data_ptr(), C, Mw, how[1], stream()),
                    label))
            fn()
            torch.cuda.synchronize()
            same = lib is None or torch.equal(out, port)
            ok &= same
            rows.append({"variant": label, "exact": same, "device_ms": device_ms(torch, fn, 20)})
        print(f"K10 (C, NL, Mw) = ({C}, {NL}, {Mw}): {json.dumps(rows)}", flush=True)
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
