#!/usr/bin/env python3
"""K5 merge_scan's chunking and skips, and K13 g1_decompress's team size, on
one NVIDIA card.

    python3 scripts/torch_merge_scan_teams.py

K5. The port gives the runs of equal keys that start in a chunk of MS_CHUNK
slots of a lane to one team of SM_TEAM threads, which carries each run to
its end and computes an ec_add only where it changes the result
(csrc/ec.cuh merge_runs). This script builds, from copies of csrc/, the same
walk with the chunk Lc a launch argument (`ctt_merge_at`), once as the port
has it and once without the skips (every slot after a run's first adds
through ec_add_team, whose own selects give the same limbs), and the
parent's kernel, one thread a lane and an ec_add at every slot (Lc = 0). At
every merge stream the paths feed K5 (recorded from the entry points: the
fixed-base commit's two rounds, the online commit, the batch of 16 dense
blobs, the 2^16 MSM and the batch of 16 zero blobs) it holds every variant
exactly against the port's kernel and times it with CUDA events at Lc = K
(a team a lane), 8, 4, 2 and 1 (a team a run), and prints each stream's
(K2, M2), longest run of a key > 0, adds that need products, and most such
adds in a lane and in a run.

K13. Builds the port's team lane (csrc/g1.cuh g1_decompress_team) with a
team of 1, 2 and 4 threads a point (`ctt_g1_at`), and the parent's kernel,
one thread a point over fe_mul bit by bit (T = 0); holds each exactly
against the port's kernel at 2, 128 and 130 G1 points (seeded multiples
of G, half of them asking for the other root; both roots give a G1 point,
so ok must be 1 on every lane) and times them.

Prints ptxas's registers and spills of the built kernels. Exits non-zero if
a build fails, a variant differs (the row says DIFFERS) or the port's K13
ok is 0 on a lane (the line names the lanes). Needs the port beside it and
a CUDA card.
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

from chip_smoke import merge_work, record_merges  # noqa: E402
from constantine_tpu_torch import build  # noqa: E402

CHUNKS = (None, 8, 4, 2, 1)     # None: Lc = K, a team a lane
G1_TEAMS = (1, 2, 4)
P_, I_ = ctypes.c_void_p, ctypes.c_int

MERGE_CU = r"""
#include <cuda_runtime.h>
#include "ec.cuh"
using namespace ctt;

namespace {
constexpr int NL = 12, TEAM = 4, THREADS = 128, LANES = THREADS / TEAM;
constexpr int WORDS = 2 * TEAM * NL + 1;
using J = Jac<NL>;
using MD = Mod<NL>;

__global__ void __launch_bounds__(THREADS)
merge_chunks_kernel(MD md, const int* __restrict__ keys, const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                    uint32_t* __restrict__ ex, uint32_t* __restrict__ ey,
                    uint32_t* __restrict__ ez, int K, int M, int Lc, long long teams) {
  const int team = threadIdx.x / TEAM;
  const long long g = (long long)blockIdx.x * LANES + team;
  if (g >= teams) return;
  __shared__ uint32_t slots[LANES * WORDS];
  const int rank = threadIdx.x % TEAM;
  const unsigned mask = ((1u << TEAM) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, TEAM> tm{slots + team * WORDS, mask, rank};
  const int m = (int)(g % M), k0 = (int)(g / M) * Lc;
  merge_runs<NL>(tm, keys, qx, qy, qz, ex, ey, ez, K, M, m, k0, min(k0 + Lc, K), md);
}

__device__ void store_col(uint32_t* base, int M, const Fe<NL>& v) {
  for (int l = 0; l < NL; ++l) base[(size_t)l * M] = v.v[l];
}

// the parent's K5: one thread a lane, an ec_add and a select at every slot
__global__ void merge_thread_kernel(MD md, const int* __restrict__ keys,
                                    const uint32_t* __restrict__ qx,
                                    const uint32_t* __restrict__ qy,
                                    const uint32_t* __restrict__ qz, uint32_t* ex,
                                    uint32_t* ey, uint32_t* ez, int K, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  J acc = jac_infinity<NL>(md);
  int cur = -1;
  for (int k = 0; k < K; ++k) {
    const int kk = keys[(size_t)k * M + m];
    const size_t off = (size_t)k * NL * M + m;
    J Q{load_col<NL>(qx + off, M), load_col<NL>(qy + off, M), load_col<NL>(qz + off, M)};
    if (kk <= 0) Q.Z = fe_zero<NL>();
    acc = (kk == cur) ? ec_add<NL>(acc, Q, md) : Q;
    cur = kk;
    store_col(ex + off, M, acc.X);
    store_col(ey + off, M, acc.Y);
    store_col(ez + off, M, acc.Z);
  }
}
}  // namespace

// Lc > 0: a team per chunk of Lc slots; Lc = 0: one thread a lane.
extern "C" int ctt_merge_at(const uint32_t* w, const void* keys, const void* qx, const void* qy,
                            const void* qz, void* ex, void* ey, void* ez, int K, int M, int Lc,
                            void* stream) {
  const MD md = mod_from_words<NL>(w);
  const cudaStream_t s = (cudaStream_t)stream;
  if (Lc == 0) {
    merge_thread_kernel<<<(M + 127) / 128, 128, 0, s>>>(
        md, (const int*)keys, (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz,
        (uint32_t*)ex, (uint32_t*)ey, (uint32_t*)ez, K, M);
  } else {
    const long long teams = (long long)M * ((K + Lc - 1) / Lc);
    merge_chunks_kernel<<<(unsigned)((teams + LANES - 1) / LANES), THREADS, 0, s>>>(
        md, (const int*)keys, (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz,
        (uint32_t*)ex, (uint32_t*)ey, (uint32_t*)ez, K, M, Lc, teams);
  }
  return (int)cudaGetLastError();
}
"""

# merge_runs without the skips: every slot after a run's first loads its
# entry and adds it through ec_add_team.
NO_SKIP = (("    if (restart || kk > 0) {\n", "    {\n"),
           ("const bool add = !restart && !fe_is_zero<N>(Q.Z) && !fe_is_zero<N>(acc.Z);",
            "const bool add = !restart;"))

G1_CU = r"""
#include <cuda_runtime.h>
#include "g1.cuh"
using namespace ctt;

namespace {
constexpr int LANES = 16;   // points a block, whatever the team size

template <int kT>
__global__ void __launch_bounds__(LANES * kT)
g1_team_kernel(G1DecompressConsts C, const uint32_t* __restrict__ xm,
               const int32_t* __restrict__ sign, uint32_t* __restrict__ y,
               int32_t* __restrict__ ok, int n) {
  constexpr int WORDS = 2 * kT * FPN + 1, TAB = 15 * FPN;
  const int team = threadIdx.x / kT;
  const int i = blockIdx.x * LANES + team;
  if (i >= n) return;
  __shared__ uint32_t slots[LANES * WORDS];
  __shared__ __align__(16) uint32_t tabs[LANES * TAB];
  const int rank = threadIdx.x % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<FPN, kT> tm{slots + team * WORDS, mask, rank};
  Fp yi;
  const bool good = g1_decompress_team(tm, tabs + team * TAB, fp_load(xm + (size_t)i * FPN),
                                       sign[i] != 0, yi, C);
  g1_store_team(tm, y + (size_t)i * FPN, ok + i, yi, good);
}

// the parent's K13: one thread a point, g1_decompress_lane over fe_mul
__global__ void g1_thread_kernel(G1DecompressConsts C, const uint32_t* __restrict__ xm,
                                 const int32_t* __restrict__ sign, uint32_t* __restrict__ y,
                                 int32_t* __restrict__ ok, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp yi;
  const bool good = g1_decompress_lane(fp_load(xm + (size_t)i * FPN), sign[i] != 0, yi, C);
  fp_store(y + (size_t)i * FPN, yi);
  ok[i] = good ? 1 : 0;
}

template <int kT>
void launch(const G1DecompressConsts& C, const void* xm, const void* sign, void* y, void* ok,
            int n, cudaStream_t s) {
  g1_team_kernel<kT><<<(n + LANES - 1) / LANES, LANES * kT, 0, s>>>(
      C, (const uint32_t*)xm, (const int32_t*)sign, (uint32_t*)y, (int32_t*)ok, n);
}
}  // namespace

// T = 1, 2, 4: a team of T a point; T = 0: one thread a point.
extern "C" int ctt_g1_at(const void* consts, const void* xm, const void* sign, void* y, void* ok,
                         int n, int T, void* stream) {
  const G1DecompressConsts C = *(const G1DecompressConsts*)consts;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 0:
      g1_thread_kernel<<<(n + 63) / 64, 64, 0, s>>>(C, (const uint32_t*)xm,
                                                    (const int32_t*)sign, (uint32_t*)y,
                                                    (int32_t*)ok, n);
      break;
    case 1: launch<1>(C, xm, sign, y, ok, n, s); break;
    case 2: launch<2>(C, xm, sign, y, ok, n, s); break;
    case 4: launch<4>(C, xm, sign, y, ok, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def start_builds(out_dir: Path):
    """nvcc of the three variant libraries, all started together: {name:
    (so, process)}."""
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, text, patches in (("merge", MERGE_CU, ()), ("merge_noskip", MERGE_CU, NO_SKIP),
                                ("g1", G1_CU, ())):
        d = out_dir / name
        shutil.copytree(build.CSRC, d)
        ec = d / "ec.cuh"
        src = ec.read_text()
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"ec.cuh no longer holds {old!r}")
            src = src.replace(old, new)
        ec.write_text(src)
        cu = d / f"{name}_variants.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        if name == "g1":
            lib.ctt_g1_at.argtypes = [P_] * 5 + [I_, I_, P_]
            lib.ctt_g1_at.restype = I_
        else:
            lib.ctt_merge_at.argtypes = [P_] * 8 + [I_] * 3 + [P_]
            lib.ctt_merge_at.restype = I_
        libs[name] = lib
    return libs


def events_ms(f, reps):
    f()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        f()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def merge_streams(ctx, dev):
    """{label: [merge_scan inputs]} of the paths, recorded from the entry
    points on the EIP-4844 trusted setup."""
    from constantine_tpu_torch.models import eip4844
    from constantine_tpu_torch.models.kzg import get_kzg
    from constantine_tpu_torch.ops.msm import msm
    kzg, kzo = get_kzg(dev.type), get_kzg(dev.type, precompute=False)
    r, pec = ctx.r, ctx.g1.pec

    def blob(seed):
        rng = np.random.default_rng(seed)
        return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                        for _ in range(4096))

    n16 = 1 << 16
    tabx, taby = kzg._pm._tables
    krng = np.random.default_rng(65536)
    k16 = ctx.scalars_to_limbs([int.from_bytes(krng.bytes(32), "big") % r
                                for _ in range(n16)], dev)
    dense = [blob(s) for s in range(101, 117)]
    zero = bytes(eip4844.BYTES_PER_BLOB)
    out = {}
    for i, s in enumerate(record_merges(
            pec, lambda: eip4844.blob_to_kzg_commitment(dense[0], kzg))):
        out[f"commit round {i + 1}"] = s
    for label, fn in (("online commit", lambda: eip4844.blob_to_kzg_commitment(dense[0], kzo)),
                      ("batch 16 dense", lambda: eip4844.blob_to_kzg_commitment_batch(dense,
                                                                                     kzg)),
                      ("msm 2^16", lambda: msm(ctx.g1, (tabx[:n16], taby[:n16]), k16)),
                      ("batch 16 zero blobs",
                       lambda: eip4844.blob_to_kzg_commitment_batch([zero] * 16, kzg))):
        for i, s in enumerate(record_merges(pec, fn)):
            out[label if i == 0 else f"{label} round {i + 1}"] = s
    return out


def g1_inputs(ctx, n, dev):
    """Montgomery x and sign of n seeded G1 points [k]G; odd lanes ask for
    the other root."""
    from constantine_tpu_torch.utils import refmath as rm
    rng = np.random.default_rng(n)
    pts = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 62, size=n)]
    half = (ctx.p + 1) // 2
    sign = torch.tensor([(q[1] >= half) != (i % 2 == 1) for i, q in enumerate(pts)],
                        dtype=torch.int32, device=dev)
    return ctx.fp.encode([q[0] for q in pts], dev), sign


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    procs = start_builds(build.BUILD_DIR / "merge_teams")
    build.build_all(verbose=True)
    libs = finish_builds(procs)
    if libs is None:
        return 1
    from constantine_tpu_torch.named.precompute import get_curve
    from constantine_tpu_torch.ops.cuda_g1 import get_cuda_g1
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    pec = ctx.g1.pec
    mod = ctypes.c_void_p(ctx.fp.mod_words.ctypes.data)
    sid = torch.cuda.current_stream(dev).cuda_stream
    ok = True
    for label, (keys, qx, qy, qz) in merge_streams(ctx, dev).items():
        K, M = keys.shape
        port = pec.merge_scan(keys, qx, qy, qz)
        outs = tuple(torch.empty_like(w) for w in port)

        def variant(lib, Lc):
            rc = lib.ctt_merge_at(mod, *map(build.ptr, (keys, qx, qy, qz, *outs)), K, M, Lc, sid)
            if rc != 0:
                raise RuntimeError(f"ctt_merge_at Lc={Lc}: CUDA error {rc}")

        row = [f"port {events_ms(lambda: pec.merge_scan(keys, qx, qy, qz), 20):.4f}"]
        for name, tag in (("merge", "skips"), ("merge_noskip", "no skips")):
            for Lc in (c or K for c in CHUNKS):
                variant(libs[name], Lc)
                torch.cuda.synchronize()
                exact = all(torch.equal(a, b) for a, b in zip(outs, port))
                ok &= exact
                row.append(f"{tag} Lc={Lc} {events_ms(lambda: variant(libs[name], Lc), 20):.4f}"
                           + ("" if exact else " DIFFERS"))
        variant(libs["merge"], 0)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(outs, port))
        ok &= exact
        row.append(f"one thread a lane (the parent's) "
                   f"{events_ms(lambda: variant(libs['merge'], 0), 5):.4f}"
                   + ("" if exact else " DIFFERS"))
        longest, adds, lane_max, run_max = merge_work(keys, qz, port[2])
        print(f"merge_scan {label} K2={K} M2={M}: longest run {longest} (key > 0), {adds} adds "
              f"with products, at most {lane_max} a lane and {run_max} a run; ms a call (CUDA "
              "events), each variant against the port's kernel: " + ", ".join(row), flush=True)
    g1d = get_cuda_g1()
    consts = ctypes.c_void_p(g1d._consts.ctypes.data)
    for n in (2, 128, 130):
        xm, sign = g1_inputs(ctx, n, dev)
        y, okb = g1d.decompress_mont(xm, sign)
        bad = (~okb.bool()).nonzero().flatten().tolist()
        ok &= not bad
        yv = torch.empty_like(y)
        okv = torch.empty((n,), dtype=torch.int32, device=dev)

        def g1_variant(T):
            rc = libs["g1"].ctt_g1_at(consts, *map(build.ptr, (xm, sign, yv, okv)), n, T, sid)
            if rc != 0:
                raise RuntimeError(f"ctt_g1_at T={T}: CUDA error {rc}")

        row = [f"port {events_ms(lambda: g1d.decompress_mont(xm, sign), 5):.4f}"]
        for T in (*G1_TEAMS, 0):
            g1_variant(T)
            torch.cuda.synchronize()
            exact = torch.equal(yv, y) and torch.equal(okv.bool(), okb)
            ok &= exact
            name = f"T={T}" if T else "one thread (the parent's)"
            row.append(f"{name} {events_ms(lambda: g1_variant(T), 5):.4f}"
                       + ("" if exact else " DIFFERS"))
        print(f"g1_decompress n={n}: ms a call (CUDA events), each variant against the port's "
              "kernel: " + ", ".join(row)
              + (f"; FAILED: the port's ok is 0 on lanes {bad} of these G1 points" if bad else ""),
              flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
