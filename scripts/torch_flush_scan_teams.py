#!/usr/bin/env python3
"""K4 flush_scan's team size and chunking, on one NVIDIA card.

    python3 scripts/torch_flush_scan_teams.py

The port's K4 gives each lane of the key-sorted stream one team of SM_TEAM
threads that walks its K steps (csrc/ec.cuh flush_lane). The scan restarts
at every change of key, so a lane is really a chain per run of equal keys,
and runs could be spread over more teams. This script measures whether that
pays. It builds ec_kernels.cu from a copy of csrc/ with a variant kernel
added, `ctt_flush_scan_at(..., Lc, T)`: a team of T threads (2 or 4) owns a
chunk of Lc steps of one lane, finds the chunk's first run start (step 0 or
a key unlike the one before) and carries every run that starts in the
chunk to its end, past the chunk if need be, so every slot is written once
and equals the sequential scan's. Lc = K is the port's walk of a lane.

At every path's flush stream (the fixed-base commit (K, M) = (184, 512),
the online commit (120, 1,024), the batch of 16 dense blobs (1,472, 1,024),
the 2^16 MSM (1,408, 1,024) and a batch of 16 zero blobs, whose lanes are
one run each) it holds every (Lc in K, 64, 32, 16) x (T in 2, 4) variant
exactly against the port's kernel and times both with CUDA events, and
prints each stream's longest run. On the dense batch it also times the
variants with every gap-key entry (a zero digit) made a run of its own, as
if K4 skipped the slots the compaction never reads: timing only, not exact
by design. Prints ptxas's registers and spills of the built kernels.

Exits non-zero if the build fails or a variant differs. Needs the port
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

from constantine_tpu_torch import build  # noqa: E402
from constantine_tpu_torch.models import eip4844  # noqa: E402
from constantine_tpu_torch.models.kzg import get_kzg  # noqa: E402
from constantine_tpu_torch.named.precompute import get_curve  # noqa: E402
from constantine_tpu_torch.ops import limbs as lb  # noqa: E402
from constantine_tpu_torch.ops import msm_gpu  # noqa: E402
from constantine_tpu_torch.ops.msm import _apply_glv, _glv_for_group, _signed_digits  # noqa: E402

TEAMS = (2, 4)
CHUNKS = (None, 64, 32, 16)     # None: Lc = K
P_, I_ = ctypes.c_void_p, ctypes.c_int

# Appended to the copy of ec_kernels.cu: K4 with a team of kT threads per
# chunk of Lc steps of a lane, each team carrying the runs that start in
# its chunk.
VARIANT_CU = r"""
namespace {

// The lowest rank of the team whose f is true, or -1.
template <int kT>
__device__ __forceinline__ int team_first(const SmTeam<NL, kT>& tm, bool f) {
  const unsigned b = __ballot_sync(tm.mask, f) & tm.mask;
  return b ? __ffs(b) - __ffs(tm.mask) : -1;
}

template <int kT>
__device__ void flush_chunk(SmTeam<NL, kT>& tm, const int32_t* keys, const uint32_t* xy,
                            uint32_t* ex, uint32_t* ey, uint32_t* ez, int K, int nl, int m,
                            int k0, int k1, const MD& M) {
  const size_t snl = (size_t)nl;
  int s = -1;
  for (int b = k0; b < k1 && s < 0; b += kT) {
    const int k = b + tm.rank;
    const bool start = k < k1 && (k == 0 || keys[k * snl + m] != keys[(k - 1) * snl + m]);
    const int f = team_first(tm, start);
    if (f >= 0) s = b + f;
  }
  if (s < 0) return;
  J acc = jac_infinity<NL>(M);
  int key = keys[s * snl + m];
  const uint32_t* e = xy + s * 2 * NL * snl + m;
  F X2 = load_col<NL>(e, snl), Y2 = load_col<NL>(e + NL * snl, snl);
  bool restart = true;
  for (int k = s;; ++k) {
    const int kn = k + 1 < K ? k + 1 : k;
    const int nkey = keys[kn * snl + m];
    const uint32_t* en = xy + kn * 2 * NL * snl + m;
    const F nX = load_col<NL>(en, snl), nY = load_col<NL>(en + NL * snl, snl);
    acc = ec_madd_team<NL>(tm, jac_sel<NL>(restart, jac_infinity<NL>(M), acc), X2, Y2, M);
    const size_t o = k * NL * snl + m;
    store_split<NL>(tm, ex + o, ey + o, ez + o, snl, acc);
    restart = nkey != key;
    if (k + 1 >= K || (restart && k + 1 >= k1)) break;
    key = nkey;
    X2 = nX;
    Y2 = nY;
  }
}

template <int kT>
__global__ void __launch_bounds__(FS_THREADS)
flush_chunks_kernel(MD md, const int* __restrict__ keys, const uint32_t* __restrict__ xy,
                    uint32_t* __restrict__ ex, uint32_t* __restrict__ ey,
                    uint32_t* __restrict__ ez, int K, int M, int Lc, long long teams) {
  constexpr int LANES = FS_THREADS / kT;
  constexpr int WORDS = 2 * kT * NL + 1;
  const int team = threadIdx.x / kT;
  const long long g = (long long)blockIdx.x * LANES + team;
  if (g >= teams) return;
  __shared__ uint32_t slots[LANES * WORDS];
  const int rank = threadIdx.x % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, kT> tm{slots + team * WORDS, mask, rank};
  const int m = (int)(g % M), k0 = (int)(g / M) * Lc;
  flush_chunk<kT>(tm, keys, xy, ex, ey, ez, K, M, m, k0, min(k0 + Lc, K), md);
}

template <int kT>
int launch_chunks(MD md, const void* keys, const void* xy, void* ex, void* ey, void* ez,
                  int K, int M, int Lc, cudaStream_t stream) {
  constexpr int LANES = FS_THREADS / kT;
  const long long teams = (long long)M * ((K + Lc - 1) / Lc);
  flush_chunks_kernel<kT><<<(unsigned)((teams + LANES - 1) / LANES), FS_THREADS, 0,
                            stream>>>(md, (const int*)keys, (const uint32_t*)xy,
                                      (uint32_t*)ex, (uint32_t*)ey, (uint32_t*)ez, K, M,
                                      Lc, teams);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ctt_flush_scan_at(const uint32_t* mod_words, const void* keys, const void* xy,
                                 void* ex, void* ey, void* ez, int K, int M, int Lc, int T,
                                 void* stream) {
  if (M <= 0 || K <= 0 || Lc <= 0) return (int)cudaErrorInvalidValue;
  const MD md = mod_from_words<NL>(mod_words);
  if (T == 2) return launch_chunks<2>(md, keys, xy, ex, ey, ez, K, M, Lc, (cudaStream_t)stream);
  if (T == 4) return launch_chunks<4>(md, keys, xy, ex, ey, ez, K, M, Lc, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
"""


def build_variant(out_dir: Path):
    """ec_kernels.cu from a copy of csrc/ with VARIANT_CU appended; its CDLL."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(build.CSRC, out_dir)
    src = out_dir / "ec_kernels.cu"
    src.write_text(src.read_text() + VARIANT_CU)
    so = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(so), str(src)], capture_output=True, text=True, timeout=900)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(f"[nvcc] failed\n{log}", flush=True)
        return None
    for line in build.ptxas_summary(log):
        if "flush" in line:
            print(f"[nvcc] {line}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.ctt_flush_scan_at.argtypes = [P_] * 6 + [I_] * 4 + [P_]
    lib.ctt_flush_scan_at.restype = I_
    return lib


def dense_blob(seed: int, r: int) -> bytes:
    """Same recipe as tests/test_torch_eip4844.py:dense_blob."""
    rng = np.random.default_rng(seed)
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


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


def longest_run(keys):
    """Steps of the longest run of equal keys down a lane of (K, M) keys."""
    kn = keys.cpu().numpy().T
    start = np.ones_like(kn, dtype=bool)
    start[:, 1:] = kn[:, 1:] != kn[:, :-1]
    return int(np.bincount(np.cumsum(start.reshape(-1))).max())


def streams(ctx, dev):
    """{label: FlushStream} of every path's flush, as chip_smoke.py builds them."""
    kzg, kzo = get_kzg(dev.type), get_kzg(dev.type, precompute=False)
    pm = kzg._pm
    g, F, r = ctx.g1, ctx.fp, ctx.r
    tabx, taby = pm._tables

    def batch(blob_list):
        polys = lb.to_tensor(np.stack([eip4844.blob_to_polynomial(b)[0] for b in blob_list]),
                             dev)
        B, N, NLr = polys.shape
        rows = _signed_digits(polys.reshape(B * N, NLr), pm.c, pm.W)
        rows = rows.reshape(pm.W, B, N).transpose(0, 1).reshape(B, pm.W * N)
        return msm_gpu._flush_stream(F, pm._tables, rows, pm.c)

    def online(pts, k):
        gp, gk, gb = _apply_glv(g, _glv_for_group(g.name), pts, k)
        c = msm_gpu.best_window_tpu(gp[0].shape[0], gb)
        return msm_gpu._flush_stream(F, gp, _signed_digits(gk, c, msm_gpu._cdiv(gb + 1, c)), c)

    poly = lb.to_tensor(eip4844.blob_to_polynomial(dense_blob(1, r))[0], dev)
    n16 = 1 << 16
    krng = np.random.default_rng(65536)
    k16 = ctx.scalars_to_limbs([int.from_bytes(krng.bytes(32), "big") % r
                                for _ in range(n16)], dev)
    return {
        "commit": msm_gpu._flush_stream(
            F, (tabx, taby), _signed_digits(poly, pm.c, pm.W).reshape(1, -1), pm.c),
        "online commit": online(kzo.s.g1_lagrange_brp, poly),
        "batch 16 dense": batch([dense_blob(s, r) for s in range(101, 117)]),
        "msm 2^16": online((tabx[:n16], taby[:n16]), k16),
        "batch 16 zero blobs": batch([bytes(eip4844.BYTES_PER_BLOB)] * 16),
    }


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    lib = build_variant(build.BUILD_DIR / "flush_teams")
    if lib is None:
        return 1
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    fs = streams(ctx, dev)
    pec = ctx.g1.pec
    mod = ctypes.c_void_p(ctx.fp.mod_words.ctypes.data)
    ok = True
    for label, st in fs.items():
        K, M, keys, xy = st.K, st.M, st.skT, st.st
        port = pec.flush_scan(keys, xy)
        outs = tuple(torch.empty_like(w) for w in port)
        sid = torch.cuda.current_stream(dev).cuda_stream

        def variant(Lc, T, keys=keys):
            rc = lib.ctt_flush_scan_at(mod, *map(build.ptr, (keys, xy, *outs)), K, M, Lc, T, sid)
            if rc != 0:
                raise RuntimeError(f"ctt_flush_scan_at Lc={Lc} T={T}: CUDA error {rc}")

        row = [f"port {events_ms(lambda: pec.flush_scan(keys, xy), 5):.4f}"]
        for T in TEAMS:
            for Lc in (c or K for c in CHUNKS):
                variant(Lc, T)
                torch.cuda.synchronize()
                exact = all(torch.equal(a, b) for a, b in zip(outs, port))
                ok &= exact
                row.append(f"T={T} Lc={Lc} {events_ms(lambda: variant(Lc, T), 3):.4f}"
                           + ("" if exact else " DIFFERS"))
        print(f"flush_scan {label} K={K} M={M}, longest run {longest_run(keys)} steps; ms a "
              "call (CUDA events), each variant against the port's kernel: " + ", ".join(row),
              flush=True)
        if label == "batch 16 dense":
            gap = keys % (st.H + 1) == 0
            solo = torch.where(gap, -1 - torch.arange(keys.numel(), device=dev,
                                                      dtype=keys.dtype).reshape(keys.shape),
                               keys)
            row = [f"T=4 Lc={Lc} {events_ms(lambda: variant(Lc, 4, solo), 3):.4f}"
                   for Lc in (c or K for c in CHUNKS)]
            print(f"flush_scan {label} without its gap-key runs (timing only; longest run "
                  f"{longest_run(solo)} steps): " + ", ".join(row), flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
