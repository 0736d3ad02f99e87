#!/usr/bin/env python3
"""K6 bucket_reduce's teams and K3′ ntt_stages' tiles, on one NVIDIA card.

    python3 scripts/torch_bucket_reduce_ntt_teams.py

K6. The port runs a lane's two adds a step side by side, two teams of
SM_TEAM threads a lane, the run handed from one to the other through shared
memory (csrc/ec.cuh bucket_lane). This script builds, from a copy of csrc/,
K6 four ways (`ctt_br_at`):
  A  two teams of T a lane, one an add (the port's design; T = 4, 2, 1);
  B  one team of T doing both adds' levels as one level of 8, 8, 6, 6 and 4
     products (T = 4, 8), each add on its own where the other is a select;
  C  one team of 4 doing the two adds one after the other;
  D  the parent's kernel, one thread a lane over ec_add (fe_mul).
At every (T, lanes) the paths reach at T = 4, 8 and 16 (recorded from the
entry points: the fixed-base commit, T = 4 over 512 lanes; the online
commit, 4 over 960; the 2^16 MSM, 8 over 2,816; the batch of 16, 16 over
2,048), with lane 0 B1 = B0, lane 1 B1 = -B0 and lane 2 B2 at infinity, it
holds every variant exactly against the port's kernel, times it with CUDA
events and prints the chain floor: (T - 1) steps x 5 rounds x fe_mul_eo's
latency in a lone thread (the chain kernel of
scripts/torch_scalar_mul_teams.py, built beside).

K3′. Times ntt_stages, one launch a pass, at tiles of 1, 2, 4 and 8 lanes
(where the lanes allow), against the per-stage route (the gather, then one
ntt_bfly launch a stage, the pass's factors as K1 products and its
transposed store as a copy around them), at every pass the PeerDAS paths
run, with its factors (recorded from compute_cells, the FK20 NTT, the cell
iNTT and a coset transform), each exact against the port's NTTDomain pass;
CUDA events per call, and each route's device time a call (its calls
queued behind a sleeping kernel, so the events time the device and not
the host).

Prints ptxas's registers and spills of every kernel built. Exits non-zero
if a build fails or a variant differs (its entry says DIFFERS). Needs the
port beside it and a CUDA card.
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

from chip_smoke import device_ms, record_calls  # noqa: E402
from constantine_tpu_torch import build  # noqa: E402
from torch_scalar_mul_teams import events_ms, mul_latency, start_mul_chain  # noqa: E402

# (label, variant, team): variant 1 A, 2 B, 3 C, 0 D (the team unused)
K6_VARIANTS = (("A: two teams of 4 (port)", 1, 4), ("A: two teams of 2", 1, 2),
               ("A: two teams of 1", 1, 1), ("B: one team of 4, joint levels", 2, 4),
               ("B: one team of 8, joint levels", 2, 8), ("C: one team of 4, in turn", 3, 4),
               ("D: one thread a lane (the parent's)", 0, 1))
TILE_COLS = (1, 2, 4, 8)
P_, I_ = ctypes.c_void_p, ctypes.c_int

BR_CU = r"""
#include <cuda_runtime.h>
#include "ec.cuh"
using namespace ctt;

namespace {
constexpr int NL = 12, LANES = 8;   // lanes a block, whatever the variant
using F = Fe<NL>;
using J = Jac<NL>;
using MD = Mod<NL>;

__device__ J bucket_at(const uint32_t* bx, const uint32_t* by, const uint32_t* bz, int t, int C,
                       int c) {
  const size_t o = (size_t)t * NL * C + c;
  return J{load_col<NL>(bx + o, C), load_col<NL>(by + o, C), load_col<NL>(bz + o, C)};
}

// B: ec_add_team's 5 levels for two adds at once (8, 8, 6, 6, 4 products),
// the same operations on the same operands, so ec_add's limbs.
template <class Team>
__device__ void ec_add2_team(Team& tm, const J (&P)[2], const J (&Q)[2], J (&O)[2],
                             const MD& M) {
  F a[8], b[8], l1[8], l2[8], a3[6], l3[6], a4[6], b4[6], l4[6], a5[4], b5[4], l5[4];
  F H[2], R[2], U1[2], S1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[4 * i] = P[i].Z, a[4 * i + 1] = Q[i].Z, a[4 * i + 2] = P[i].Y, a[4 * i + 3] = Q[i].Y;
    b[4 * i] = P[i].Z, b[4 * i + 1] = Q[i].Z, b[4 * i + 2] = Q[i].Z, b[4 * i + 3] = P[i].Z;
  }
  mul_level<NL, 8>(tm, a, b, l1, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[4 * i] = P[i].X, a[4 * i + 1] = Q[i].X, a[4 * i + 2] = l1[4 * i + 2];
    a[4 * i + 3] = l1[4 * i + 3];
    b[4 * i] = l1[4 * i + 1], b[4 * i + 1] = l1[4 * i], b[4 * i + 2] = l1[4 * i + 1];
    b[4 * i + 3] = l1[4 * i];
  }
  mul_level<NL, 8>(tm, a, b, l2, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    U1[i] = l2[4 * i], S1[i] = l2[4 * i + 2];
    H[i] = fe_sub<NL>(l2[4 * i + 1], U1[i], M);
    R[i] = fe_dbl<NL>(fe_sub<NL>(l2[4 * i + 3], S1[i], M), M);
    a3[3 * i] = fe_dbl<NL>(H[i], M), a3[3 * i + 1] = R[i];
    a3[3 * i + 2] = fe_add<NL>(P[i].Z, Q[i].Z, M);
  }
  mul_level<NL, 6>(tm, a3, a3, l3, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a4[3 * i] = H[i], a4[3 * i + 1] = U1[i];
    a4[3 * i + 2] = fe_sub<NL>(fe_sub<NL>(l3[3 * i + 2], l1[4 * i], M), l1[4 * i + 1], M);
    b4[3 * i] = l3[3 * i], b4[3 * i + 1] = l3[3 * i], b4[3 * i + 2] = H[i];
  }
  mul_level<NL, 6>(tm, a4, b4, l4, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const F Jv = l4[3 * i], V = l4[3 * i + 1];
    O[i].X = fe_sub<NL>(fe_sub<NL>(l3[3 * i + 1], Jv, M), fe_dbl<NL>(V, M), M);
    O[i].Z = l4[3 * i + 2];
    a5[2 * i] = R[i], a5[2 * i + 1] = S1[i];
    b5[2 * i] = fe_sub<NL>(V, O[i].X, M), b5[2 * i + 1] = Jv;
  }
  mul_level<NL, 4>(tm, a5, b5, l5, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    O[i].Y = fe_sub<NL>(l5[2 * i], fe_dbl<NL>(l5[2 * i + 1], M), M);
    const bool p_inf = fe_is_zero<NL>(P[i].Z), q_inf = fe_is_zero<NL>(Q[i].Z);
    const bool h0 = fe_is_zero<NL>(H[i]), r0 = fe_is_zero<NL>(R[i]);
    if (!p_inf && !q_inf && h0 && r0) O[i] = ec_double_team<NL>(tm, P[i], M);
    O[i] = jac_sel<NL>(h0 && !r0, jac_infinity<NL>(M), O[i]);
    O[i] = jac_sel<NL>(p_inf, Q[i], O[i]);
    O[i] = jac_sel<NL>(q_inf, P[i], O[i]);
  }
}

// B (kJoint) and C: one team carries run and wsum.
template <class Team, bool kJoint>
__device__ void one_team_lane(Team& tm, const uint32_t* bx, const uint32_t* by,
                              const uint32_t* bz, uint32_t* rx, uint32_t* ry, uint32_t* rz,
                              uint32_t* wx, uint32_t* wy, uint32_t* wz, int T, int C, int c,
                              const MD& md) {
  J run = jac_infinity<NL>(md), wsum = run, B = bucket_at(bx, by, bz, 0, C, c);
  for (int t = 0; t < T; ++t) {
    const J Bn = t + 1 < T ? bucket_at(bx, by, bz, t + 1, C, c) : B;
    const bool both = !fe_is_zero<NL>(wsum.Z) && !fe_is_zero<NL>(run.Z) &&
                      !fe_is_zero<NL>(B.Z);
    if (kJoint && both) {
      J O[2];
      ec_add2_team(tm, {wsum, run}, {run, B}, O, md);
      wsum = O[0], run = O[1];
    } else {
      wsum = ec_add_sel_team<NL>(tm, wsum, run, md);
      run = ec_add_sel_team<NL>(tm, run, B, md);
    }
    B = Bn;
  }
  store_split<NL>(tm, rx + c, ry + c, rz + c, C, run);
  store_split<NL>(tm, wx + c, wy + c, wz + c, C, wsum);
}

template <int kT>
__global__ void __launch_bounds__(LANES * 2 * kT)
pair_kernel(MD md, const uint32_t* bx, const uint32_t* by, const uint32_t* bz, uint32_t* rx,
            uint32_t* ry, uint32_t* rz, uint32_t* wx, uint32_t* wy, uint32_t* wz, int T, int C) {
  constexpr int WORDS = 2 * kT * NL + 1, LANE_WORDS = 2 * WORDS + 6 * NL;
  const int pair = threadIdx.x / (2 * kT);
  const int c = blockIdx.x * LANES + pair;
  if (c >= C) return;
  __shared__ uint32_t sm[LANES * LANE_WORDS];
  uint32_t* base = sm + pair * LANE_WORDS;
  const int within = threadIdx.x % (2 * kT), role = within / kT, rank = within % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  const unsigned both = ((1u << (2 * kT)) - 1) << ((threadIdx.x & 31) - within);
  SmTeam<NL, kT> tm{base + role * WORDS, mask, rank};
  bucket_lane<NL>(tm, role, base + 2 * WORDS, [both] { __syncwarp(both); }, bx, by, bz, rx, ry,
                  rz, wx, wy, wz, T, C, c, md);
}

template <int kT, bool kJoint>
__global__ void __launch_bounds__(LANES * kT)
team_kernel(MD md, const uint32_t* bx, const uint32_t* by, const uint32_t* bz, uint32_t* rx,
            uint32_t* ry, uint32_t* rz, uint32_t* wx, uint32_t* wy, uint32_t* wz, int T, int C) {
  constexpr int WORDS = 2 * kT * NL + 1;
  const int team = threadIdx.x / kT;
  const int c = blockIdx.x * LANES + team;
  if (c >= C) return;
  __shared__ uint32_t slots[LANES * WORDS];
  const int rank = threadIdx.x % kT;
  const unsigned mask = ((1u << kT) - 1) << ((threadIdx.x & 31) - rank);
  SmTeam<NL, kT> tm{slots + team * WORDS, mask, rank};
  one_team_lane<SmTeam<NL, kT>, kJoint>(tm, bx, by, bz, rx, ry, rz, wx, wy, wz, T, C, c, md);
}

// D, the parent's K6: one thread a lane over ec_add (fe_mul)
__global__ void thread_kernel(MD md, const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                              uint32_t* rx, uint32_t* ry, uint32_t* rz, uint32_t* wx,
                              uint32_t* wy, uint32_t* wz, int T, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  J run = jac_infinity<NL>(md), wsum = run;
  for (int t = 0; t < T; ++t) {
    const J B = bucket_at(bx, by, bz, t, C, c);
    wsum = ec_add<NL>(wsum, run, md);
    run = ec_add<NL>(run, B, md);
  }
  Solo<NL> tm;
  store_split<NL>(tm, rx + c, ry + c, rz + c, C, run);
  store_split<NL>(tm, wx + c, wy + c, wz + c, C, wsum);
}
}  // namespace

// variant 1 (A): two teams of T a lane; 2 (B): one team of T, joint levels;
// 3 (C): one team of T, the adds in turn; 0 (D): one thread a lane.
extern "C" int ctt_br_at(const uint32_t* w, const void* bx, const void* by, const void* bz,
                         void* rx, void* ry, void* rz, void* wx, void* wy, void* wz, int T,
                         int C, int variant, int team, void* stream) {
  const MD md = mod_from_words<NL>(w);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (C + LANES - 1) / LANES;
#define ARGS md, (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz, (uint32_t*)rx, \
             (uint32_t*)ry, (uint32_t*)rz, (uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz, T, C
  const int key = variant * 100 + team;
  switch (key) {
    case 0 * 100 + 1: thread_kernel<<<(C + 127) / 128, 128, 0, s>>>(ARGS); break;
    case 1 * 100 + 1: pair_kernel<1><<<blocks, LANES * 2, 0, s>>>(ARGS); break;
    case 1 * 100 + 2: pair_kernel<2><<<blocks, LANES * 4, 0, s>>>(ARGS); break;
    case 1 * 100 + 4: pair_kernel<4><<<blocks, LANES * 8, 0, s>>>(ARGS); break;
    case 2 * 100 + 4: team_kernel<4, true><<<blocks, LANES * 4, 0, s>>>(ARGS); break;
    case 2 * 100 + 8: team_kernel<8, true><<<blocks, LANES * 8, 0, s>>>(ARGS); break;
    case 3 * 100 + 4: team_kernel<4, false><<<blocks, LANES * 4, 0, s>>>(ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
  return (int)cudaGetLastError();
}
"""


def start_builds(out_dir: Path):
    """nvcc of the K6 variants and the multiply chain, started together:
    {name: (so, process)}."""
    shutil.rmtree(out_dir, ignore_errors=True)
    d = out_dir / "br"
    shutil.copytree(build.CSRC, d)
    cu = d / "br_variants.cu"
    cu.write_text(BR_CU)
    so = cu.with_suffix(".so")
    procs = {"br": (so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))}
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
        if name == "br":
            lib.ctt_br_at.argtypes = [P_] * 10 + [I_] * 4 + [P_]
            lib.ctt_br_at.restype = I_
        libs[name] = lib
    return libs


def _blob(r, seed):
    rng = np.random.default_rng(seed)
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


def bucket_streams(ctx, dev):
    """{label: (bx, by, bz, T)} of the paths, recorded from the entry points
    on the EIP-4844 trusted setup, with lane 0 B1 = B0, lane 1 B1 = -B0 and
    lane 2 B2 at infinity."""
    from constantine_tpu_torch.models import eip4844
    from constantine_tpu_torch.models.kzg import get_kzg
    from constantine_tpu_torch.ops.msm import msm
    kzg, kzo = get_kzg(dev.type), get_kzg(dev.type, precompute=False)
    r, pec, F = ctx.r, ctx.g1.pec, ctx.fp
    n16 = 1 << 16
    tabx, taby = kzg._pm._tables
    krng = np.random.default_rng(65536)
    k16 = ctx.scalars_to_limbs([int.from_bytes(krng.bytes(32), "big") % r
                                for _ in range(n16)], dev)
    dense = [_blob(r, s) for s in range(101, 117)]
    out = {}
    for label, fn in (("commit", lambda: eip4844.blob_to_kzg_commitment(dense[0], kzg)),
                      ("online commit", lambda: eip4844.blob_to_kzg_commitment(dense[0], kzo)),
                      ("msm 2^16", lambda: msm(ctx.g1, (tabx[:n16], taby[:n16]), k16)),
                      ("batch 16", lambda: eip4844.blob_to_kzg_commitment_batch(dense, kzg))):
        for bx, by, bz, T in record_calls(pec, "bucket_reduce", fn):
            for v in (bx, by, bz):
                v[1, :, 0] = v[0, :, 0]
                v[1, :, 1] = v[0, :, 1]
            by[1, :, 1] = F.neg(by[1, :, 1][None])[0]
            bz[2, :, 2] = 0
            out[label] = bx, by, bz, T
    return out


def ntt_passes(ctx, dev):
    """{(batch, ns, lanes, stages, load factor, store factor, transposed):
    (y, tw, brp, keywords)} of every ntt_stages call
    the PeerDAS paths make, recorded from compute_cells, the FK20 NTT over
    (64, 128), the cell iNTT over (128, 64) and a coset transform of 8,192."""
    from constantine_tpu_torch.ops import ntt as ntt_mod
    from constantine_tpu_torch.ops.ntt import get_domain
    fr = ctx.fr
    rng = np.random.default_rng(8192)

    def elems(*shape):
        n = int(np.prod(shape))
        return fr.encode([int.from_bytes(rng.bytes(32), "big") % fr.p_int for _ in range(n)],
                         dev).reshape(*shape, fr.NL)

    d12, d13 = get_domain("BLS12_381", 12), get_domain("BLS12_381", 13)
    d7, d6 = get_domain("BLS12_381", 7), get_domain("BLS12_381", 6)
    calls = (lambda: d12.intt(elems(4096)), lambda: d13.ntt(elems(8192)),
             lambda: d7.ntt(elems(64, 128)), lambda: d6.intt(elems(128, 64)),
             lambda: d13.coset_ntt(elems(8192), 7))
    out = {}
    for fn in calls:
        for (F, y, tw, brp, stages), kw in record_calls(ntt_mod, "ntt_stages", fn, True):
            key = (*y.shape[:3], stages, *(kw.get(k) is not None for k in ("in_fac", "out_fac")),
                   kw.get("transposed", False))
            out.setdefault(key, (y, tw, brp, kw))
    return out


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    procs = start_builds(build.BUILD_DIR / "br_ntt_teams")
    build.build_all(verbose=True)
    libs = finish_builds(procs)
    if libs is None:
        return 1
    from constantine_tpu_torch.named.precompute import get_curve
    from constantine_tpu_torch.ops.cuda_ntt import ntt_bfly, ntt_stages, tile_cols
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    sid = torch.cuda.current_stream(dev).cuda_stream
    lat_us, ok, _ = mul_latency(libs["mul_chain"], ctx, dev, True)
    print(f"fe_mul_eo: {lat_us:.4f} us a multiply in a lone thread's dependent chain "
          f"({'exact' if ok else 'DIFFERS'})", flush=True)
    pec = ctx.g1.pec
    mod = ctypes.c_void_p(ctx.fp.mod_words.ctypes.data)
    for label, (bx, by, bz, T) in bucket_streams(ctx, dev).items():
        C = bx.shape[2]
        port = sum(pec.bucket_reduce(bx, by, bz, T), ())
        outs = tuple(torch.empty_like(v) for v in port)

        def br(variant, team):
            rc = libs["br"].ctt_br_at(mod, *map(build.ptr, (bx, by, bz, *outs)), T, C, variant,
                                      team, sid)
            if rc != 0:
                raise RuntimeError(f"ctt_br_at {variant}/{team}: CUDA error {rc}")

        row = [f"port {events_ms(lambda: pec.bucket_reduce(bx, by, bz, T), 20):.4f}"]
        for name, variant, team in K6_VARIANTS:
            br(variant, team)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, port))
            ok &= same
            row.append(f"{name} {events_ms(lambda: br(variant, team), 20):.4f}"
                       + ("" if same else " DIFFERS"))
        floor = (T - 1) * 5 * lat_us * 1e-3
        print(f"bucket_reduce {label} T={T} lanes={C}: chain floor {floor:.4f} ms ((T - 1) x 5 "
              "rounds x fe_mul_eo); ms a call (CUDA events), each variant against the port's "
              "kernel: " + ", ".join(row), flush=True)
    fr = ctx.fr
    fr_mod = ctypes.c_void_p(fr.mod_words.ctypes.data)
    for (B, ns, lanes, stages, *opts), (y, tw, brp, kw) in ntt_passes(ctx, dev).items():
        port = ntt_stages(fr, y, tw, brp, stages, **kw)
        out = torch.empty_like(port)
        fi, fo, tr = kw.get("in_fac"), kw.get("out_fac"), kw.get("transposed", False)

        def stages_at(cols):
            """The pass over tiles of `cols` lanes (the port's wrapper takes
            tile_cols(lanes))."""
            build.KERNELS["ntt_stages"](
                dev, fr.NL, fr_mod, *map(build.ptr, (y, out, tw, brp)),
                ctypes.c_void_p(None if fi is None else fi.data_ptr()),
                1 if fi is None else fi.shape[0],
                ctypes.c_void_p(None if fo is None else fo.data_ptr()),
                1 if fo is None else fo.shape[0], int(tr), B, ns, lanes, stages, cols)
            return out

        def times(z, f):
            return z if f is None else fr.mul(z, f if f.shape[0] == 1 else
                                              f.reshape(z.shape[1:]))

        def per_stage():
            z = times(y, fi).index_select(1, brp)
            for s in range(stages):
                ntt_bfly(fr, z, tw[(1 << s) - 1:(2 << s) - 1], 1 << s, out=z)
            return times(z.transpose(1, 2).contiguous() if tr else z, fo)

        same = torch.equal(per_stage(), port)
        ok &= same
        row = [f"per-stage route (gather + {stages} ntt_bfly, factors as K1) "
               f"{events_ms(per_stage, 50):.4f}" + ("" if same else " DIFFERS")]
        dev_ps = device_ms(torch, per_stage, 20)
        devs = ["per-stage " + ("not measured" if dev_ps is None else f"{dev_ps:.4f}")]
        for cols in TILE_COLS:
            if lanes % cols:
                continue
            same = torch.equal(stages_at(cols), port)
            ok &= same
            fn = lambda c=cols: stages_at(c)  # noqa: E731
            tag = " (port)" if cols == tile_cols(lanes) else ""
            row.append(f"ntt_stages {cols} lanes a tile{tag} {events_ms(fn, 50):.4f}"
                       + ("" if same else " DIFFERS"))
            dk = device_ms(torch, fn, 20)
            devs.append(f"{cols} lanes " + ("not measured" if dk is None else f"{dk:.4f}"))
        print(f"ntt pass (batch, ns, lanes) = ({B}, {ns}, {lanes}), {stages} stages, "
              f"(load factor, store factor, transposed) = {tuple(opts)}: ms a call "
              "(CUDA events), each against the port's pass: " + ", ".join(row)
              + "; device ms a call (CUDA events, calls queued behind a sleep): "
              + ", ".join(devs), flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
