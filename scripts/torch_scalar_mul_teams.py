#!/usr/bin/env python3
"""ec_scalar_mul's chain floor and its team size, on one NVIDIA card.

    python3 scripts/torch_scalar_mul_teams.py

1. The chain floor. Builds a one-thread kernel over csrc/ec.cuh that runs a
   chain of dependent 12-limb Montgomery multiplies, ec.cuh's fe_mul (K2)
   and fe_mul_eo (the ladder's), checks its result against the plain
   multiply and times it with CUDA events at two chain lengths: one
   multiply's latency is the difference over the extra multiplies. The
   ladder's floor is 255 bits x LEVELS x the fe_mul_eo latency, plus the two
   products of Q's Z^2 and Z^3.
2. Team size and multiply. Builds ec_kernels.cu from copies of csrc/ with
   the team size SM_TEAM set to 1, 2 or 4 threads a lane and the ladder's
   multiply to fe_mul or fe_mul_eo (the port builds T = 4 with fe_mul_eo),
   with -Xptxas -v, one nvcc each, all started together, into
   constantine_tpu_torch/_build/teams/, and prints each kernel's registers
   and spills. Every variant is held exactly against the port's kernel at
   64 lanes (k = 0, 1, r - 1, r, r + 2, a lane at infinity, seeded scalars)
   and 8,192 lanes x 255 bits, and timed with CUDA events at 64, 128, 4,096
   and 8,192 lanes.

Exits non-zero if a build fails or a result differs. Needs the port beside
it and a CUDA card.
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
from constantine_tpu_torch.named.precompute import get_curve  # noqa: E402
from constantine_tpu_torch.ops import limbs as lb  # noqa: E402
from constantine_tpu_torch.ops.cuda_ec import ec_double  # noqa: E402
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain  # noqa: E402
from constantine_tpu_torch.utils import refmath as rm  # noqa: E402

BITS = 255
LEVELS = 7          # rounds of products a bit at T = 4 (ec.cuh ladder_step)
LANES = (64, 128, 4096, 8192)
CHAIN = (1_000, 11_000)
TEAMS = (1, 2, 4)
MULS = ("fe_mul", "fe_mul_eo")
TEAM_LINE = "constexpr int SM_TEAM = 4;"
MUL_LINE = "tm.put(fe_mul_eo<N>(x, y, M));"
P_, I_ = ctypes.c_void_p, ctypes.c_int

MUL_CHAIN_CU = r"""
#include <cuda_runtime.h>
#include "ec.cuh"
using namespace ctt;

template <bool kEo>
__global__ void mul_chain_kernel(Mod<12> M, const uint32_t* a, uint32_t* out, int reps) {
  Fe<12> x, y;
  for (int l = 0; l < 12; ++l) { x.v[l] = a[l]; y.v[l] = a[12 + l]; }
#pragma unroll 1
  for (int i = 0; i < reps; ++i) x = kEo ? fe_mul_eo<12>(x, y, M) : fe_mul<12>(x, y, M);
  for (int l = 0; l < 12; ++l) out[l] = x.v[l];
}

extern "C" int ctt_mul_chain(const uint32_t* w, const void* a, void* out, int reps, int eo,
                             void* stream) {
  const Mod<12> M = mod_from_words<12>(w);
  if (eo)
    mul_chain_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>(M, (const uint32_t*)a,
                                                             (uint32_t*)out, reps);
  else
    mul_chain_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>(M, (const uint32_t*)a,
                                                              (uint32_t*)out, reps);
  return (int)cudaGetLastError();
}
"""


def patched(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"expected one {old!r} in the sources")
    return src.replace(old, new)


def build_variants(out_dir: Path):
    """Start every nvcc at once; returns {name: CDLL} of the builds that passed."""
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    out_dir.mkdir(parents=True)
    for t in TEAMS:
        for m in MULS:
            d = out_dir / f"t{t}_{m}"
            shutil.copytree(build.CSRC, d)
            kern = d / "ec_kernels.cu"
            kern.write_text(patched(kern.read_text(), TEAM_LINE,
                                    f"constexpr int SM_TEAM = {t};"))
            if m == "fe_mul":
                head = d / "ec.cuh"
                head.write_text(patched(head.read_text(), MUL_LINE,
                                        "tm.put(fe_mul<N>(x, y, M));"))
            jobs[t, m] = kern
    nvcc = build.nvcc_path()
    procs = {name: (src.with_suffix(".so"), subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(src.with_suffix(".so")),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, src in jobs.items()}
    src, proc = start_mul_chain(out_dir)
    procs["mul_chain"] = (src.with_suffix(".so"), proc)
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[nvcc {name}] failed\n{log}", flush=True)
            continue
        for line in build.ptxas_summary(log):
            if name == "mul_chain" or line.startswith("ec_scalar_mul"):
                print(f"[nvcc {name}] {line}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def start_mul_chain(out_dir: Path):
    """Write the chain kernel into out_dir and start its nvcc: (source, Popen)."""
    src = out_dir / "mul_chain.cu"
    src.write_text(MUL_CHAIN_CU)
    return src, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC), "-o",
         str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def mul_latency(lib, ctx, dev, eo):
    """One multiply's latency in us in a lone thread's dependent chain (the
    chain kernel of lib), and whether a chain of 3 equals the plain product;
    also the two chains' ms (CUDA events)."""
    F = ctx.fp
    chain = fn(lib, "ctt_mul_chain", [P_, P_, P_, I_, I_])
    xy = F.encode([rm.ec_mul(5, ctx.g, 0, ctx.p)[0], rm.ec_mul(7, ctx.g, 0, ctx.p)[1]])
    want = xy[0:1]
    for _ in range(3):
        want = mont_mul_plain(want, xy[1:2], F)
    a = xy.to(dev).contiguous()
    out = torch.empty(F.NL, dtype=torch.int32, device=dev)
    mod = ctypes.c_void_p(F.mod_words.ctypes.data)

    def run(reps):
        if chain(mod, build.ptr(a), build.ptr(out), reps, int(eo),
                 torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("ctt_mul_chain: CUDA error")
    run(3)
    exact = torch.equal(out.cpu(), want[0])
    t = [events_ms(lambda n=n: run(n), 5) for n in CHAIN]
    return (t[1] - t[0]) * 1e3 / (CHAIN[1] - CHAIN[0]), exact, t


def fn(lib, name, argtypes):
    f = getattr(lib, name)
    f.argtypes = argtypes + [P_]
    f.restype = I_
    return f


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


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build_variants(build.BUILD_DIR / "teams")
    ok = len(libs) == 1 + len(TEAMS) * len(MULS)

    ctx = get_curve("BLS12_381")
    F, pec, r = ctx.fp, ctx.g1.pec, ctx.r
    dev = torch.device("cuda", 0)
    mod = ctypes.c_void_p(F.mod_words.ctypes.data)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    ptr = build.ptr

    def same(got, want, what):
        nonlocal ok
        eq = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"check {what}: {'exact' if eq else 'DIFFERS'}", flush=True)
        ok &= eq

    # 1. one multiply's latency in a lone thread's dependent chain
    if "mul_chain" in libs:
        lat = {}
        for eo, m in enumerate(MULS):
            lat[m], exact, t = mul_latency(libs["mul_chain"], ctx, dev, eo)
            print(f"check {m} chain of 3 = plain: {'exact' if exact else 'DIFFERS'}", flush=True)
            ok &= exact
            print(f"{m}: {lat[m]:.4f} us a multiply in a lone thread's dependent chain "
                  f"({CHAIN[0]}: {t[0]:.4f} ms, {CHAIN[1]}: {t[1]:.4f} ms, CUDA events)",
                  flush=True)
        print(f"chain floor of ec_scalar_mul x {BITS} bits: {BITS} x {LEVELS} levels + 2 "
              f"multiplies x {lat['fe_mul_eo']:.4f} us = "
              f"{(BITS * LEVELS + 2) * lat['fe_mul_eo'] * 1e-3:.4f} ms", flush=True)

    # 2. team size x multiply, against the port's kernel. 64 distinct points
    # with Z != 1 (doubled on the host), lane 5 at infinity, tiled.
    pts = [rm.ec_mul(3 + i, ctx.g, 0, ctx.p) for i in range(64)]
    X, Y = F.encode([q[0] for q in pts]), F.encode([q[1] for q in pts])
    one = F.broadcast_one((64,), "cpu").clone()
    one[5] = 0
    base = ec_double(F, lambda u, v: mont_mul_plain(u, v, F), (X, Y, one))
    rng = np.random.default_rng(7)
    n_max = max(LANES)
    ks = [0, 1, r - 1, r, r + 2] + [int.from_bytes(rng.bytes(32), "big") >> 1
                                    for _ in range(n_max - 5)]
    K = lb.to_tensor(lb.ints_to_limbs(ks, 8), dev).T.contiguous()             # (8, n_max)
    Pall = tuple(v.repeat(n_max // 64, 1).T.contiguous().to(dev) for v in base)

    def inputs(n):
        return K[:, :n].contiguous(), tuple(v[:, :n].contiguous() for v in Pall)

    def kernel(v, k, P):
        n = P[0].shape[1]
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        rc = fn(libs[v], "ctt_ec_scalar_mul", [P_] * 8 + [I_, I_])(
            mod, *map(ptr, (k, *P, *out)), n, BITS, stream())
        if rc != 0:
            raise RuntimeError(f"ctt_ec_scalar_mul {v}: CUDA error {rc}")
        return out

    variants = [v for v in libs if v != "mul_chain"]
    for n in (64, n_max):
        k, P = inputs(n)
        port = pec.scalar_mul(k, P, BITS)
        for v in variants:
            same(kernel(v, k, P), port, f"T={v[0]} {v[1]} = the port's kernel, {n} lanes")
    for n in LANES:
        k, P = inputs(n)
        times = {v: events_ms(lambda: kernel(v, k, P), 5 if n <= 128 else 3) for v in variants}
        print(f"ec_scalar_mul {n} lanes x {BITS} bits, ms a call (CUDA events): "
              + ", ".join(f"T={v[0]} {v[1]} {ms:.4f}" for v, ms in times.items()), flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
