#!/usr/bin/env python3
"""Host-clock latency of BLS signing on one NVIDIA card, many calls each.

    python3 scripts/torch_bls_latency.py

Times, over 64 seeded secret keys and 32-byte messages (chip_smoke.py's
path n): the GLS-4 digit decomposition of the keys (`GLS4.decompose`), the
GLS-4 scalar multiplication of the hashed messages (`scalar_mul_gls4_g2`:
the decomposition, psi, the ladder and the adds), and `sign`, run in
alternation with torch's default CPU thread count and with one thread.
Each call ends synchronised; prints the median and the quartiles in ms.
chip_smoke.py times sign 3 times; run this script from two checkouts in
turns (parent, change, change, parent) to compare them on one card.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from constantine_tpu_torch import build  # noqa: E402


def timed(fn, calls: int):
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def report(name, lat):
    q = statistics.quantiles(lat, n=4)
    print(f"{name}: median {statistics.median(lat):.3f} ms (quartiles {q[0]:.3f} - {q[2]:.3f}, "
          f"min {min(lat):.3f}, max {max(lat):.3f}) over {len(lat)} calls", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    build.build_all()
    from constantine_tpu_torch.models.bls_signatures import get_bls
    from constantine_tpu_torch.ops.glv import get_gls4, scalar_mul_gls4_g2
    bls = get_bls("cuda")
    ctx = bls.ctx
    rng = np.random.default_rng(2026)
    sks = [int.from_bytes(rng.bytes(32), "big") % (ctx.r - 1) + 1 for _ in range(64)]
    msgs = [rng.bytes(32) for _ in range(64)]
    k = ctx.scalars_to_limbs(sks, "cuda")
    (hx, hy), _ = bls._hash(msgs)
    gls4 = get_gls4()
    default_threads = torch.get_num_threads()
    bls.sign(sks, msgs)                                   # warm the caches
    report("GLS4.decompose of 64 keys", timed(lambda: gls4.decompose(k), 50))
    report("scalar_mul_gls4_g2 of 64", timed(lambda: scalar_mul_gls4_g2(ctx, k, (hx, hy)), 10))
    lat = {default_threads: [], 1: []}
    for _ in range(8):
        for threads in lat:
            torch.set_num_threads(threads)
            lat[threads] += timed(lambda: bls.sign(sks, msgs), 1)
    torch.set_num_threads(default_threads)
    for threads, v in lat.items():
        report(f"sign 64, {threads} CPU thread(s)", v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
