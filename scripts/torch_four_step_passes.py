#!/usr/bin/env python3
"""K3′ ntt_stages with its factors, and the transforms built on it, on one
NVIDIA card.

    python3 scripts/torch_four_step_passes.py                 # variants
    python3 scripts/torch_four_step_passes.py --calls-only --root DIR

The port runs a four-step transform as two ntt_stages launches: the column
pass stores its product with the twiddle matrix transposed, the row pass
stores 1/n on the inverse; a coset transform puts its shift powers on the
column pass's load (forward) or n^-1 s^-k on the row pass's store
(inverse); a batched radix-2 pass that takes every stage stores 1/n
(csrc/ntt.cuh, ops/ntt.py).

Variants (this tree): at every pass shape of the PeerDAS paths (the
four-step's (1, 64, 64), (1, 64, 128), (1, 128, 64), the FK20 NTT's (64,
128, 1), the cell iNTT's (128, 64, 1)) and at (1, 256, 256), the 2^16
four-step's, the pass with no factor, a load factor, a store factor of
period 1 and n, a transposed store and the column passes' combinations,
each exact against the plain version, its device ms a launch (CUDA events
around calls queued behind a sleep, chip_smoke.py device_ms) and its call
ms (CUDA events, calls back to back).

--calls-only times, through whichever port lies at --root (this tree or an
unpacked copy of another commit), the public transforms: the four-step
ntt / intt at n = 4,096, 8,192 and 65,536, coset_ntt / coset_intt at 8,192
(shift 7), the cell iNTT over (128, 64) and the FK20 NTT over (64, 128):
host-clock ms a call (synchronised, median), the host's ms to enqueue a
call, the device's ms a call, and the K3′ and K1 launches a call; the
plain pass (no factor) at the paths' shapes; the tree's standalone ntt_twm
at 4,096 and 8,192 where it has one; and the PeerDAS paths i-l
(compute_cells, compute_cells_and_kzg_proofs, verify_cell_kzg_proof_batch
of 128 cells, recover_cells_and_kzg_proofs from 64) on chip_smoke.py's
dense blob: the host-clock median and quartiles, the launches a call of
ntt_stages, ntt_bfly, ntt_twm and mont_mul, and the device busy ms and
idle share of three profiled calls (torch.profiler, chip_smoke.py
device_by_kernel). Prints one JSON line ("calls: {...}"). Run parent,
change, change, parent in one call to compare two trees on one card.

Exits non-zero if a variant differs from the plain version. Needs a CUDA
card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
PASS_SHAPES = ((1, 64, 64), (1, 64, 128), (1, 128, 64), (64, 128, 1), (128, 64, 1))
LAUNCHES = ("ntt_stages", "ntt_bfly", "ntt_twm", "mont_mul")


def _import_port(root: Path):
    sys.path.insert(0, str(root / "scripts"))
    sys.path.insert(0, str(root))           # its port and chip_smoke.py first
    from constantine_tpu_torch import build
    from constantine_tpu_torch.named.precompute import get_curve
    return build, get_curve


def _rand(F, n, seed, dev):
    rng = np.random.default_rng(seed)
    raw = rng.bytes(32 * n)
    xs = [int.from_bytes(raw[32 * i:32 * i + 32], "big") % F.p_int for i in range(n)]
    if n >= 16:
        xs[:3] = [0, 1, F.p_int - 1]
    return F.encode(xs, dev)


def _host_ms(fn, reps):
    """Host-clock ms of calls ending synchronised: (median, q1, q3)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(out, n=4)
    return med, q1, q3


def _pass_inputs(get_domain, fr, shape, dev):
    B, ns, lanes = shape
    dom = get_domain("BLS12_381", ns.bit_length() - 1)
    y = _rand(fr, B * ns * lanes, sum(shape), dev).reshape(B, ns, lanes, fr.NL)
    return (y, dom.packed_twiddles(False, dev),
            torch.as_tensor(dom.brp, device=dev), ns.bit_length() - 1)


def calls(root: Path):
    """The tree's transforms, passes and PeerDAS paths, timed."""
    build, get_curve = _import_port(root)
    from chip_smoke import dense_blob, device_by_kernel, device_ms, enqueue_ms
    from constantine_tpu_torch.models import eip4844, peerdas
    from constantine_tpu_torch.models.kzg import get_kzg
    from constantine_tpu_torch.ops import cuda_ntt
    from constantine_tpu_torch.ops.ntt import get_domain
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    ctx = get_curve("BLS12_381")
    fr = ctx.fr
    res = {}

    def entry(label, fn, reps):
        fn()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        med, _, _ = _host_ms(fn, reps)
        counts = build.launch_counts()
        res[label] = {"call_ms": med, "enqueue_ms": enqueue_ms(torch, fn, reps),
                      "device_ms": device_ms(torch, fn, reps),
                      "launches": {k: counts[k] / (reps + 1) for k in LAUNCHES
                                   if counts.get(k)}}

    for log_n in (12, 13, 16):
        dom = get_domain("BLS12_381", log_n)
        x = _rand(fr, 1 << log_n, log_n, dev)
        entry(f"ntt {1 << log_n}", lambda dom=dom, x=x: dom.ntt(x), 20)
        entry(f"intt {1 << log_n}", lambda dom=dom, x=x: dom.intt(x), 20)
    d13 = get_domain("BLS12_381", 13)
    x13 = _rand(fr, 8192, 13, dev)
    entry("coset_ntt 8192", lambda: d13.coset_ntt(x13, 7), 20)
    entry("coset_intt 8192", lambda: d13.coset_intt(x13, 7), 20)
    d6, d7 = get_domain("BLS12_381", 6), get_domain("BLS12_381", 7)
    cells = _rand(fr, 8192, 6, dev).reshape(128, 64, fr.NL)
    circ = _rand(fr, 8192, 7, dev).reshape(64, 128, fr.NL)
    entry("cell intt (128, 64)", lambda: d6.intt(cells), 20)
    entry("FK20 ntt (64, 128)", lambda: d7.ntt(circ), 20)
    for shape in PASS_SHAPES:
        y, tw, brp, stages = _pass_inputs(get_domain, fr, shape, dev)
        entry(f"ntt_stages {shape}, no factor",
              lambda y=y, tw=tw, brp=brp, stages=stages: cuda_ntt.ntt_stages(fr, y, tw, brp,
                                                                             stages), 50)
    if hasattr(cuda_ntt, "ntt_twm"):
        for log_n in (12, 13):
            n1, n2, twm = get_domain("BLS12_381", log_n)._four_step_tables(False, dev)
            y = _rand(fr, 1 << log_n, log_n + 1, dev)
            entry(f"ntt_twm {1 << log_n}", lambda y=y, twm=twm: cuda_ntt.ntt_twm(fr, y, twm), 50)

    blob = dense_blob(1, ctx.r)
    kzg = get_kzg("cuda")
    das = peerdas.get_peerdas("cuda")
    cs, ps = peerdas.compute_cells_and_kzg_proofs(blob, das)
    commitment = eip4844.blob_to_kzg_commitment(blob, kzg)
    half = list(range(0, 128, 2))
    names = tuple(build.KERNELS)
    for label, reps, fn in (
            ("i compute_cells", 50, lambda: peerdas.compute_cells(blob, das)),
            ("j compute_cells_and_kzg_proofs", 10,
             lambda: peerdas.compute_cells_and_kzg_proofs(blob, das)),
            ("k verify_cell_kzg_proof_batch 128", 10, lambda: peerdas.verify_cell_kzg_proof_batch(
                [commitment] * 128, list(range(128)), cs, ps, das)),
            ("l recover from 64", 10, lambda: peerdas.recover_cells_and_kzg_proofs(
                half, [cs[i] for i in half], das))):
        fn()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        med, q1, q3 = _host_ms(fn, reps)
        counts = build.launch_counts()
        prof = []
        for _ in range(3):
            by_name, wall_us = device_by_kernel(torch, names, fn)
            busy = sum(t for _, t in by_name.values())
            prof.append({"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
                         "idle": 1 - busy / wall_us if wall_us else None,
                         "by_kernel_ms": {k: t / 1e3 for k, (_, t) in by_name.items()}})
        res[label] = {"latency_ms": med, "q1": q1, "q3": q3, "reps": reps,
                      "launches": {k: counts.get(k, 0) / (reps + 1) for k in LAUNCHES},
                      "profiles": prof}
    return res


VARIANTS = {"none": (None, None, False), "load n": ("n", None, False),
            "store 1": (None, 1, False), "store n": (None, "n", False),
            "transposed": (None, None, True), "column (store n, transposed)": (None, "n", True),
            "coset column (load n, store n, transposed)": ("n", "n", True)}


def variants():
    build, get_curve = _import_port(HERE)
    from chip_smoke import cuda_ms, device_ms
    from constantine_tpu_torch.ops.cuda_ntt import ntt_stages, ntt_stages_plain
    from constantine_tpu_torch.ops.ntt import get_domain
    build.SOURCES = ("field_kernels", "ntt_kernels")
    build.build_all(verbose=True)
    dev = torch.device("cuda", 0)
    fr = get_curve("BLS12_381").fr
    ok = True
    for shape in PASS_SHAPES + ((1, 256, 256),):
        y, tw, brp, stages = _pass_inputs(get_domain, fr, shape, dev)
        n = shape[1] * shape[2]
        tabs = {1: _rand(fr, 1, n + 1, dev), "n": _rand(fr, n, n + 2, dev)}
        row = []
        for name, (ip, op, tr) in VARIANTS.items():
            kw = dict(in_fac=tabs.get(ip), out_fac=tabs.get(op), transposed=tr)
            same = torch.equal(ntt_stages(fr, y, tw, brp, stages, **kw),
                               ntt_stages_plain(fr, y, tw, brp, stages, **kw))
            ok &= same
            fn = lambda kw=kw: ntt_stages(fr, y, tw, brp, stages, **kw)  # noqa: E731
            dms = device_ms(torch, fn, 20)
            row.append(f"{name}: device {'not measured' if dms is None else f'{dms:.4f}'}, "
                       f"call {cuda_ms(torch, fn, 50):.4f}" + ("" if same else " DIFFERS"))
        print(f"ntt_stages {shape}, {stages} stages, ms a launch: " + "; ".join(row),
              flush=True)
    print("all exact" if ok else "a variant DIFFERS from the plain version", flush=True)
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
