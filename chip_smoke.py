#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Builds every kernel of constantine_tpu_torch/csrc with nvcc for sm_90a
   and checks each against its plain PyTorch version at small shapes.
2. Main path, with every launch count set to 0 first: loads the EIP-4844
   trusted setup, builds the KZG context (the fixed-base tables, on the
   card) and commits to four blobs through blob_to_kzg_commitment: a zero
   blob (infinity), a sparse blob (held against the host big-int sum) and
   two dense blobs (held against tests/data/torch_kzg_golden.json, made by
   the JAX package). Every kernel must have launched in this run.
3. Holds every kernel against its plain version on the card at the main
   path's shapes, with hand-built degenerate lanes (P == Q, P == -Q,
   infinity, padding keys): exact equality. Times both, and computes each
   kernel's bound from the bytes it must move and the multiplies it must
   do on these inputs.
4. Prints the kernels' JSON line, then the result line.

Any failed check exits non-zero before the result line; so does a machine
without a CUDA card, or a directory without the port beside this script.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_kzg_golden.json"

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and for the
# operations the FP32 (non-tensor) rate, counting a 32x32->64 multiply-add as
# 2 operations like an FMA. The data sheet gives no 32-bit integer rate;
# Hopper issues integer multiply-adds at half the FP32 rate, so the bound is
# optimistic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
NL = 12
MUL_OPS = 2 * (2 * NL * NL + NL)          # one 12-limb CIOS multiply
MULS = {"madd": 11, "add": 16, "double": 7}
FE_BYTES = 4 * NL

REPLACES = {
    "mont_mul": ("constantine_tpu_torch/csrc/field_kernels.cu",
                 "constantine_tpu/ops/pallas_field.py:89"),
    "ec_add": ("constantine_tpu_torch/csrc/ec_kernels.cu", "constantine_tpu/ops/pallas_ec.py:543"),
    "ec_double_k": ("constantine_tpu_torch/csrc/ec_kernels.cu",
                    "constantine_tpu/ops/pallas_ec.py:543"),
    "flush_scan": ("constantine_tpu_torch/csrc/ec_kernels.cu", "constantine_tpu/ops/pallas_ec.py:745"),
    "merge_scan": ("constantine_tpu_torch/csrc/ec_kernels.cu", "constantine_tpu/ops/pallas_ec.py:828"),
    "bucket_reduce": ("constantine_tpu_torch/csrc/ec_kernels.cu",
                      "constantine_tpu/ops/pallas_ec.py:910"),
}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def dense_blob(seed: int, r: int) -> bytes:
    """Same recipe as tests/test_torch_eip4844.py:dense_blob."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_commit(torch, commit):
    """Device time by kernel over one commit (torch.profiler), and the share
    of the commit's wall time the device spent idle."""
    from torch.profiler import ProfilerActivity, profile
    commit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        commit()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("mont_mul", "ec_add", "ec_double_k", "flush_scan",
                                     "merge_scan", "bucket_reduce") if k + "_kernel" in e.name),
                        "torch ops")
            span = e.time_range.end - e.time_range.start
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + span)
    busy_us = sum(t for _, t in by_name.values())
    if busy_us == 0:
        print("profile: the profiler recorded no device time (idle share not measured)",
              flush=True)
        return
    parts = ", ".join(f"{k} {t / 1e3:.3f} ms x{n}" for k, (n, t) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][1]))
    print(f"profile of one commit: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}; {parts}", flush=True)


def bound(nbytes, nmuls):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nmuls * MUL_OPS / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(lb, got, ref):
    """Largest |difference| of limb values (u32) over the outputs."""
    import numpy as np
    err = 0
    for a, b in zip(got, ref):
        d = np.abs(lb.to_numpy(a).astype(np.int64) - lb.to_numpy(b).astype(np.int64))
        err = max(err, int(d.max()) if d.size else 0)
    return err


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from constantine_tpu_torch import build
        from constantine_tpu_torch.models import eip4844
        from constantine_tpu_torch.models.kzg import get_kzg
        from constantine_tpu_torch.models.trusted_setup import DEFAULT_SETUP
        from constantine_tpu_torch.named.precompute import get_curve
        from constantine_tpu_torch.ops import limbs as lb
        from constantine_tpu_torch.ops import msm_gpu
        from constantine_tpu_torch.ops.cuda_ec import ec_add, ec_double
        from constantine_tpu_torch.ops.cuda_field import mont_mul, mont_mul_plain
        from constantine_tpu_torch.ops.msm import _signed_digits
        from constantine_tpu_torch.ops.ntt import bit_reversal_perm
        from constantine_tpu_torch.utils import refmath as rm
        from constantine_tpu_torch.utils.serialization import (g1_compress_affine,
                                                               g1_decompress_host)
    except ImportError as e:
        print(f"the port is not beside this script ({e})", file=sys.stderr)
        return 2
    if not GOLDEN.is_file():
        print(f"missing {GOLDEN}", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s (nvcc, one process per source)",
          flush=True)

    ctx = get_curve("BLS12_381")
    F, g = ctx.fp, ctx.g1
    pec = g.pec
    mul_plain = lambda a, b: mont_mul_plain(a, b, F)  # noqa: E731
    rng = torch.Generator(device="cpu").manual_seed(20261016)

    def rand_fe(n, field=F):
        ints = [int.from_bytes(bytes(torch.randint(0, 256, (48,), generator=rng).tolist()),
                               "big") % field.p_int for _ in range(n)]
        return field.encode(ints, dev)

    def planar(P):
        return tuple(v.T.contiguous() for v in P)

    def std(P):
        return tuple(v.T for v in P)

    def same(got, ref, what):
        for i, (a, b) in enumerate(zip(got, ref)):
            if not torch.equal(a, b):
                bad = (a != b).reshape(a.shape[0], -1).any(-1) if a.dim() > 1 else a != b
                raise CheckFailed(f"{what}: output {i} differs from the plain version "
                                  f"(first rows {bad.nonzero().flatten()[:8].tolist()})")

    # ---- 1. quick checks at small shapes ------------------------------------
    for field in (F, ctx.fr):
        a, b = rand_fe(61, field), rand_fe(61, field)
        a[0] = 0
        b[1] = field.encode(field.p_int - 1, dev)
        a[2] = field.encode(field.p_int - 1, dev)
        b[2] = a[2]
        same((mont_mul(a, b, field),), (mont_mul_plain(a, b, field),), f"mont_mul {field.name}")
    # 16 distinct points 2^i * G (Jacobian, Z != 1) and their affine forms
    G = g.from_affine((F.encode([ctx.g[0]], dev), F.encode([ctx.g[1]], dev)))
    chain = [G]
    for _ in range(15):
        chain.append(g.double(chain[-1]))
    J = tuple(torch.cat([q[i] for q in chain]) for i in range(3))
    (ax, ay), _ = g.to_affine(J)
    negy = F.neg(ay)
    # add: lanes 0-7 P + Q, 8-11 P + P, 12-15 P + (-P)
    Q = tuple(torch.roll(v, 1, 0).clone() for v in J)
    for v, w in zip(Q, J):
        v[8:] = w[8:]
    Q[1][12:] = F.neg(J[1][12:])
    same(pec.add(planar(J), planar(Q)), planar(ec_add(F, mul_plain, J, Q)), "ec_add quick")
    same(pec.double_k(planar(J), 3),
         planar(ec_double(F, mul_plain, ec_double(F, mul_plain, ec_double(F, mul_plain, J)))),
         "ec_double_k quick")
    gen = torch.Generator(device="cpu").manual_seed(7)
    qk = torch.sort(torch.randint(1, 5, (8, 16), generator=gen), 0)[0].to(torch.int32).to(dev)
    qi = torch.randint(0, 32, (8, 16), generator=gen).to(dev)
    tx, ty = torch.cat([ax, ax]), torch.cat([ay, negy])          # [P ; -P]
    qst = torch.cat([tx[qi], ty[qi]], -1).permute(0, 2, 1).contiguous()   # (8, 24, 16)
    same(pec.flush_scan(qk, qst), pec._flush_scan_plain(qk, qst), "flush_scan quick")
    qk2 = qk.clone()
    qk2[5:, 3] = 0
    qj = tuple(v[qi % 16].permute(0, 2, 1).contiguous() for v in J)
    same(pec.merge_scan(qk2, *qj), pec._merge_scan_plain(qk2, *qj), "merge_scan quick")
    same(sum(pec.bucket_reduce(*(v[:4] for v in qj), 4), ()),
         sum(pec._bucket_reduce_plain(*(v[:4] for v in qj), 4), ()), "bucket_reduce quick")
    print("quick checks: mont_mul (Fp, Fr), ec_add, ec_double_k, flush_scan, merge_scan, "
          "bucket_reduce exact", flush=True)

    # ---- 2. the main path ------------------------------------------------------
    golden = json.loads(GOLDEN.read_text())
    r = ctx.r
    blobs = {"zero": bytes(eip4844.BYTES_PER_BLOB)}
    sparse = {3: 0x1234567, 1000: r - 1, 4095: int.from_bytes(b"sparse-blob" * 2, "big") % r}
    sb = bytearray(eip4844.BYTES_PER_BLOB)
    for i, v in sparse.items():
        sb[32 * i:32 * (i + 1)] = v.to_bytes(32, "big")
    blobs["sparse"] = bytes(sb)
    for entry in golden["blobs"]:
        blob = dense_blob(entry["seed"], r)
        check(hashlib.sha256(blob).hexdigest() == entry["blob_sha256"],
              f"dense blob {entry['seed']} does not match its recipe")
        blobs[f"dense{entry['seed']}"] = blob

    tokens = Path(DEFAULT_SETUP).read_text().split()
    brp = bit_reversal_perm(4096)
    idx = sorted(sparse)
    lag, _, ok = g1_decompress_host(bytes.fromhex("".join(tokens[2 + brp[i]] for i in idx)))
    check(ok.all(), "setup points for the sparse check")
    acc = None
    for i, q in zip(idx, lag):
        acc = rm.ec_add(acc, rm.ec_mul(sparse[i], q, 0, ctx.p), 0, ctx.p)
    expected = {"zero": bytes([0xC0]) + bytes(47), "sparse": g1_compress_affine(acc)}
    for entry in golden["blobs"]:
        expected[f"dense{entry['seed']}"] = bytes.fromhex(entry["commitment"])

    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kzg = get_kzg("cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for name, blob in blobs.items():
        got = eip4844.blob_to_kzg_commitment(blob, kzg)
        check(got == expected[name], f"{name} blob: commitment {got.hex() if got else got} "
                                     f"!= expected {expected[name].hex()}")
        print(f"blob {name}: commitment {got.hex()} matches", flush=True)
    before = build.launch_counts()
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg)
        lat.append((time.perf_counter() - t0) * 1e3)
    counts = build.launch_counts()
    per_commit = {k: (counts[k] - before[k]) / 5 for k in counts}
    med = statistics.median(lat)
    print(f"setup (host setup load + tables on the card): {setup_s:.3f} s", flush=True)
    print(f"commit latency: median {med:.3f} ms over 5 (min {min(lat):.3f}, max {max(lat):.3f}); "
          f"{1e3 / med:.3f} commits/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"launches on the main path (setup + 9 commits): {json.dumps(counts)}", flush=True)
    print(f"launches per commit: {json.dumps(per_commit)}", flush=True)
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    profile_commit(torch, lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg))

    # ---- 3. every kernel against its plain version at the path's shapes --------
    report = {}

    def record(name, got, ref, kernel_fn, plain_fn, nbytes, nmuls, reps):
        same(got, ref, name)
        ms = cuda_ms(torch, kernel_fn, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bms, by = bound(nbytes, nmuls)
        report[name] = dict(max_abs_err=max_abs_err(lb, got, ref), ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by)
        print(f"check {name}: exact; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bms:.4f} ms ({by})", flush=True)

    tabx, taby = kzg._pm._tables
    poly, _ = eip4844.blob_to_polynomial(blobs["dense1"])
    digits = _signed_digits(lb.to_tensor(poly, dev), kzg._pm.c, kzg._pm.W).reshape(1, -1)
    fs = msm_gpu._flush_stream(F, (tabx, taby), digits, kzg._pm.c)
    K, M, nb = fs.K, fs.M, fs.nb

    # K1 at the main path's widths: the setup's to_affine multiplies all
    # (W-1)*4096 shifted table points (its inversion chains run 1/32 as
    # wide), the export's to_affine one point. Inputs: the table itself,
    # with 0, 1 and p-1 lanes.
    n1 = tabx.shape[0] - 4096
    a, b = tabx[4096:].clone(), taby[4096:].clone()
    a[0], b[1] = 0, F.encode(1, dev)
    a[2] = b[2] = F.encode(F.p_int - 1, dev)
    for n in (1, n1 // 32):
        same((mont_mul(a[:n], b[:n], F),), (mont_mul_plain(a[:n], b[:n], F),),
             f"mont_mul n={n}")
    record("mont_mul", (mont_mul(a, b, F),), (mont_mul_plain(a, b, F),),
           lambda: mont_mul(a, b, F), lambda: mont_mul_plain(a, b, F),
           3 * n1 * FE_BYTES, n1, reps=50)

    # K3 double (k = 1) at the precompute's width, plus infinity and Y = 0 lanes
    nd = 4096
    Pd = (tabx[:nd].clone(), taby[:nd].clone(), F.broadcast_one((nd,), dev).clone())
    Pd[2][0] = 0
    Pd[1][1] = 0
    Pp = planar(Pd)
    record("ec_double_k", pec.double_k(Pp, 1), planar(ec_double(F, mul_plain, Pd)),
           lambda: pec.double_k(Pp, 1), lambda: ec_double(F, mul_plain, Pd),
           6 * nd * FE_BYTES, MULS["double"] * nd, reps=20)
    one_lane = tuple(v[:, 5:6].contiguous() for v in Pp)            # the tail's double_k(2)
    same(pec.double_k(one_lane, 2),
         planar(ec_double(F, mul_plain, ec_double(F, mul_plain, std(one_lane)))),
         "ec_double_k k=2")

    # K4 on the commit's stream, lanes 0-1 rebuilt: one run of [P, -P, Q, Q, ...]
    # (infinity, then a fresh point, then a doubling) and a padding lane
    keys, st = fs.skT.clone(), fs.st.clone()
    keys[:, 0] = keys[0, 0]
    st[1, :NL, 0], st[1, NL:, 0] = st[0, :NL, 0], F.neg(st[0, NL:, 0][None])[0]
    st[3, :, 0] = st[2, :, 0]
    keys[:, 1] = nb + 1
    st[:, :, 1] = st[0, :, 2][None]
    run_same = (keys[1:] == keys[:-1]).sum().item()
    record("flush_scan", pec.flush_scan(keys, st), pec._flush_scan_plain(keys, st),
           lambda: pec.flush_scan(keys, st), lambda: pec._flush_scan_plain(keys, st),
           K * M * (4 + 2 * FE_BYTES + 3 * FE_BYTES), MULS["madd"] * run_same, reps=5)

    # K5 on the commit's first merge input; lane 0: [P, P], lane 1: [P, -P],
    # lane 2: [inf, P] under one key
    ex, ey, ez = pec.flush_scan(fs.skT, fs.st)
    kT, xT, yT, zT, M2 = msm_gpu._compact_boundaries(pec, fs.sk, fs.skT, (ex, ey, ez),
                                                     K, M, nb, fs.H, 32)
    kT, xT, yT, zT = (v.clone() for v in (kT, xT, yT, zT))
    for lane in (0, 1, 2):
        kT[:2, lane] = 7
        for v in (xT, yT, zT):
            v[1, :, lane] = v[0, :, lane]
    yT[1, :, 1] = F.neg(yT[1, :, 1][None])[0]
    zT[0, :, 2] = 0
    both = ((kT[1:] == kT[:-1]) & (kT[1:] > 0)).sum().item()
    record("merge_scan", pec.merge_scan(kT, xT, yT, zT), pec._merge_scan_plain(kT, xT, yT, zT),
           lambda: pec.merge_scan(kT, xT, yT, zT), lambda: pec._merge_scan_plain(kT, xT, yT, zT),
           kT.numel() * (4 + 6 * FE_BYTES), MULS["add"] * both, reps=10)

    # K6 on the commit's bucket planes; lane 0: B1 = B0, lane 1: B1 = -B0,
    # lane 2: B2 = infinity
    e2 = pec.merge_scan(kT, xT, yT, zT)
    rounds = msm_gpu._cdiv(msm_gpu._cdiv(tabx.shape[0], K) + 1, 32) + 1
    ck, cx, cy, cz = msm_gpu._merge_rounds(pec, kT, *e2, 32, M2, nb, fs.H, rounds, 32)
    cx, cy, cz = msm_gpu._tree_rounds(pec, ck, cx, cy, cz)
    planes, T, C = msm_gpu._bucket_planes(ck, cx, cy, cz, kzg._pm.c, 1, fs.H)
    bx, by, bz = (v.clone() for v in planes)
    for v in (bx, by, bz):
        v[1, :, 0] = v[0, :, 0]
        v[1, :, 1] = v[0, :, 1]
    by[1, :, 1] = F.neg(by[1, :, 1][None])[0]
    bz[2, :, 2] = 0
    # adds with both operands finite (an add with infinity is a select):
    # step t adds run into wsum, then bucket t into run
    fin = ~F.is_zero(bz.transpose(1, 2))                           # (T, C)
    no = torch.zeros_like(fin[:1])
    run_fin = torch.cat([no, fin.cumsum(0)[:-1] > 0])               # run before step t
    wsum_fin = torch.cat([no, run_fin.cumsum(0)[:-1] > 0])
    n_adds = ((run_fin & fin).sum() + (wsum_fin & run_fin).sum()).item()
    record("bucket_reduce", sum(pec.bucket_reduce(bx, by, bz, T), ()),
           sum(pec._bucket_reduce_plain(bx, by, bz, T), ()),
           lambda: pec.bucket_reduce(bx, by, bz, T), lambda: pec._bucket_reduce_plain(bx, by, bz, T),
           C * (3 * T + 6) * FE_BYTES, MULS["add"] * n_adds, reps=20)

    # K3 add at the tail's width (C = 512 chunk lanes), with P == Q, P == -Q,
    # infinity on either side, and P == Q under another Z
    run, _ = pec.bucket_reduce(bx, by, bz, T)
    Pa = std(run)
    Qa = tuple(torch.roll(v, -1, 0).clone() for v in Pa)
    lam = rand_fe(1)
    lam2 = F.mul(lam, lam)
    for v, w in zip(Qa, Pa):
        v[0] = w[0]
    Qa[1][1] = F.neg(Pa[1][1][None])[0]
    Qa[0][1], Qa[2][1] = Pa[0][1], Pa[2][1]
    Pa[2][2] = 0
    Qa[2][3] = 0
    Pa[2][4] = Qa[2][4] = 0
    Qa[0][5] = F.mul(Pa[0][5][None], lam2)[0]
    Qa[1][5] = F.mul(Pa[1][5][None], F.mul(lam2, lam))[0]
    Qa[2][5] = F.mul(Pa[2][5][None], lam)[0]
    Pp, Qp = planar(Pa), planar(Qa)
    finite = (~(F.is_zero(Pa[2]) | F.is_zero(Qa[2]))).sum().item()
    record("ec_add", pec.add(Pp, Qp), planar(ec_add(F, mul_plain, Pa, Qa)),
           lambda: pec.add(Pp, Qp), lambda: ec_add(F, mul_plain, Pa, Qa),
           9 * C * FE_BYTES, MULS["add"] * finite, reps=50)
    inf_lanes = g.is_inf(std(pec.add(Pp, Qp)))
    check(bool(inf_lanes[1]) and bool(inf_lanes[4]) and not bool(inf_lanes[5]),
          "ec_add degenerate lanes")

    kernels = []
    for name in build.KERNELS:
        src, rep = REPLACES[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=counts[name], library_ms=None, **report[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
