#!/usr/bin/env python3
"""K11 miller_loop and K12 final_exp: team size and chain floor, on one NVIDIA card.

    python3 scripts/torch_pairing_teams.py

1. Builds the port's kernels (-Xptxas -v: registers, stack frame, spills)
   and holds K11 at B = 2 and K12 at B = 1 exactly against their plain
   versions.
2. The chain floor: one fe_mul_eo's latency in a lone thread's dependent
   chain (the chain kernel of scripts/torch_scalar_mul_teams.py); a
   kernel's floor is (its program's rounds with a product + the inverse's
   lone multiplies) x that latency, from the program the kernel runs
   (ctt_miller_loop_stats, ctt_final_exp_stats).
3. Team size: builds miller_loop.cu and final_exp.cu from copies of csrc/
   with TEAM set to 8, 16, 32 and 64 threads a lane (the sources fix one
   value each), one nvcc each, all started together, into
   constantine_tpu_torch/_build/pairing_teams/; holds every variant exactly
   against the port's kernel at B = 2 and 256 (K11: [k]G1, [k']G2 with k,
   k' < 2^60 from seed 5, as chip_smoke.py's pairing B=256) and B = 1 and 256
   (K12: the product of two Miller values, and the 256 Miller values), and
   times it with CUDA events.
4. Task width and prefetch: TASK_TERMS at 8 and 16 (the sources fix 12), and
   each member's tasks loaded 2 or 4 rounds ahead (the sources: 1); exact,
   timed at B = 2 and 1.
5. What a round costs: at the sources' TEAM, variants that drop the
   products' multiply (an add instead), the sums' reduction mod p, the
   sums' arithmetic altogether (the terms are still loaded), all of these,
   or the inverse, timed at B = 2 and 1 (timing only: their results
   differ).

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
sys.path.insert(0, str(ROOT / "scripts"))

from constantine_tpu_torch import build  # noqa: E402
from constantine_tpu_torch.named.precompute import get_curve  # noqa: E402
from constantine_tpu_torch.ops.pairing import get_pairing  # noqa: E402
from constantine_tpu_torch.utils import refmath as rm  # noqa: E402
from torch_scalar_mul_teams import events_ms, mul_latency, patched, start_mul_chain  # noqa: E402

TEAMS = (8, 16, 32, 64)
TEAM_LINE = "constexpr int TEAM = 32;"
NO_PRODUCT = ("program.cuh",
              "r = fe_mul_eo<FPN>(lin_reduce(lo, M, inv_p), lin_reduce(hi, M, inv_p), M);",
              "r = fe_add<FPN>(lin_reduce(lo, M, inv_p), lin_reduce(hi, M, inv_p), M);")
NO_REDUCE = ("program.cuh",
             "CTT_HD Fp lin_reduce(const LinAcc& a, const MdP& M, double inv_p) {\n",
             "CTT_HD Fp lin_reduce(const LinAcc& a, const MdP& M, double inv_p) {\n"
             "  if (inv_p > 0) {\n    Fp z;\n"
             "    for (int l = 0; l < FPN; ++l) z.v[l] = (uint32_t)a.v[l];\n    return z;\n  }\n")
NO_ACC = ("program.cuh",
          "lin_term(i < MUL_TERMS ? lo : hi, slot_load(s, t.slot[i]), t.coef[i]);",
          "(i < MUL_TERMS ? lo : hi).v[i] += slot_load(s, t.slot[i]).v[i];")
TERMS_LINE = "constexpr int TASK_TERMS = 12;"
AHEAD_LINE = "constexpr int AHEAD = 1;"
# exact variants: wider tasks (fewer rounds of sums, more work a task) and
# tasks loaded further ahead
WIDTHS = {f"terms {n}": [("program.cuh", TERMS_LINE, f"constexpr int TASK_TERMS = {n};")]
          for n in (8, 16)} | {f"ahead {n}": [("pairing.cuh", AHEAD_LINE,
                                             f"constexpr int AHEAD = {n};")] for n in (2, 4)}
# name: patches of the sources; timing only: each drops one part of a task
ABLATIONS = {
    "no products": [NO_PRODUCT],
    "no reductions": [NO_REDUCE],
    "no sums": [NO_ACC, NO_REDUCE],
    "neither": [NO_PRODUCT, NO_ACC, NO_REDUCE],
    "no inverse": [("program.cuh", "r = fp_pow_window(lin_reduce(lo, M, inv_p), inv_exp, M);",
                    "r = lin_reduce(lo, M, inv_p);")],
}
KERNELS = {"miller_loop": ("ctt_miller_loop", 6, (2, 256)),
           "final_exp": ("ctt_final_exp", 3, (1, 256))}
STATS = ("T", "rounds", "product rounds", "inverse multiplies", "products", "sums", "slots")
P_, I_ = ctypes.c_void_p, ctypes.c_int


def build_variants(out_dir: Path):
    """Start every nvcc at once; returns {name: CDLL} of the builds that passed."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    jobs = {}
    variants = {t: [] for t in TEAMS} | WIDTHS | ABLATIONS
    for name, patches in variants.items():
        d = out_dir / (f"t{name}" if name in TEAMS else name.replace(" ", "_"))
        shutil.copytree(build.CSRC, d)
        for f, old, new in patches:
            (d / f).write_text(patched((d / f).read_text(), old, new))
        for stem in KERNELS:
            src = d / f"{stem}.cu"
            if name in TEAMS:
                src.write_text(patched(src.read_text(), TEAM_LINE,
                                       f"constexpr int TEAM = {name};"))
            jobs[name, stem] = src
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
            print(f"[nvcc {name}] {line}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def stats(lib, stem, consts):
    out = (ctypes.c_int * len(STATS))()
    f = getattr(lib, f"ctt_{stem}_stats")
    f.argtypes, f.restype = [P_, P_], I_
    f(ctypes.c_void_p(consts.ctypes.data), out)
    return dict(zip(STATS, out))


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"port build: {build.build_all(verbose=True):.1f} s", flush=True)
    libs = build_variants(build.BUILD_DIR / "pairing_teams")
    ok = len(libs) == 1 + (len(TEAMS) + len(WIDTHS) + len(ABLATIONS)) * len(KERNELS)

    ctx = get_curve("BLS12_381")
    F = ctx.fp
    dev = torch.device("cuda", 0)
    pr = get_pairing()
    eng, p12 = pr.engine, pr.fp12
    consts = eng._consts

    def same(got, want, what):
        nonlocal ok
        eq = torch.equal(got, want)
        print(f"check {what}: {'exact' if eq else 'DIFFERS'}", flush=True)
        ok &= eq

    prng = np.random.default_rng(5)
    g1s = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in prng.integers(2, 2 ** 60, size=256)]
    g2s = [rm.ec2_mul(int(k), ctx.g2_aff, (0, 0), -1, ctx.p)
           for k in prng.integers(2, 2 ** 60, size=256)]
    P256 = (F.encode([q[0] for q in g1s], dev), F.encode([q[1] for q in g1s], dev))
    Q256 = tuple(F.encode([c for q in g2s for c in q[i]], dev).reshape(256, 2, F.NL)
                 for i in (0, 1))
    f256 = eng.miller_loop(P256, Q256)
    f1 = p12.mul(f256[:1], f256[1:2])
    inputs = {"miller_loop": {n: tuple(t[:n].contiguous() for t in P256 + Q256)
                              for n in (2, 256)},
              "final_exp": {1: (f1,), 256: (f256,)}}

    # 1. the port's kernels against their plain versions
    P2, Q2 = tuple(t[:2] for t in P256), tuple(t[:2] for t in Q256)
    same(eng.miller_loop(P2, Q2), eng._miller_loop_plain(*P2, *Q2), "miller_loop B=2 = plain")
    same(eng.final_exp(f1), eng._final_exp_plain(f1), "final_exp B=1 = plain")
    port = {"miller_loop": lambda xs: eng.miller_loop(xs[:2], xs[2:]),
            "final_exp": lambda xs: eng.final_exp(xs[0])}

    # 2. one multiply's latency, and each kernel's program and floor
    lat = None
    if "mul_chain" in libs:
        lat, exact, t = mul_latency(libs["mul_chain"], ctx, dev, True)
        print(f"check fe_mul_eo chain of 3 = plain: {'exact' if exact else 'DIFFERS'}", flush=True)
        ok &= exact
        print(f"fe_mul_eo: {lat:.4f} us a multiply in a lone thread's dependent chain "
              f"({t[0]:.4f} / {t[1]:.4f} ms, CUDA events)", flush=True)

    # 3-4. team sizes and ablations against the port's kernel, and their times
    for stem, (sym, nargs, sizes) in KERNELS.items():
        for n in sizes:
            xs = inputs[stem][n]
            want = port[stem](xs)
            times = {}
            for name in (*TEAMS, *WIDTHS, *ABLATIONS):
                if (name, stem) not in libs or (name in ABLATIONS and n != sizes[0]):
                    continue
                label = f"T={name}" if name in TEAMS else name
                f = getattr(libs[name, stem], sym)
                f.argtypes, f.restype = [P_] * nargs + [I_, P_], I_
                out = torch.empty_like(want)
                stream = torch.cuda.current_stream(dev).cuda_stream

                def run(f=f, out=out, xs=xs, stream=stream, label=label):
                    rc = f(ctypes.c_void_p(consts.ctypes.data), *map(build.ptr, xs),
                           build.ptr(out), n, stream)
                    if rc != 0:
                        raise RuntimeError(f"{sym} {label}: CUDA error {rc}")
                run()
                torch.cuda.synchronize()
                if name not in ABLATIONS:
                    same(out, want, f"{stem} {label} B={n} = the port's kernel")
                times[label] = events_ms(run, 5)
            print(f"{stem} B={n}, ms a call (CUDA events; the ablations no products, no "
                  "reductions, no sums, neither and no inverse are timing only): "
                  + ", ".join(f"{k} {ms:.4f}" for k, ms in times.items()), flush=True)
        for t in TEAMS:
            if (t, stem) in libs:
                s = stats(libs[t, stem], stem, consts)
                floor = (f"; chain floor ({s['product rounds']} + {s['inverse multiplies']}) x "
                         f"{lat:.4f} us = "
                         f"{(s['product rounds'] + s['inverse multiplies']) * lat * 1e-3:.4f} ms"
                         if lat else "")
                print(f"{stem} T={t} program: " + ", ".join(f"{k} {v}" for k, v in s.items())
                      + floor, flush=True)
    print("all exact" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
