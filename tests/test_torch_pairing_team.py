"""The pairing kernels' team schedule on the host: K11's and K12's programs
(csrc/pairing.cuh, built with g++ through csrc/pairing_host.cpp) run by one
thread that plays every member of the team in turn, held limb for limb
against the plain versions (ops/cuda_pairing.py) and the JAX package's GT
values in tests/data/torch_pairing_golden.json.

Each program is scheduled for the team size the kernels are built with
(the TEAM constant of csrc/miller_loop.cu and csrc/final_exp.cu) and for a
team of one. At the kernels' size the members run in order and reversed: a
round whose tasks read and write one slot gives another result in one of
the two orders, so equal results show that the rounds are independent, as
the card needs them. No JAX here: seconds on one worker.
"""

import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.pairing import get_pairing
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_pairing_golden.json"
CSRC = ROOT / "constantine_tpu_torch" / "csrc"
STATS = ("T", "rounds", "product_rounds", "inverse_muls", "products", "sums", "slots")


def card_team(stem):
    """The team size a kernel source is built with."""
    return int(re.search(r"constexpr int TEAM = (\d+);", (CSRC / f"{stem}.cu").read_text())[1])


SCHEDULES = [pytest.param(card_team("miller_loop"), card_team("final_exp"), rev,
                          id=f"card-team-{'reversed' if rev else 'in-order'}")
             for rev in (False, True)] + [pytest.param(1, 1, False, id="team-of-one")]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("pairing_team") / "libpairing_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC", "-o",
                    str(out), str(CSRC / "pairing_host.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ctt_host_miller_loop_team.argtypes = [P, I, I] + [P] * 5 + [I]
    lib.ctt_host_final_exp_team.argtypes = [P, I, I, P, P, I]
    lib.ctt_host_program_stats.argtypes = [P, I, I, P]
    for f in (lib.ctt_host_miller_loop_team, lib.ctt_host_final_exp_team,
              lib.ctt_host_program_stats):
        f.restype = None
    return lib


def _np(t):
    return np.ascontiguousarray(lb.to_numpy(t))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.fixture(scope="module")
def case():
    """Pairs (G1, G2), ([a]G1, [b]G2) from the golden file and (-[a]G1, -[b]G2);
    their plain Miller values; K12 inputs: those values, one and a
    non-unitary Fp12 from a seed; and the plain final exponentiations."""
    ctx = get_curve("BLS12_381")
    pr = get_pairing()
    eng = pr.engine
    golden = json.loads(GOLDEN.read_text())
    a, b = (int(golden["scalars"][k], 16) for k in "ab")
    g1 = [ctx.g, rm.ec_mul(a, ctx.g, 0, ctx.p)]
    g2 = [ctx.g2_aff, rm.ec2_mul(b, ctx.g2_aff, (0, 0), -1, ctx.p)]
    g1.append(rm.ec_neg(g1[1], ctx.p))
    g2.append((g2[1][0], tuple((-c) % ctx.p for c in g2[1][1])))
    F = ctx.fp
    P = (F.encode([q[0] for q in g1]), F.encode([q[1] for q in g1]))
    Q = tuple(F.encode([c for q in g2 for c in q[i]]).reshape(-1, 2, F.NL) for i in (0, 1))
    f = eng._miller_loop_plain(*P, *Q)
    rng = np.random.default_rng(77)
    junk = F.encode([int.from_bytes(rng.bytes(48), "big") % ctx.p for _ in range(12)])
    fin = torch.cat([f, pr.fp12.one((1,), "cpu"), junk.reshape(1, 12, F.NL)])
    return pr, golden, P, Q, f, fin, eng._final_exp_plain(fin)


@pytest.mark.parametrize("t_miller, t_fexp, reverse", SCHEDULES)
def test_team_miller_loop_matches_plain(host_lib, case, t_miller, t_fexp, reverse):
    """K11's program against _miller_loop_plain, limb for limb, on the golden
    pairs and on (-[a]G1, -[b]G2)."""
    pr, _, P, Q, f, _, _ = case
    ins = [_np(t) for t in (*P, *Q)]
    out = np.zeros((3, 12, 12), np.uint32)
    host_lib.ctt_host_miller_loop_team(_ptr(pr.engine._consts), t_miller, int(reverse),
                                       *map(_ptr, ins), _ptr(out), 3)
    assert np.array_equal(out, _np(f))


@pytest.mark.parametrize("t_miller, t_fexp, reverse", SCHEDULES)
def test_team_final_exp_matches_plain(host_lib, case, t_miller, t_fexp, reverse):
    """K12's program against _final_exp_plain on the three Miller values,
    on f = 1 and on a non-unitary Fp12; the golden pairs give the JAX
    package's GT values, e(-[a]G1, -[b]G2) equals e([a]G1, [b]G2), and one
    stays one."""
    pr, golden, _, _, _, fin, want = case
    x = _np(fin)
    out = np.zeros_like(x)
    host_lib.ctt_host_final_exp_team(_ptr(pr.engine._consts), t_fexp, int(reverse), _ptr(x),
                                     _ptr(out), x.shape[0])
    assert np.array_equal(out, _np(want))
    gt = lb.to_tensor(out)
    assert [hex(v) for v in pr.fp12.decode(gt[0])] == golden["e(G1,G2)"]
    assert [hex(v) for v in pr.fp12.decode(gt[1])] == golden["e([a]G1,[b]G2)"]
    assert torch.equal(gt[2], gt[1])
    assert torch.equal(gt[3], pr.fp12.one((), "cpu"))


def _stats(lib, consts, which, T):
    out = np.zeros(len(STATS), np.int32)
    lib.ctt_host_program_stats(_ptr(consts), which, T, _ptr(out))
    return dict(zip(STATS, out.tolist()))


@pytest.mark.parametrize("which, stem", [(0, "miller_loop"), (1, "final_exp")])
def test_team_schedule_packs_the_products(host_lib, case, which, stem):
    """The same products at every team size; a team of one runs one task a
    round; the kernel's team packs them into far fewer rounds, every round
    within T tasks, and its slot file fits the kernel's shared memory."""
    consts = case[0].engine._consts
    one = _stats(host_lib, consts, which, 1)
    T = card_team(stem)
    team = _stats(host_lib, consts, which, T)
    assert team["T"] == T and one["T"] == 1
    assert team["products"] == one["products"] and team["sums"] == one["sums"]
    assert one["rounds"] == one["products"] + one["sums"] + (which == 1)
    assert team["product_rounds"] * T >= team["products"] - T
    assert team["product_rounds"] < one["product_rounds"] / 8
    assert team["rounds"] * T >= team["products"] + team["sums"]
    e = get_curve("BLS12_381").p - 2               # the inverse: fixed 4-bit windows
    nw = (e.bit_length() + 3) // 4
    window_muls = 14 + 4 * (nw - 1) + sum((e >> 4 * i) & 15 != 0 for i in range(nw - 1))
    assert team["inverse_muls"] == (window_muls if which == 1 else 0)
    assert 21 < team["slots"] <= 1024
