"""K13 g1_decompress as the card runs it: ``csrc/g1.cuh``'s team lane,
built with g++ through ``csrc/pairing_host.cpp``, against the one-thread
lane, the plain version and the JAX package's reference math.

``g1_decompress_team`` takes the square root by 4-bit windows over
``fe_mul_eo`` (the window table built by the team) and the Scott ladder in
levels of independent products. ``ctt_host_g1_decompress_team`` runs it
with a team of one and with a thread for each member of a team of 2 and of
the kernel's ``G1_TEAM`` (read from ``g1_kernels.cu``), each member storing
its share of y and ok into outputs filled with a sentinel: every word must
be written, and y and ok must equal ``ctt_host_g1_decompress`` (the one-thread lane,
bit by bit over ``fe_mul``), ``_decompress_plain`` and what the JAX package's
``PallasG1`` computes, worked out here with that package's ``refmath`` and
curve constants (no JAX import: the root rhs^((p + 1)/4), the lexicographic
sign fix, is-square and, for the subgroup bit, [r]P = infinity, which Scott's
test in the kernel is equivalent to on the curve). The points are G1
points with both signs, a non-square x, an on-curve point outside G1 and
x = 0. ``G1DecompressConsts`` as the wrapper packs it has the size the
library reports, and its window digits spell (p + 1)/4.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu.named.curves import BLS12_381 as PKG_BLS12_381
from constantine_tpu.utils import refmath as pkg_rm
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_g1 import SQRT_WINDOWS, get_cuda_g1
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
NL = 12
SENTINEL = 0xDEADBEEF
G1_TEAM = int(re.search(r"constexpr int G1_TEAM = (\d+);",
                        (CSRC / "g1_kernels.cu").read_text()).group(1))
P_ = ctypes.c_void_p
I_ = ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("pairing_host") / "libpairing_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-pthread", "-o", str(out), str(CSRC / "pairing_host.cpp")], check=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.ctt_host_g1_decompress.argtypes = [P_] * 5 + [I_]
    lib.ctt_host_g1_decompress.restype = None
    lib.ctt_host_g1_decompress_team.argtypes = [P_, I_] + [P_] * 4 + [I_]
    lib.ctt_host_g1_decompress_team.restype = I_
    lib.ctt_host_g1_consts_size.argtypes = []
    lib.ctt_host_g1_consts_size.restype = I_
    return lib


@pytest.fixture(scope="module")
def lanes():
    """Montgomery x (n, NL) and sign (n,) int32, with the plain result and
    the JAX package's (y words, ok list): G1 points 1, 2, 77, 12345 times G,
    lane 1 asking for the other root; an on-curve point outside G1 with both
    signs; a non-square x; x = 0."""
    ctx = get_curve("BLS12_381")
    p = ctx.p
    half = (p + 1) // 2
    pts = [rm.ec_mul(k, ctx.g, 0, p) for k in (1, 2, 77, 12345)]
    x_out = next(x for x in range(3, 100)
                 if rm.sqrt_mod(x ** 3 + 4, p) is not None
                 and rm.ec_mul(ctx.r, (x, rm.sqrt_mod(x ** 3 + 4, p)), 0, p) is not None)
    x_nsq = next(x for x in range(3, 100) if rm.sqrt_mod(x ** 3 + 4, p) is None)
    xs = [q[0] for q in pts] + [x_out, x_out, x_nsq, 0]
    sign = [q[1] >= half for q in pts] + [True, False, True, False]
    sign[1] = not sign[1]
    xm = ctx.fp.encode(xs)
    sign = torch.tensor(sign)
    y, ok = get_cuda_g1()._decompress_plain(xm, sign)
    assert ok.tolist() == [True] * 4 + [False] * 4
    y_pkg, ok_pkg = _reference_package(xs, sign.tolist())
    assert ok_pkg == ok.tolist()
    return (np.ascontiguousarray(lb.to_numpy(xm)), sign.to(torch.int32).numpy(), y, ok,
            y_pkg, ok_pkg)


def _reference_package(xs, signs):
    """PallasG1's y (Montgomery words) and ok, from the JAX package's
    refmath and BLS12-381 constants."""
    c = PKG_BLS12_381
    p = c.p
    ys, oks = [], []
    for x, sign in zip(xs, signs):
        rhs = (x ** 3 + c.b) % p
        y = pow(rhs, (p + 1) // 4, p)
        is_sq = y * y % p == rhs
        assert (pkg_rm.sqrt_mod(rhs, p) is not None) == is_sq
        if is_sq:
            assert pkg_rm.sqrt_mod(rhs, p) in (y, (p - y) % p)
        if (y >= (p + 1) // 2) != sign:
            y = (p - y) % p
        in_g1 = is_sq and pkg_rm.ec_mul(c.r, (x, y), c.a, p) is None
        ym = (y << (32 * NL)) % p
        ys.append([(ym >> (32 * i)) & 0xFFFFFFFF for i in range(NL)])
        oks.append(is_sq and in_g1)
    return np.asarray(ys, np.uint32), oks


def _run(lib, fn, *args, n):
    y = np.full((n, NL), SENTINEL, np.uint32)
    ok = np.full(n, -7, np.int32)
    consts = get_cuda_g1()._consts
    rc = getattr(lib, fn)(consts.ctypes.data, *args[:-2], args[-2].ctypes.data,
                          args[-1].ctypes.data, y.ctypes.data, ok.ctypes.data, n)
    assert rc in (None, 0), f"{fn} returned {rc}"
    return y, ok


@pytest.mark.parametrize("T", sorted({1, 2, G1_TEAM}))
def test_team_lane_matches_one_thread_and_plain(host_lib, lanes, T):
    xm, sign, y_plain, ok_plain, y_pkg, ok_pkg = lanes
    n = xm.shape[0]
    y, ok = _run(host_lib, "ctt_host_g1_decompress_team", T, xm, sign, n=n)
    assert not (y == SENTINEL).any() and not (ok == -7).any(), "a word was never written"
    y1, ok1 = _run(host_lib, "ctt_host_g1_decompress", xm, sign, n=n)
    assert np.array_equal(y, y1) and np.array_equal(ok, ok1)
    assert torch.equal(lb.to_tensor(y), y_plain) and ok.tolist() == ok_plain.int().tolist()
    assert np.array_equal(y, y_pkg) and ok.tolist() == [int(b) for b in ok_pkg]


def test_team_sizes_of_the_host_build(host_lib, lanes):
    """The host build plays teams of 1, 2 and 4 and no other size."""
    xm, sign = lanes[:2]
    assert G1_TEAM in (1, 2, 4)
    y = np.zeros((1, NL), np.uint32)
    ok = np.zeros(1, np.int32)
    consts = get_cuda_g1()._consts
    assert host_lib.ctt_host_g1_decompress_team(consts.ctypes.data, 3, xm.ctypes.data,
                                                sign.ctypes.data, y.ctypes.data,
                                                ok.ctypes.data, 1) == -1


def test_consts_packing(host_lib):
    ctx = get_curve("BLS12_381")
    consts = get_cuda_g1()._consts
    assert host_lib.ctt_host_g1_consts_size() == consts.nbytes
    e = (ctx.p + 1) // 4
    nwin = int(consts[-1])
    digits = consts[-1 - SQRT_WINDOWS // 4:-1].view(np.uint8)
    assert nwin == -(-e.bit_length() // 4) and digits[nwin - 1] != 0
    assert not digits[nwin:].any()
    assert sum(int(d) << (4 * i) for i, d in enumerate(digits[:nwin])) == e
