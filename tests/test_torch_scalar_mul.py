"""G1 scalar multiplication: the plain ladder against the ec_scalar_mul kernel's
own step functions and against host big ints.

``ECGroup.scalar_mul`` on CPU tensors is the per-bit loop of the plain
double, add and select, which is the kernel's plain version. The kernel's
ladder (``csrc/ec.cuh``: the levels of a bit's products for a team of
threads) is built here with g++ through ``csrc/ec_host.cpp`` as a team of one
and held limb for limb against that loop at FK20's 255 bits, on lanes that
reach each branch of the add: k = 0 and 1; k = r - 1; k = r, whose last add
is D + (-D); k = r + 2, whose last add doubles; Q at infinity. Its two-chain
multiply (``fe_mul_eo``) is held against K1's plain version. No JAX:
``tests/test_torch_ntt.py`` holds scalar_mul against the JAX package.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
BITS = 255
INF_LANE = 5


@pytest.fixture(scope="module")
def ctx():
    return get_curve("BLS12_381")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("ec_host") / "libec_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "ec_host.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def case(ctx):
    """Scalars (not reduced mod r), affine points, Jacobian points with Z != 1
    (one lane at infinity with X, Y != 1) and the plain ladder's result."""
    r = ctx.r
    rng = np.random.default_rng(255)
    ks = [0, 1, r - 1, r, r + 2, 12345] + [int.from_bytes(rng.bytes(32), "big") >> 1
                                           for _ in range(3)]
    pts = [rm.ec_mul(7 + 2 * i, ctx.g, 0, ctx.p) for i in range(len(ks))]
    inf = torch.tensor([i == INF_LANE for i in range(len(ks))])
    X = ctx.fp.encode([q[0] for q in pts])
    Y = ctx.fp.encode([q[1] for q in pts])
    P = ctx.g1.double(ctx.g1.from_affine((X, Y), inf_mask=inf))
    k = lb.to_tensor(lb.ints_to_limbs(ks, ctx.fr.NL))
    return ks, pts, P, k, ctx.g1.scalar_mul(k, P, scalar_bits=BITS)


def _host_ladder(lib, F, k, P, nbits):
    ins = [np.ascontiguousarray(lb.to_numpy(t)) for t in (k, *P)]
    outs = [np.zeros_like(ins[1]) for _ in range(3)]
    mod = np.ascontiguousarray(F.mod_words)
    fn = lib.ctt_host_ec_scalar_mul
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 2
    fn.restype = None
    fn(mod.ctypes.data, ins[0].ctypes.data, k.shape[1], *(a.ctypes.data for a in ins[1:]),
       *(o.ctypes.data for o in outs), k.shape[0], nbits)
    return tuple(lb.to_tensor(o) for o in outs)


def _affine(ctx, P):
    (x, y), inf = ctx.g1.to_affine(P)
    return [None if i else (a, b) for a, b, i in zip(ctx.fp.decode(x), ctx.fp.decode(y),
                                                      inf.tolist())]


def test_two_chain_multiply_matches_plain(host_lib, ctx):
    """fe_mul_eo, the ladder's multiply, gives K1's canonical limbs, with 0,
    1 and p - 1 operands among seeded ones."""
    F = ctx.fp
    rng = np.random.default_rng(12)
    xs = [int.from_bytes(rng.bytes(48), "big") % F.p_int for _ in range(512)]
    ys = [int.from_bytes(rng.bytes(48), "big") % F.p_int for _ in range(512)]
    xs[:4], ys[:4] = [0, 1, F.p_int - 1, F.p_int - 1], [F.p_int - 1] * 3 + [1]
    a, b = F.from_int(xs), F.from_int(ys)
    A, B = (np.ascontiguousarray(lb.to_numpy(t)) for t in (a, b))
    out = np.zeros_like(A)
    mod = np.ascontiguousarray(F.mod_words)
    fn = host_lib.ctt_host_fp_mul_eo
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    fn.restype = None
    fn(mod.ctypes.data, A.ctypes.data, B.ctypes.data, out.ctypes.data, len(xs))
    assert torch.equal(lb.to_tensor(out), mont_mul_plain(a, b, F))


def test_ladder_step_functions_match_plain(host_lib, ctx, case):
    """The kernel's levels, as a team of one, equal the plain per-bit loop in
    every Jacobian limb, degenerate lanes included."""
    _, _, P, k, want = case
    got = _host_ladder(host_lib, ctx.fp, k, P, BITS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ladder_matches_host_big_ints(ctx, case):
    """[0]P = [r]P = inf, [1]P = P, [r - 1]P = -P, [r + 2]P = 2P, inf stays inf."""
    ks, pts, _, _, got = case
    p, r = ctx.p, ctx.r
    want = [None if i == INF_LANE else rm.ec_mul(2 * kk, q, 0, p)
            for i, (kk, q) in enumerate(zip(ks, pts))]
    assert _affine(ctx, got) == want
    two = [rm.ec_mul(2, q, 0, p) for q in pts]
    assert want[:5] == [None, two[1], rm.ec_neg(two[2], p), None, rm.ec_mul(2, two[4], 0, p)]
    assert r + 2 < 1 << BITS


def test_broadcast_scalars_match_host_ladder(host_lib, ctx, case):
    """An EC-FFT stage's shape: one scalar per column broadcast over blocks
    and a trailing batch axis, at 24 bits."""
    _, _, P, _, _ = case
    pts = tuple(v[:8].reshape(2, 2, 2, -1) for v in P)                 # (blocks, half, batch)
    tw = lb.to_tensor(lb.ints_to_limbs([0xABCDEF, 0x123457], ctx.fr.NL)).reshape(1, 2, 1, -1)
    got = ctx.g1.scalar_mul(tw, pts, scalar_bits=24)
    k = tw.expand(2, 2, 2, -1).reshape(8, -1)
    want = _host_ladder(host_lib, ctx.fp, k, tuple(v.reshape(8, -1) for v in pts), 24)
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(8, -1), b)


@pytest.mark.parametrize("k, nbits", [
    (torch.zeros((8, 3), dtype=torch.int32), 255),
    (torch.zeros((8, 4), dtype=torch.int32), 0),
    (torch.zeros((8, 4), dtype=torch.int32), 257),
    (torch.zeros((2, 8, 4), dtype=torch.int32), 16),
    (torch.zeros((8, 4), dtype=torch.int64), 255),                    # not 32-bit limbs
    (torch.zeros((4, 8), dtype=torch.int32).T, 255),                  # lane axis not contiguous
], ids=["lanes", "nbits0", "nbits257", "rank3", "int64", "strided"])
def test_scalar_mul_wrapper_rejects_bad_input(ctx, k, nbits):
    P = tuple(v[:4].T.contiguous() for v in ctx.g1.infinity((4,)))
    with pytest.raises(ValueError):
        ctx.g1.pec.scalar_mul(k, P, nbits)
