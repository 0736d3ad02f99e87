"""K4 flush_scan and K3 add as the card runs them: the team group law, the
flush scan's lane walk and the team's split of a point's stores, built with
g++ from ``csrc/ec.cuh`` through ``csrc/ec_host.cpp``, against the plain
versions.

``ec_add_team`` and ``ec_madd_team`` (a level's independent products side
by side) are held limb for limb against the plain ``ec_add``/``ec_madd`` and
the one-thread ``ec_add``/``ec_madd`` on the degenerate lanes of
``tests/test_torch_ec.py``: infinity on either side, P = Q, P = -Q, P = Q
under another Z. ``flush_lane``, K4's walk of a lane by a team of one,
runs over every lane, in the kernel's order and reversed, into outputs
filled with a sentinel; it must write every slot, equal to
``_flush_scan_plain`` on streams with several runs, a lane that is one run,
a lane of singletons, a padding lane, P then -P and P then P; on one stream
also against the JAX package's scan; and at K = 1,472 (the batched commit's
lanes) against the lanes' sequential chain of the one-thread ec_madd.
``store_split`` must have every word of a point written by exactly one
member at the card's team size ``SM_TEAM`` (read from ``ec_kernels.cu``)
and at 1 and 3.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_ec import ec_add, ec_madd
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
NL = 12
SENTINEL = 0xDEADBEEF
PAD_KEY = 99
SM_TEAM = int(re.search(r"constexpr int SM_TEAM = (\d+);",
                        (CSRC / "ec_kernels.cu").read_text()).group(1))
P_ = ctypes.c_void_p
I_ = ctypes.c_int


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
    lib = ctypes.CDLL(str(out))
    for name, args in (("ctt_host_ec_add", [P_] * 10 + [I_]),
                       ("ctt_host_ec_add_team", [P_] * 10 + [I_]),
                       ("ctt_host_ec_madd", [P_] * 9 + [I_]),
                       ("ctt_host_ec_madd_team", [P_] * 9 + [I_]),
                       ("ctt_host_flush_scan_runs", [P_] * 6 + [I_] * 3),
                       ("ctt_host_flush_scan_seq", [P_] * 6 + [I_] * 2)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    lib.ctt_host_store_split.argtypes = [P_] * 4 + [I_]
    lib.ctt_host_store_split.restype = I_
    return lib


@pytest.fixture(scope="module")
def pts(ctx):
    """16 affine points k G and their negatives: table row i + 16 is -row i."""
    rng = np.random.default_rng(8)
    ps = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 40, size=16)]
    return ps + [rm.ec_neg(q, ctx.p) for q in ps]


def _u32(t):
    return np.ascontiguousarray(lb.to_numpy(t))


def _host_points(ctx, lib, name, ins, n):
    """Run a row-major host entry point; returns three (n, NL) tensors."""
    arrs = [_u32(t) for t in ins]
    outs = [np.zeros((n, NL), np.uint32) for _ in range(3)]
    mod = np.ascontiguousarray(ctx.fp.mod_words)
    getattr(lib, name)(mod.ctypes.data, *(a.ctypes.data for a in arrs),
                       *(o.ctypes.data for o in outs), n)
    return tuple(lb.to_tensor(o) for o in outs)


def _affine_t(ctx, ps):
    return ctx.fp.encode([q[0] for q in ps]), ctx.fp.encode([q[1] for q in ps])


def _jac_cases(ctx, pts):
    """The (P, Q) lanes of test_torch_ec._jac_cases, built with the port:
    P + Q, P + P, P + (-P), inf + Q, P + inf, inf + inf, P + P under
    another Z, and P + Q with Q = 1 in Z."""
    g = ctx.g1
    ps, neg = pts[:8], pts[16:24]
    A = g.double(g.from_affine(_affine_t(ctx, ps)))                 # Z != 1
    Aneg = g.double(g.from_affine(_affine_t(ctx, neg)))
    A1 = g.from_affine(g.to_affine(A)[0])                          # same points, Z = 1
    B = g.from_affine(_affine_t(ctx, ps[::-1]))
    inf = g.infinity((8,))

    def lanes(*choices):
        return tuple(torch.stack([choices[i % len(choices)][c][i] for i in range(8)])
                     for c in range(3))

    return lanes(A, A, A, inf, A, inf, A, B), lanes(B, A, Aneg, B, inf, inf, A1, A)


def test_add_team_matches_plain(ctx, host_lib, pts):
    P, Q = _jac_cases(ctx, pts)
    got = _host_points(ctx, host_lib, "ctt_host_ec_add_team", (*P, *Q), 8)
    plain = ec_add(ctx.fp, ctx.g1.pec._mul_plain, P, Q)
    one_thread = _host_points(ctx, host_lib, "ctt_host_ec_add", (*P, *Q), 8)
    for a, b, c in zip(got, plain, one_thread):
        assert torch.equal(a, b) and torch.equal(a, c)
    inf = ctx.g1.is_inf(got)
    assert inf[2] and inf[5] and not inf[[0, 1, 3, 4, 6, 7]].any()


def test_madd_team_matches_plain(ctx, host_lib, pts):
    """Lane i % 4: P + Q, P + P (the doubling), P + (-P), inf + Q."""
    g = ctx.g1
    A = g.double(g.from_affine(_affine_t(ctx, pts[:8])))
    A = (A[0], A[1], torch.where(torch.arange(8)[:, None] % 4 == 3, 0, A[2]))
    (ax, ay), _ = g.to_affine(A)
    bx, by = _affine_t(ctx, pts[8:16])
    kind = torch.arange(8)[:, None] % 4
    x2 = torch.where(kind == 1, ax, torch.where(kind == 2, ax, bx))
    y2 = torch.where(kind == 1, ay, torch.where(kind == 2, ctx.fp.neg(ay), by))
    got = _host_points(ctx, host_lib, "ctt_host_ec_madd_team", (*A, x2, y2), 8)
    plain = ec_madd(ctx.fp, g.pec._mul_plain, A, (x2, y2))
    one_thread = _host_points(ctx, host_lib, "ctt_host_ec_madd", (*A, x2, y2), 8)
    for a, b, c in zip(got, plain, one_thread):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert ctx.g1.is_inf(got).tolist() == [False, False, True, False] * 2
    assert torch.equal(got[0][3], bx[3]) and torch.equal(got[1][3], by[3])


# -- the flush scan's lane walk ------------------------------------------------


def _runs(lengths, first=1):
    return np.repeat(np.arange(first, first + len(lengths)), lengths)


def _stream_lanes(K, rng):
    """(keys, table rows) per lane for a K-step stream."""
    lanes = []
    cuts = np.sort(rng.choice(np.arange(1, K), size=4, replace=False))
    lanes.append((_runs(np.diff(np.concatenate([[0], cuts, [K]]))),   # several runs
                  rng.integers(0, 32, K)))
    lanes.append((np.full(K, 7), rng.integers(0, 32, K)))            # one run
    lanes.append((np.arange(1, K + 1), rng.integers(0, 32, K)))      # singletons
    lanes.append((np.full(K, PAD_KEY), np.zeros(K, int)))            # padding lane
    idx = rng.integers(0, 32, K)
    idx[:5] = [0, 16, 0, 0, 3]                                       # P, -P, P, P: inf,
    lanes.append((np.full(K, 3), idx))                               # restart, doubling
    lanes.append((np.sort(rng.integers(1, 6, K)), rng.integers(0, 32, K)))
    return lanes


def _stream(ctx, pts, lanes):
    """keys (K, M) int32 and the planar entries xy (K, 24, M) u32."""
    keys = np.stack([k for k, _ in lanes], 1).astype(np.int32)
    idx = np.stack([i for _, i in lanes], 1)
    tx, ty = (_u32(t) for t in _affine_t(ctx, pts))                 # (32, NL)
    xy = np.concatenate([tx[idx], ty[idx]], -1).transpose(0, 2, 1)   # (K, 24, M)
    return np.ascontiguousarray(keys), np.ascontiguousarray(xy), idx


STREAMS = {"K=32 M=6": (32, 3), "K=40 M=6": (40, 4)}


@pytest.fixture(scope="module")
def streams(ctx, pts):
    """Each stream with its plain scan (the kernel's plain version)."""
    out = {}
    for name, (K, seed) in STREAMS.items():
        keys, xy, idx = _stream(ctx, pts, _stream_lanes(K, np.random.default_rng(seed)))
        plain = ctx.g1.pec._flush_scan_plain(torch.from_numpy(keys), lb.to_tensor(xy))
        out[name] = keys, xy, idx, plain
    return out


def _host_flush(ctx, lib, keys, xy, walk=True, reverse=False):
    """The host lane walk (or, with walk False, the sequential one-thread
    chain) into sentinel-filled outputs."""
    K, M = keys.shape
    outs = [np.full((K, NL, M), SENTINEL, np.uint32) for _ in range(3)]
    mod = np.ascontiguousarray(ctx.fp.mod_words)
    args = (mod.ctypes.data, keys.ctypes.data, xy.ctypes.data,
            *(o.ctypes.data for o in outs), K, M)
    if walk:
        lib.ctt_host_flush_scan_runs(*args, int(reverse))
    else:
        lib.ctt_host_flush_scan_seq(*args)
    for o in outs:
        assert not (o == SENTINEL).all(1).any(), "a slot was never written"
    return tuple(lb.to_tensor(o) for o in outs)


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_flush_runs_match_plain(ctx, host_lib, streams, name, reverse):
    keys, xy, _, plain = streams[name]
    got = _host_flush(ctx, host_lib, keys, xy, reverse=reverse)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_flush_seq_matches_plain_and_degenerate_lanes(ctx, host_lib, streams):
    """The sequential chain equals the plain scan; lane 4 went through
    infinity (P - P), a restart from it and a doubling."""
    keys, xy, idx, plain = streams["K=32 M=6"]
    seq = _host_flush(ctx, host_lib, keys, xy, walk=False)
    for a, b in zip(seq, plain):
        assert torch.equal(a, b)
    assert ctx.g1.is_inf((None, None, seq[2][:4, :, 4])).tolist() == [False, True, False,
                                                                       False]
    assert torch.equal(seq[0][2, :, 4], seq[0][0, :, 4])              # inf + P = P


def test_flush_runs_match_reference_scan(ctx, host_lib, streams):
    """One stream against the JAX package's scan (select(same, madd, fresh))."""
    keys, xy, _, _ = streams["K=32 M=6"]
    jctx = jax_get_curve("BLS12_381")
    g = jctx.g1
    K, M = keys.shape
    X = convert.to_reference(lb.to_tensor(xy[:, :NL]).permute(0, 2, 1))   # (K, M, 24)
    Y = convert.to_reference(lb.to_tensor(xy[:, NL:]).permute(0, 2, 1))
    acc, cur, ref = g.infinity((M,)), np.full(M, -1), []
    for k in range(K):
        q = (jnp.asarray(X[k]), jnp.asarray(Y[k]))
        acc = g.select(jnp.asarray(keys[k] == cur), g.madd(acc, q), g.from_affine(q))
        ref.append(acc)
        cur = keys[k]
    got = _host_flush(ctx, host_lib, keys, xy)
    for c in range(3):
        exp = np.stack([np.asarray(r[c]) for r in ref])               # (K, M, 24)
        assert np.array_equal(convert.to_reference(got[c].permute(0, 2, 1)), exp), c


def test_long_lane_matches_sequential_chain(ctx, host_lib, pts):
    """K = 1,472, M = 2: lane 0 one run (the zero blob's lanes), lane 1 runs
    of ~46 (a dense commit's)."""
    K = 1472
    rng = np.random.default_rng(1472)
    lens = rng.integers(1, 92, size=64)
    lane1 = _runs(lens)[:K]
    lane1 = np.concatenate([lane1, np.full(K - lane1.size, lane1[-1] + 1)])
    keys, xy, _ = _stream(ctx, pts, [(np.zeros(K, int), rng.integers(0, 32, K)),
                                     (lane1, rng.integers(0, 32, K))])
    seq = _host_flush(ctx, host_lib, keys, xy, walk=False)
    got = _host_flush(ctx, host_lib, keys, xy)
    for a, b in zip(got, seq):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", sorted({1, 3, SM_TEAM}))
def test_store_split_writes_every_word_once(ctx, host_lib, pts, T):
    """Each member of a team of T stores into its own sentinel-filled copy;
    every word of X, Y and Z is written by exactly one member, with its
    value, and the members share the 36 words evenly."""
    P = ctx.g1.double(ctx.g1.from_affine(_affine_t(ctx, pts[:1])))
    words = np.concatenate([_u32(c)[0] for c in P])                  # (3 NL,)
    out = np.full((T, 3 * NL), SENTINEL, np.uint32)
    arrs = [_u32(c) for c in P]
    assert host_lib.ctt_host_store_split(*(a.ctypes.data for a in arrs),
                                         out.ctypes.data, T) == 0
    written = out != SENTINEL
    assert (written.sum(0) == 1).all()
    assert (np.where(written, out, 0).sum(0) == words).all()
    assert written.sum(1).max() - written.sum(1).min() <= 1
