"""K6 bucket_reduce as the card runs it: ``csrc/ec.cuh``'s ``bucket_lane``,
built with g++ through ``csrc/ec_host.cpp``, against the plain version and
the JAX package's add sequence.

Lane c's run = sum_t B[t] and wsum = sum_t (T-1-t) B[t] come from the
reference's loop (wsum += run, then run += B[t]). The kernel gives a lane
two teams: one carries wsum, the other run, the step's two adds side by
side, and the new run is handed over at a barrier of both. An add with an
operand at infinity is a select. ``ctt_host_bucket_reduce_teams`` plays every
lane of a launch, a thread for each member of its two teams, the lanes in
the kernel's order and reversed, into outputs filled with a sentinel: every
word must be written, and equal ``_bucket_reduce_plain``'s, at the kernel's
team size ``SM_TEAM`` (read from ``ec_kernels.cu``) and at a team of one,
for T = 4, 8 and 16. The lanes hold: random buckets; B1 = B0 (run + B1
doubles); B1 = -B0 (run falls to infinity and restarts); a lane at infinity
throughout; empty buckets, among them B1 (so wsum + run doubles at step 2)
and B0; a lane whose only finite bucket is the last. One stream is also held
against the JAX package's adds.
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
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
NL = 12
C = 8
SENTINEL = 0xDEADBEEF
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
                    "-pthread", "-o", str(out), str(CSRC / "ec_host.cpp")], check=True,
                   timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.ctt_host_bucket_reduce_teams.argtypes = [P_, I_, I_] + [P_] * 9 + [I_, I_]
    lib.ctt_host_bucket_reduce_teams.restype = I_
    return lib


def _bucket_index(rng, T):
    """(T, C) indices into the point list: i < 32 point i, 32 + i its
    negative, 64 infinity."""
    inf = 64
    idx = rng.integers(0, 32, (T, C))
    idx[1, 1] = idx[0, 1]                    # B1 = B0: run + B1 doubles
    idx[1, 2] = idx[0, 2] + 32               # B1 = -B0: run falls to infinity
    idx[:, 3] = inf                          # infinity throughout
    idx[1::3, 4] = inf                       # empty buckets, B1 among them
    idx[0, 5], idx[2, 5] = inf, inf          # B0 empty
    idx[:-1, 6] = inf                        # only the last bucket finite
    return idx


@pytest.fixture(scope="module")
def points(ctx):
    """(65, NL) x 3 Jacobian points with Z != 1: 32 seeded multiples of G,
    their negatives, then infinity."""
    rng = np.random.default_rng(6)
    ps = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 40, size=32)]
    ps += [rm.ec_neg(q, ctx.p) for q in ps]
    g = ctx.g1
    J = g.double(g.from_affine((ctx.fp.encode([q[0] for q in ps]),
                                ctx.fp.encode([q[1] for q in ps]))))
    J = tuple(torch.cat([v, v[:1]]) for v in J)
    J[2][64] = 0
    return J


_streams = {}


def _stream(ctx, points, T):
    """Buckets (T, NL, C) u32 x 3 and the plain version's (run, wsum)."""
    if T not in _streams:
        idx = _bucket_index(np.random.default_rng(T), T)
        B = tuple(np.ascontiguousarray(lb.to_numpy(v)[idx].transpose(0, 2, 1)) for v in points)
        plain = ctx.g1.pec._bucket_reduce_plain(*map(lb.to_tensor, B), T)
        _streams[T] = B, plain
    return _streams[T]


def _host_reduce(ctx, lib, B, T, team, reverse=False):
    outs = [np.full((NL, C), SENTINEL, np.uint32) for _ in range(6)]
    mod = np.ascontiguousarray(ctx.fp.mod_words)
    rc = lib.ctt_host_bucket_reduce_teams(mod.ctypes.data, team, int(reverse),
                                          *(b.ctypes.data for b in B),
                                          *(o.ctypes.data for o in outs), T, C)
    assert rc == 0
    for o in outs:
        assert not (o == SENTINEL).all(0).any(), "a lane's output was never written"
    got = tuple(lb.to_tensor(o) for o in outs)
    return got[:3], got[3:]


@pytest.mark.parametrize("T", [4, 8, 16])
@pytest.mark.parametrize("team", sorted({1, SM_TEAM}))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_bucket_lanes_match_plain(ctx, host_lib, points, T, team, reverse):
    B, plain = _stream(ctx, points, T)
    got = _host_reduce(ctx, host_lib, B, T, team, reverse)
    for part, want in zip(got, plain):
        for a, b in zip(part, want):
            assert torch.equal(a, b)


def test_bucket_plain_degenerate_lanes(ctx, points):
    """The stream reaches the cases the teams select or double: lane 2's
    run is B2 + ... after B0 + (-B0), lane 3 is infinity, lane 6's run is
    its last bucket and its wsum infinity, and lane 4's run is the sum of
    its finite buckets, checked on host ints."""
    T = 4
    B, (run, wsum) = _stream(ctx, points, T)
    g, F = ctx.g1, ctx.fp
    inf_run = g.is_inf((None, None, run[2].T))
    inf_wsum = g.is_inf((None, None, wsum[2].T))
    assert inf_run[3] and inf_wsum[3] and inf_wsum[6] and not inf_run[6]
    assert torch.equal(run[0][:, 6], lb.to_tensor(B[0][T - 1, :, 6]))

    def host_sum(lane, weights):
        acc = None
        for t, w in enumerate(weights):
            pt = g.to_affine(tuple(lb.to_tensor(b[t, :, lane])[None] for b in B))
            (x, y), inf = pt
            if not bool(inf[0]) and w:
                acc = rm.ec_add(acc, rm.ec_mul(w, (F.decode(x)[0], F.decode(y)[0]), 0, ctx.p),
                                0, ctx.p)
        return acc

    def affine(P, lane):
        (x, y), inf = g.to_affine(tuple(v[:, lane][None] for v in P))
        return None if bool(inf[0]) else (F.decode(x)[0], F.decode(y)[0])

    for lane in (1, 2, 4, 5):
        assert affine(run, lane) == host_sum(lane, [1] * T)
        assert affine(wsum, lane) == host_sum(lane, [T - 1 - t for t in range(T)])


def test_bucket_lanes_match_reference_adds(ctx, host_lib, points):
    T = 4
    B, _ = _stream(ctx, points, T)
    jctx = jax_get_curve("BLS12_381")
    g = jctx.g1
    Bj = [convert.to_reference(lb.to_tensor(b).permute(0, 2, 1)) for b in B]   # (T, C, 24)
    run = wsum = g.infinity((C,))
    for t in range(T):
        wsum = g.add(wsum, run)
        run = g.add(run, tuple(jnp.asarray(b[t]) for b in Bj))
    got_run, got_wsum = _host_reduce(ctx, host_lib, B, T, SM_TEAM)
    for exp, got in ((run, got_run), (wsum, got_wsum)):
        for e, v in zip(exp, got):
            assert np.array_equal(convert.to_reference(v.T), np.asarray(e))
