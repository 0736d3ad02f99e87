"""K5 merge_scan as the card runs it: ``csrc/ec.cuh``'s ``merge_runs``,
built with g++ through ``csrc/ec_host.cpp``, against the plain version and
the JAX package's scan.

A team owns the runs of equal keys that start in a chunk of Lc slots of a
lane and carries each to its end; where a product cannot change the result
(a restart, a key <= 0, an entry or an accumulator at infinity) it selects
instead. ``ctt_host_merge_scan_runs`` plays every team of a launch, a team
of one after the other, in the kernel's order and reversed, into outputs
filled with a sentinel: every slot must be written, and equal
``_merge_scan_plain``'s, at the kernel's chunk ``MS_CHUNK`` (read from
``ec_kernels.cu``) and at Lc = 1, 4 and K. The lanes hold what the paths'
merge streams and ``chip_smoke.py``'s degenerate lanes hold: [P, P] and
[P, -P] under one key, [inf, P], a key 0 run over a whole lane, a key -1
run from slot 0 (the scan's starting key), entries at infinity inside a
run, singletons, and runs that cross chunk borders. One stream is also
held against the JAX package's scan (select(same, add, Q')).
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
K = 32
SENTINEL = 0xDEADBEEF
MS_CHUNK = int(re.search(r"constexpr int MS_CHUNK = (\d+);",
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
    lib.ctt_host_merge_scan_runs.argtypes = [P_] * 8 + [I_] * 4
    lib.ctt_host_merge_scan_runs.restype = None
    return lib


def _runs(lengths, first=1):
    return np.repeat(np.arange(first, first + len(lengths)), lengths)


def _lanes(rng):
    """(keys, entry index) per lane; entry i < 16 is point i, 16 + i its
    negative, 32 infinity (Z = 0)."""
    lanes = []
    keys = _runs([2, 3, 6, 1, 5, 4, 2, 6, 3])                         # [P, P] first
    idx = rng.integers(0, 16, K)
    idx[1] = idx[0]
    lanes.append((keys, idx))
    idx = rng.integers(0, 16, K)                                     # [P, -P, Q]
    idx[1] = idx[0] + 16
    lanes.append((keys[::-1].copy(), idx))
    idx = rng.integers(0, 16, K)
    idx[0] = 32                                                      # [inf, P]
    lanes.append((_runs([4, 6, 6, 6, 6, 4], 20), idx))
    lanes.append((np.zeros(K, int), rng.integers(0, 16, K)))         # key 0 lane
    lanes.append((np.full(K, -1), rng.integers(0, 16, K)))           # key -1 from slot 0
    lanes.append((np.concatenate([[-1, -1, 0, 0, 0], _runs([3, 5, 6, 6, 4, 3], 40)]),
                  rng.integers(0, 33, K)))                           # padding, then runs
    idx = rng.integers(0, 16, K)
    idx[3:12:2] = 32                                                 # infinity inside runs
    lanes.append((_runs([2, 6, 5, 3, 6, 6, 4]), idx))
    lanes.append((np.arange(1, K + 1), rng.integers(0, 33, K)))      # singletons
    cuts = np.sort(rng.choice(np.arange(1, K), size=6, replace=False))
    lanes.append((_runs(np.diff(np.concatenate([[0], cuts, [K]])), 60),
                  rng.integers(0, 33, K)))
    for keys, _ in lanes:
        assert keys.shape == (K,)
    return lanes


@pytest.fixture(scope="module")
def stream(ctx):
    """keys (K, M) int32; qx, qy, qz (K, NL, M) u32 Jacobian entries with
    Z != 1; the plain scan."""
    rng = np.random.default_rng(5)
    ps = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 40, size=16)]
    ps += [rm.ec_neg(q, ctx.p) for q in ps]
    g = ctx.g1
    J = g.double(g.from_affine((ctx.fp.encode([q[0] for q in ps]),
                                ctx.fp.encode([q[1] for q in ps]))))
    J = tuple(torch.cat([v, v[:1]]) for v in J)
    J[2][32] = 0
    lanes = _lanes(rng)
    keys = np.ascontiguousarray(np.stack([k for k, _ in lanes], 1).astype(np.int32))
    idx = np.stack([i for _, i in lanes], 1)                        # (K, M)
    q = tuple(np.ascontiguousarray(lb.to_numpy(v)[idx].transpose(0, 2, 1)) for v in J)
    plain = ctx.g1.pec._merge_scan_plain(torch.from_numpy(keys), *map(lb.to_tensor, q))
    return keys, q, plain


def _host_merge(ctx, lib, keys, q, Lc, reverse=False):
    M = keys.shape[1]
    outs = [np.full((K, NL, M), SENTINEL, np.uint32) for _ in range(3)]
    mod = np.ascontiguousarray(ctx.fp.mod_words)
    lib.ctt_host_merge_scan_runs(mod.ctypes.data, keys.ctypes.data,
                                 *(a.ctypes.data for a in q), *(o.ctypes.data for o in outs),
                                 K, M, Lc, int(reverse))
    for o in outs:
        assert not (o == SENTINEL).all(1).any(), "a slot was never written"
    return tuple(lb.to_tensor(o) for o in outs)


@pytest.mark.parametrize("Lc", sorted({1, 4, MS_CHUNK, K}))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_merge_runs_match_plain(ctx, host_lib, stream, Lc, reverse):
    keys, q, plain = stream
    got = _host_merge(ctx, host_lib, keys, q, Lc, reverse)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_merge_plain_degenerate_lanes(ctx, stream):
    """The stream reaches the cases the team skips or selects: P + P doubles,
    P + (-P) is infinity and the next entry restarts from it, inf + P is P,
    a key 0 lane repeats its first entry with Z = 0, a key -1 lane from slot
    0 is infinity."""
    g, (keys, q, plain) = ctx.g1, stream
    X, Y, Z = plain
    inf = g.is_inf((None, None, Z[:, :, 1]))
    assert inf[1] and not inf[2] and not g.is_inf((None, None, Z[:2, :, 0])).any()
    assert torch.equal(X[2, :, 1], lb.to_tensor(q[0][2, :, 1]))     # inf + Q = Q
    assert torch.equal(X[1, :, 2], lb.to_tensor(q[0][1, :, 2]))     # [inf, P] = P
    for c, v in enumerate(plain):                                    # the key 0 lane
        first = lb.to_tensor(q[c][0, :, 3]) if c < 2 else torch.zeros(NL, dtype=torch.int32)
        assert all(torch.equal(v[k, :, 3], first) for k in range(K))
    assert g.is_inf((None, None, Z[:, :, 4])).all()
    one = ctx.fp.broadcast_one((K,), "cpu")
    assert torch.equal(X[:, :, 4], one) and torch.equal(Y[:, :, 4], one)


def test_merge_runs_match_reference_scan(ctx, host_lib, stream):
    keys, q, _ = stream
    jctx = jax_get_curve("BLS12_381")
    g = jctx.g1
    M = keys.shape[1]
    Q = [convert.to_reference(lb.to_tensor(v).permute(0, 2, 1)) for v in q]   # (K, M, 24)
    acc, cur, ref = g.infinity((M,)), np.full(M, -1), []
    for k in range(K):
        z = jnp.where(jnp.asarray(keys[k] <= 0)[:, None], 0, jnp.asarray(Q[2][k]))
        qk = (jnp.asarray(Q[0][k]), jnp.asarray(Q[1][k]), z)
        acc = g.select(jnp.asarray(keys[k] == cur), g.add(acc, qk), qk)
        ref.append(acc)
        cur = keys[k]
    got = _host_merge(ctx, host_lib, keys, q, MS_CHUNK)
    for c in range(3):
        exp = np.stack([np.asarray(r[c]) for r in ref])
        assert np.array_equal(convert.to_reference(got[c].permute(0, 2, 1)), exp), c
