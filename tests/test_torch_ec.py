"""Port point arithmetic (K3-K6 plain versions, and the ec.cuh header built
on the host) against the JAX package's ECGroup and the host reference.

Jacobian inputs with Z != 1 come from JAX doublings; every case set holds
the degenerate lanes: P == Q (also with different Z), P == -Q, infinity on
either side, and padding keys in the scans.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import cuda_ec
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def env():
    jctx, ctx = jax_get_curve("BLS12_381"), get_curve("BLS12_381")
    rng = np.random.default_rng(7)
    ks = [int(k) for k in rng.integers(2, 1 << 40, size=8)]
    pts = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in ks]
    return jctx, ctx, pts


def _jaff(jctx, pts):
    """Affine python points -> JAX Montgomery (x, y) arrays."""
    return (jnp.asarray(jctx.fp.encode([q[0] for q in pts])),
            jnp.asarray(jctx.fp.encode([q[1] for q in pts])))


def _port(P):
    return tuple(convert.from_reference(np.asarray(v)) for v in P)


def _ref(P):
    return tuple(convert.to_reference(v) for v in P)


def _jac_cases(env):
    """Lane-aligned Jacobian (P, Q) pairs (JAX arrays) covering add's cases."""
    jctx, ctx, pts = env
    g = jctx.g1
    neg = [rm.ec_neg(q, ctx.p) for q in pts]
    A = g.double(g.from_affine(_jaff(jctx, pts)))               # Z != 1
    Aneg = g.double(g.from_affine(_jaff(jctx, neg)))
    (ax, ay), _ = g.to_affine(A)
    A1 = g.from_affine((ax, ay))                               # same points, Z = 1
    B = g.from_affine(_jaff(jctx, pts[::-1]))
    inf = g.infinity((8,))
    sel = np.arange(8)

    def lanes(*choices):
        # lane i takes its coordinates from choices[i % len(choices)]
        return tuple(jnp.stack([choices[i % len(choices)][c][i] for i in sel])
                     for c in range(3))

    P = lanes(A, A, A, inf, A, inf, A, B)
    Q = lanes(B, A, Aneg, B, inf, inf, A1, A)
    return P, Q


def test_curve_context_matches_reference(env):
    jctx, ctx, _ = env
    for ours, ref in zip(ctx.g1_gen, jctx.g1_gen):
        assert np.array_equal(convert.to_reference(ours), np.asarray(ref))
    assert np.array_equal(convert.to_reference(ctx.g1.b), np.asarray(jctx.g1.b))
    ks = [0, 1, ctx.r - 1, ctx.r, 3 * ctx.r + 5]
    assert np.array_equal(convert.to_reference(ctx.scalars_to_limbs(ks)),
                          np.asarray(jctx.scalars_to_limbs(ks)))


def test_add_matches_reference(env):
    jctx, ctx, _ = env
    P, Q = _jac_cases(env)
    ref = jctx.g1.add(P, Q)
    got = ctx.g1.add(_port(P), _port(Q))
    for r, v in zip(ref, got):
        assert np.array_equal(convert.to_reference(v), np.asarray(r))
    # degenerate lanes land where they should; infinity is the neutral element
    inf = ctx.g1.is_inf(got).numpy()
    assert inf[2] and inf[5] and not inf[[0, 1, 3, 4, 6, 7]].any()
    P = _port(P)
    assert all(torch.equal(a, b) for a, b in zip(ctx.g1.add(P, ctx.g1.infinity((8,))), P))


def test_double_and_double_k_match_reference(env):
    jctx, ctx, _ = env
    P, _ = _jac_cases(env)
    g = jctx.g1
    ref1 = g.double(P)
    ref3 = g.double(g.double(ref1))
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(_ref(ctx.g1.double(_port(P))), ref1))
    planar = tuple(v.T.contiguous() for v in _port(P))
    got3 = ctx.g1.pec.double_k(planar, 3)
    assert all(np.array_equal(convert.to_reference(a.T), np.asarray(b))
               for a, b in zip(got3, ref3))


def test_madd_matches_reference_and_host_math(env):
    jctx, ctx, pts = env
    g = jctx.g1
    neg = [rm.ec_neg(q, ctx.p) for q in pts]
    A = g.double(g.from_affine(_jaff(jctx, pts)))
    (ax, ay), _ = g.to_affine(A)
    bx, by = _jaff(jctx, pts[::-1])
    nx, ny = g.to_affine(g.double(g.from_affine(_jaff(jctx, neg))))[0]
    inf = g.infinity((8,))
    P = tuple(jnp.where(jnp.asarray(np.arange(8) == 3)[:, None], i, a)
              for i, a in zip(inf, A))
    lane = np.arange(8) % 4
    Qx = jnp.where(jnp.asarray(lane == 1)[:, None], ax,
                   jnp.where(jnp.asarray(lane == 2)[:, None], nx, bx))
    Qy = jnp.where(jnp.asarray(lane == 1)[:, None], ay,
                   jnp.where(jnp.asarray(lane == 2)[:, None], ny, by))
    ref = g.madd(P, (Qx, Qy))
    got = ctx.g1.madd(_port(P), _port((Qx, Qy)))
    for r, v in zip(ref, got):
        assert np.array_equal(convert.to_reference(v), np.asarray(r))
    (x, y), inf_m = ctx.g1.to_affine(got)
    xs, ys = ctx.fp.decode(x), ctx.fp.decode(y)
    for i in range(8):
        two_p = rm.ec_double(pts[i], 0, ctx.p)
        q = {0: pts[7 - i], 1: two_p, 2: rm.ec_neg(two_p, ctx.p), 3: pts[7 - i]}[lane[i]]
        exp = q if i == 3 else rm.ec_add(two_p, q, 0, ctx.p)
        assert (None if inf_m[i] else (xs[i], ys[i])) == exp, i


# -- the scans, against the same scans written with JAX ECGroup ops -----------


def _stream(env, K=8, M=8):
    """Keys (K, M) and affine entries with runs, P+P, P-P and padding."""
    jctx, ctx, pts = env
    neg = [rm.ec_neg(q, ctx.p) for q in pts]
    table = pts + neg                                    # index i+8 is -P_i
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(1, 6, size=(K, M)), axis=0).astype(np.int32)
    idx = rng.integers(0, 16, size=(K, M))
    keys[:, 0] = [1, 1, 1, 2, 2, 2, 3, 3]
    idx[:, 0] = [0, 0, 1, 2, 10, 3, 4, 4]               # P+P; P2, -P2 -> inf, +P3
    keys[:, 7] = 99                                      # padding key, entry 0
    idx[:, 7] = 0
    X = np.stack([jctx.fp.encode([table[i][0] for i in row]) for row in idx])
    Y = np.stack([jctx.fp.encode([table[i][1] for i in row]) for row in idx])
    return keys, X, Y                                    # (K, M), (K, M, 24)


def _planar_stream(X):
    """(K, M, 24) reference digits -> (K, 12, M) port limbs."""
    return convert.from_reference(X).permute(0, 2, 1).contiguous()


def test_flush_scan_plain_matches_reference_scan(env):
    jctx, ctx, _ = env
    keys, X, Y = _stream(env)
    K, M = keys.shape
    g = jctx.g1
    acc, cur, ref = g.infinity((M,)), np.full(M, -1), []
    for k in range(K):
        q = (jnp.asarray(X[k]), jnp.asarray(Y[k]))
        acc = g.select(jnp.asarray(keys[k] == cur), g.madd(acc, q), g.from_affine(q))
        ref.append(acc)
        cur = keys[k]
    xy = torch.cat([_planar_stream(X), _planar_stream(Y)], 1)
    got = ctx.g1.pec.flush_scan(torch.from_numpy(keys), xy)
    for c in range(3):
        exp = np.stack([np.asarray(r[c]) for r in ref])            # (K, M, 24)
        assert np.array_equal(convert.to_reference(got[c].permute(0, 2, 1)), exp), c
    assert ctx.g1.is_inf((None, None, got[2][4].T))[0]            # P2 + -P2


def test_merge_scan_plain_matches_reference_scan(env):
    jctx, ctx, _ = env
    keys, X, Y = _stream(env)
    keys[5:, 3] = 0                                       # neutral padding entries
    keys[:, 4] = -1
    K, M = keys.shape
    g = jctx.g1
    D = g.double(g.from_affine((jnp.asarray(X.reshape(-1, 24)),
                                jnp.asarray(Y.reshape(-1, 24)))))
    Xj, Yj, Z = (np.asarray(v).reshape(K, M, 24) for v in D)
    acc, cur, ref = g.infinity((M,)), np.full(M, -1), []
    for k in range(K):
        z = jnp.where(jnp.asarray(keys[k] <= 0)[:, None], 0, jnp.asarray(Z[k]))
        q = (jnp.asarray(Xj[k]), jnp.asarray(Yj[k]), z)
        acc = g.select(jnp.asarray(keys[k] == cur), g.add(acc, q), q)
        ref.append(acc)
        cur = keys[k]
    got = ctx.g1.pec.merge_scan(torch.from_numpy(keys), *map(_planar_stream, (Xj, Yj, Z)))
    for c in range(3):
        exp = np.stack([np.asarray(r[c]) for r in ref])
        assert np.array_equal(convert.to_reference(got[c].permute(0, 2, 1)), exp), c


def test_bucket_reduce_plain_matches_reference_and_weights(env):
    jctx, ctx, pts = env
    g = jctx.g1
    T, C = 4, 8
    B = g.double(g.from_affine(_jaff(jctx, (pts * 4)[: T * C])))
    B = tuple(np.array(v).reshape(T, C, 24) for v in B)
    B[2][1, 2] = 0                                        # an empty bucket (infinity)
    run = wsum = g.infinity((C,))
    for t in range(T):
        Bt = tuple(jnp.asarray(v[t]) for v in B)
        wsum = g.add(wsum, run)
        run = g.add(run, Bt)
    got_run, got_wsum = ctx.g1.pec.bucket_reduce(*map(_planar_stream, B), T)
    for exp, got in ((run, got_run), (wsum, got_wsum)):
        for e, v in zip(exp, got):
            assert np.array_equal(convert.to_reference(v.T), np.asarray(e))
    # lane 0: wsum = sum_t (T-1-t) * B_t
    (wx, wy), _ = ctx.g1.to_affine(tuple(v.T[:1] for v in got_wsum))
    terms = [rm.ec_mul(2 * (T - 1 - t), pts[(t * C) % 8], 0, ctx.p) for t in range(T)]
    acc = None
    for q in terms:
        acc = rm.ec_add(acc, q, 0, ctx.p)
    assert (ctx.fp.decode(wx)[0], ctx.fp.decode(wy)[0]) == acc


def test_kernel_wrappers_reject_bad_input(env):
    _, ctx, _ = env
    pec = ctx.g1.pec
    z = torch.zeros((12, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        pec.add((z, z, z), (z, z, z[:, :3]))
    with pytest.raises(ValueError):
        pec.flush_scan(torch.zeros((8, 4), dtype=torch.int32), torch.zeros((8, 12, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        pec.scaled_doubles((z[:, :2],) * 3, 12, 3)
    one_window = (z[:, :1],) * 3
    assert pec.scaled_doubles(one_window, 12, 1) is one_window
    F = ctx.fp
    with pytest.raises(ValueError):
        F.affine.fermat_inv(torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        F.affine.chain_bwd_inv(*(torch.zeros((2, 12, 4), dtype=torch.int32),) * 2,
                               torch.zeros((12, 3), dtype=torch.int32))


def test_scaled_doubles_plain_matches_reference_and_host(env):
    """K7 at W = 4, c = 3: lane w becomes [2^(3w)]P_w; lane 1 is infinity and
    lane 3 has Y = 0 (off the curve: its first doubling gives Z = 0)."""
    jctx, ctx, pts = env
    g = jctx.g1
    W, c = 4, 3
    A = g.double(g.from_affine(_jaff(jctx, pts[:W])))              # Z != 1
    A = tuple(np.array(v) for v in A)
    A[2][1] = 0
    A[1][3] = 0
    acc = tuple(jnp.asarray(v) for v in A)
    live_from = np.arange(W) * c
    for t in range((W - 1) * c):                                  # the TPU's masked ladder
        acc = g.select(jnp.asarray(t < live_from), g.double(acc), acc)
    got = ctx.g1.pec.scaled_doubles(tuple(convert.from_reference(v).T.contiguous() for v in A),
                                    c, W)
    for r, v in zip(acc, got):
        assert np.array_equal(convert.to_reference(v.T), np.asarray(r))
    (x, y), inf = ctx.g1.to_affine(tuple(v.T for v in got))
    assert inf.tolist() == [False, True, False, True]
    for w in (0, 2):
        exp = rm.ec_mul(2 << (c * w), pts[w], 0, ctx.p)             # [2^(3w)] (2 P_w)
        assert (ctx.fp.decode(x[w]), ctx.fp.decode(y[w])) == exp


# -- K8-K10: batched inversion ------------------------------------------------


def _field_elems(F, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "big") % (F.p_int - 1) + 1 for _ in range(n)]


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_batch_inversion_kernels_plain_match_reference_and_host(env, which):
    """chain_fwd, fermat_inv, chain_bwd_inv and batch_inv_packed at C = 4,
    block = 4, so 100 lanes take both levels of the recursion (100 -> 28
    chain products -> 8)."""
    jctx, ctx, _ = env
    F, jF = (ctx.fp, jctx.fp) if which == "fp" else (ctx.fr, jctx.fr)
    aff = F.affine
    xs = _field_elems(F, 100, seed=12)
    a = F.encode(xs)                                               # (100, NL)
    dC = a[:96].reshape(4, 24, F.NL).permute(0, 2, 1).contiguous()   # (C, NL, Mw)
    pe, bp = aff.chain_fwd(dC)
    for m in (0, 23):
        run = 1
        for cc in range(4):
            assert F.decode(pe[cc, :, m]) == run
            run = run * xs[24 * cc + m] % F.p_int
        assert F.decode(bp[:, m]) == run
    inv_bp = aff.fermat_inv(bp)
    assert F.decode(inv_bp.T) == [pow(v, -1, F.p_int) for v in F.decode(bp.T)]
    inv = aff.chain_bwd_inv(pe, dC, inv_bp)
    assert F.decode(inv.permute(0, 2, 1).reshape(96, F.NL)) == \
        [pow(x, -1, F.p_int) for x in xs[:96]]
    got = aff.batch_inv_packed(a.T.contiguous(), C=4, block=4).T
    ref = jF.batch_inv(jnp.asarray(convert.to_reference(a)))
    assert np.array_equal(convert.to_reference(got), np.asarray(ref))
    assert F.decode(got) == [pow(x, -1, F.p_int) for x in xs]


def test_field_batch_inv_zeros_at_chain_boundaries(env):
    """Zeros at the first and last lane of chains give zero, and the others
    their inverses, through Field.batch_inv's masking around
    batch_inv_packed: at C = 4, block = 4 (70 lanes chain down 4 in both
    recursion levels) and at the default geometry (one Fermat launch)."""
    _, ctx, _ = env
    F = ctx.fp
    xs = _field_elems(F, 70, seed=13)
    for i in (0, 31, 32, 63, 69):
        xs[i] = 0
    a = F.encode(xs)
    exp = [pow(x, -1, F.p_int) if x else 0 for x in xs]
    assert F.decode(F.batch_inv(a, C=4, block=4)) == exp
    assert F.decode(F.batch_inv(a)) == exp


# -- the CUDA header itself, built for the host --------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("ec_host") / "libec_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "ec_host.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(out))


def _call(lib, name, F, ins, n_out):
    ins = [np.ascontiguousarray(lb.to_numpy(t)) for t in ins]
    outs = [np.zeros_like(ins[0]) for _ in range(n_out)]
    mod = np.ascontiguousarray(F.mod_words)
    args = [mod.ctypes.data] + [a.ctypes.data for a in ins + outs] + [ins[0].shape[0]]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (len(args) - 1) + [ctypes.c_int]
    fn.restype = None
    fn(*args)
    return [lb.to_tensor(o) for o in outs]


def test_header_fp_mul_matches_plain(host_lib, env):
    _, ctx, _ = env
    F = ctx.fp
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(48), "big") % F.p_int for _ in range(30)] + [0, 1, F.p_int - 1]
    ys = xs[::-1]
    a, b = F.encode(xs), F.encode(ys)
    (got,) = _call(host_lib, "ctt_host_fp_mul", F, [a, b], 1)
    assert torch.equal(got, mont_mul_plain(a, b, F))


def test_header_point_ops_match_plain(host_lib, env):
    _, ctx, _ = env
    F = ctx.fp
    P, Q = (_port(v) for v in _jac_cases(env))
    mul = lambda a, b: mont_mul_plain(a, b, F)  # noqa: E731
    got = _call(host_lib, "ctt_host_ec_add", F, [*P, *Q], 3)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_ec.ec_add(F, mul, P, Q)))
    got = _call(host_lib, "ctt_host_ec_double", F, list(P), 3)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_ec.ec_double(F, mul, P)))
    # madd takes Q affine and finite: lanes 1 and 6 are P == Q, lane 2 P == -Q
    (qx, qy), _ = ctx.g1.to_affine(Q)
    keep = ~ctx.g1.is_inf(Q)
    qx, qy = qx[keep], qy[keep]
    Pm = tuple(v[keep] for v in P)
    got = _call(host_lib, "ctt_host_ec_madd", F, [*Pm, qx, qy], 3)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_ec.ec_madd(F, mul, Pm, (qx, qy))))
