"""Port MSM stages, the online MSM and the precomputed fixed-base MSM
against the JAX package.

Stage functions (XLA-only in the reference, so cheap on the CPU) are held
bit for bit; the whole PrecomputedMSM, its batch, and the online msm (GLV
on and off; plain kernels) against the JAX package and the host reference,
with zero scalars, duplicate bases (the bucket doubling branch) and r - 1.
The JAX XLA MSM takes 15-45 s a call on the CPU, so the whole online and
batch MSMs meet it only in `slow` tests; the tier-1 run holds them against
the host sum (and the GLV split bit for bit, in test_torch_glv.py).
"""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu.ops import msm as jmsm
from constantine_tpu.ops import msm_tpu as jtpu
from constantine_tpu.ops.msm_precomp import PrecomputedMSM as JaxPrecomputedMSM
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import msm, msm_gpu
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.msm_precomp import PrecomputedMSM, best_precomp_window
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctxs():
    return jax_get_curve("BLS12_381"), get_curve("BLS12_381")


def _scalars(r, n, seed, bits=None):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "big") % r for _ in range(n)]
    if bits is not None:
        ks = [k % (1 << bits) for k in ks]
    return ks


def _both_scalars(ctx, ks):
    """Same scalars as reference 16-bit digits and port 32-bit limbs."""
    port = ctx.scalars_to_limbs(ks)
    return jnp.asarray(lb.unpack16(lb.to_numpy(port))), port


@pytest.mark.parametrize("c", [6, 12, 16])
def test_signed_digits_match_reference(ctxs, c):
    _, ctx = ctxs
    ks = _scalars(ctx.r, 20, seed=c) + [0, 1, ctx.r - 1, (1 << 255) - 1 - ctx.r]
    jk, k = _both_scalars(ctx, ks)
    W = -(-255 // c) + 1
    ref = np.asarray(jmsm._signed_digits(jk, c, W))
    got = msm._signed_digits(k, c, W)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def _digits(ctx, n, c, seed):
    ks = _scalars(ctx.r, n, seed)
    W = -(-255 // c) + 1
    return msm._signed_digits(ctx.scalars_to_limbs(ks), c, W)


@pytest.mark.parametrize("packed", [True, False])
def test_sorted_stream_matches_reference(ctxs, packed):
    _, ctx = ctxs
    c = 12 if packed else 16        # c + 1 + index bits > 31 takes the flat sort
    dig = _digits(ctx, 40, c, seed=1).reshape(1, -1)
    if not packed:
        dig = dig.repeat(1, 1 << 10)[:, : 1 << 15]
    W, N = dig.shape
    H = 1 << (c - 1)
    sk, gi = msm_gpu._sorted_stream(dig, c, W, H, N)
    rsk, rgi = jtpu._sorted_stream(jnp.asarray(dig.numpy()), c, W, H, N)
    assert np.array_equal(sk.numpy(), np.asarray(rsk))
    assert np.array_equal(gi.numpy(), np.asarray(rgi))


def test_searchsorted_matches_manual_binary_search():
    rng = np.random.default_rng(3)
    sk = np.sort(rng.integers(0, 300, size=1000)).astype(np.int32)
    want = np.arange(1, 320, dtype=np.int32)
    lo, hi = np.zeros_like(want), np.full_like(want, sk.size)
    for _ in range(max(1, (sk.size - 1).bit_length())):   # msm_tpu.py:199-207
        mid = (lo + hi) >> 1
        v = sk[np.minimum(mid, sk.size - 1)]
        right = (v <= want) & (mid < sk.size)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(right, hi, mid)
    got = torch.searchsorted(torch.from_numpy(sk), torch.from_numpy(want), right=True)
    assert np.array_equal(got.numpy(), lo)


def _flush_geometry(ctx, n, c, seed):
    """A real sorted stream laid out as the flush scan sees it, plus random
    coordinate planes standing in for the scan's emissions."""
    dig = _digits(ctx, n, c, seed).reshape(1, -1)
    W, N = dig.shape
    H = 1 << (c - 1)
    nb = W * (H + 1)
    sk, _ = msm_gpu._sorted_stream(dig, c, W, H, N)
    K0 = max(8, -(-N // 64))
    M = -(-(-(-N // K0)) // 512) * 512
    K = -(-(-(-N // M)) // 8) * 8
    sk = torch.cat([sk, torch.full((M * K - N,), nb + 1, dtype=sk.dtype)])
    skT = sk.reshape(M, K).T.contiguous()
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 1 << 16, size=(K, 24, M), dtype=np.uint32) for _ in range(3)]
    return dict(sk=sk, skT=skT, K=K, M=M, nb=nb, H=H, planes=planes,
                ours=[convert.from_reference(p.transpose(0, 2, 1)).permute(0, 2, 1).contiguous()
                      for p in planes])


def _port_planes(t):
    """(K, 12, M) port limbs -> (K, 24, M) reference digits."""
    return convert.to_reference(t.permute(0, 2, 1)).transpose(0, 2, 1)


def test_compact_boundaries_matches_reference(ctxs):
    _, ctx = ctxs
    g = _flush_geometry(ctx, 64, 12, seed=4)
    args = (g["K"], g["M"], g["nb"], g["H"], 32)
    ref = jtpu._compact_boundaries(types.SimpleNamespace(L=24), jnp.asarray(g["sk"].numpy()),
                                   jnp.asarray(g["skT"].numpy()),
                                   [jnp.asarray(p) for p in g["planes"]], *args)
    got = msm_gpu._compact_boundaries(ctx.g1.pec, g["sk"], g["skT"], g["ours"], *args)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(got[1:4], ref[1:4]):
        assert np.array_equal(_port_planes(a), np.asarray(b))
    assert got[4] == ref[4]


@pytest.mark.parametrize("shape2", [None, (32, 128)])
def test_compact_mask_gather_matches_reference(ctxs, shape2):
    _, ctx = ctxs
    g = _flush_geometry(ctx, 64, 12, seed=5)
    S = None if shape2 else g["M"] + g["nb"]
    ref_k, ref_c = jtpu._compact_mask_gather(jnp.asarray(g["skT"].numpy()),
                                             [jnp.asarray(p) for p in g["planes"]],
                                             S, g["nb"], g["H"], shape2=shape2)
    k, cs = msm_gpu._compact_mask_gather(g["skT"], g["ours"], S, g["nb"], g["H"], shape2=shape2)
    assert np.array_equal(k.numpy(), np.asarray(ref_k))
    for a, b in zip(cs, ref_c):
        if shape2:
            assert np.array_equal(_port_planes(a), np.asarray(b))
        else:
            assert np.array_equal(convert.to_reference(a.T).T, np.asarray(b))


def test_best_window_choices_match_reference():
    for n in (64, 4096, 1 << 16):
        assert msm_gpu.best_window_tpu(n) == jtpu.best_window_tpu(n)
        assert msm_gpu.best_window_tpu(2 * n, 130) == jtpu.best_window_tpu(2 * n, 130)
    assert best_precomp_window(4096) == 12
    # the online commit (GLV of 4096 points) and the 2^16 online MSM
    assert msm_gpu.best_window_tpu(8192, 130) == 9
    assert msm_gpu.best_window_tpu(1 << 17, 130) == 12


def _points(ctx, n, seed):
    rng = np.random.default_rng(seed)
    return [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in rng.integers(2, 1 << 30, size=n)]


def _host_msm(ctx, ks, pts):
    acc = None
    for k, q in zip(ks, pts):
        acc = rm.ec_add(acc, rm.ec_mul(k, q, 0, ctx.p), 0, ctx.p)
    return acc


def _affine(ctx, P):
    (x, y), inf = ctx.g1.to_affine(tuple(v[None] for v in P))
    return None if bool(inf[0]) else (ctx.fp.decode(x)[0], ctx.fp.decode(y)[0])


def test_precomputed_msm_matches_reference_package(ctxs):
    """Zero scalars and duplicate bases; a small window and short scalars
    keep the JAX XLA pipeline cheap."""
    jctx, ctx = ctxs
    n, c, bits = 16, 6, 24
    pts = _points(ctx, n, seed=6)
    pts[6] = pts[5]                                      # duplicate base
    ks = _scalars(ctx.r, n, seed=7, bits=bits)
    ks[0] = 0
    ks[6] = ks[5]                                        # -> doubling in a bucket
    ks[2] = (1 << bits) - 1
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    pm = PrecomputedMSM(ctx.g1, (px, py), c=c, scalar_bits=bits)
    jpm = JaxPrecomputedMSM(jctx.g1, (jnp.asarray(convert.to_reference(px)),
                                      jnp.asarray(convert.to_reference(py))),
                            c=c, scalar_bits=bits)
    for ours, ref in zip(pm._tables, jpm._tables):
        assert np.array_equal(convert.to_reference(ours), np.asarray(ref))
    jk, k = _both_scalars(ctx, ks)
    got = _affine(ctx, pm(k))
    (rx, ry), rinf = jctx.g1.to_affine(tuple(v[None] for v in jpm(jk, use_pallas=False)))
    assert not bool(rinf[0])
    assert got == (jctx.fp.decode(rx)[0], jctx.fp.decode(ry)[0]) == _host_msm(ctx, ks, pts)


def test_precomputed_msm_commit_geometry_matches_host(ctxs):
    """The commit's configuration (c = 12, 255-bit scalars, W = 23) with
    enough entries (W*N = 920) for all it runs: packed sort, two merge scans
    (r > 4), bucket_reduce at T = 4, C = 512; scalars 0, r - 1 and equal
    scalars on duplicate bases."""
    _, ctx = ctxs
    n = 40
    pts = _points(ctx, n, seed=8)
    pts[9] = pts[8]
    ks = _scalars(ctx.r, n, seed=9)
    ks[0] = ks[1] = 0
    ks[9] = ks[8]
    ks[3] = ctx.r - 1
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    pm = PrecomputedMSM(ctx.g1, (px, py), scalar_bits=255, c=12)
    assert pm.W == 23
    assert _affine(ctx, pm(ctx.scalars_to_limbs(ks))) == _host_msm(ctx, ks, pts)


def _online_case(ctx):
    """32 points and scalars with zeros, r - 1, and equal scalars on a
    duplicate base."""
    n = 32
    pts = _points(ctx, n, seed=10)
    pts[5] = pts[4]
    ks = _scalars(ctx.r, n, seed=11)
    ks[0] = ks[7] = 0
    ks[5] = ks[4]
    ks[9] = ctx.r - 1
    return pts, ks


def _online_msm(ctx, pts, ks, **kw):
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    return (px, py), _affine(ctx, msm.msm(ctx.g1, (px, py), ctx.scalars_to_limbs(ks), **kw))


def test_online_msm_matches_host(ctxs):
    """The scalars path with the GLV split and c = None: 64 mini-scalar
    points of 130 bits, best_window_tpu's c = 8, W = 17 windows, so the
    window combine (K7 plain) runs with W > 1. (The split itself is held
    bit for bit against the JAX package in test_torch_glv.py.)"""
    _, ctx = ctxs
    pts, ks = _online_case(ctx)
    assert msm_gpu.best_window_tpu(64, 130) == 8
    _, got = _online_msm(ctx, pts, ks)
    assert got == _host_msm(ctx, ks, pts)


@pytest.mark.slow
def test_online_msm_matches_reference_package(ctxs):
    """Against the JAX msm (XLA path, GLV on, c = 6): 20-30 s on the CPU."""
    jctx, ctx = ctxs
    pts, ks = _online_case(ctx)
    (px, py), got = _online_msm(ctx, pts, ks)
    jk, _ = _both_scalars(ctx, ks)
    ref = jmsm.msm(jctx.g1, (jnp.asarray(convert.to_reference(px)),
                             jnp.asarray(convert.to_reference(py))), jk, c=6, use_pallas=False)
    (rx, ry), rinf = jctx.g1.to_affine(tuple(v[None] for v in ref))
    assert not bool(rinf[0])
    assert got == (jctx.fp.decode(rx)[0], jctx.fp.decode(ry)[0])


def test_online_msm_without_glv_matches_host(ctxs):
    """glv=False: 255-bit scalars in 256 bits of limbs, c = 8, W = 33."""
    _, ctx = ctxs
    pts, ks = _online_case(ctx)
    assert _online_msm(ctx, pts, ks, glv=False)[1] == _host_msm(ctx, ks, pts)


def test_msm_gpu_without_combine_returns_row_sums(ctxs):
    """combine=False: each digit row is its own MSM over the shared points
    (row 1 all zero -> infinity), standard layout (rows, NL)."""
    _, ctx = ctxs
    n, c = 16, 5
    pts = _points(ctx, n, seed=12)
    rng = np.random.default_rng(13)
    digits = rng.integers(-(1 << (c - 1)), (1 << (c - 1)) + 1, size=(3, n))
    digits[1] = 0
    digits[2, :4] = 1 << (c - 1)
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    X, Y, Z = msm_gpu.msm_gpu(ctx.g1, (px, py), None, c=c,
                              digits=torch.from_numpy(digits.astype(np.int32)), combine=False)
    assert X.shape == Y.shape == Z.shape == (3, 12)
    for b in range(3):
        exp = _host_msm(ctx, [int(d) % ctx.r for d in digits[b]], pts)
        assert _affine(ctx, (X[b], Y[b], Z[b])) == exp


def _batch_case(ctx):
    n, c, bits = 16, 6, 24
    pts = _points(ctx, n, seed=14)
    pts[3] = pts[2]
    ks = [_scalars(ctx.r, n, seed=15 + b, bits=bits) for b in range(3)]
    ks[1] = [0] * n                                      # the zero blob's row
    ks[2][3] = ks[2][2]
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    return pts, ks, (px, py), c, bits


def test_precomputed_msm_batch_matches_rows_and_host(ctxs):
    _, ctx = ctxs
    pts, ks, aff, c, bits = _batch_case(ctx)
    pm = PrecomputedMSM(ctx.g1, aff, c=c, scalar_bits=bits)
    k = torch.stack([ctx.scalars_to_limbs(kb) for kb in ks])     # (3, 16, 8)
    X, Y, Z = pm.batch(k)
    assert X.shape == (3, 12)
    assert bool(ctx.g1.is_inf((X, Y, Z))[1])
    for b in range(3):
        got = _affine(ctx, (X[b], Y[b], Z[b]))
        assert got == _affine(ctx, pm(k[b])) == _host_msm(ctx, ks[b], pts)


@pytest.mark.slow
def test_precomputed_msm_batch_matches_reference_package(ctxs):
    """Against the JAX PrecomputedMSM.batch (its per-row CPU route)."""
    jctx, ctx = ctxs
    pts, ks, (px, py), c, bits = _batch_case(ctx)
    pm = PrecomputedMSM(ctx.g1, (px, py), c=c, scalar_bits=bits)
    jpm = JaxPrecomputedMSM(jctx.g1, (jnp.asarray(convert.to_reference(px)),
                                      jnp.asarray(convert.to_reference(py))),
                            c=c, scalar_bits=bits)
    k = torch.stack([ctx.scalars_to_limbs(kb) for kb in ks])
    got = pm.batch(k)
    (rx, ry), rinf = jctx.g1.to_affine(jpm.batch(jnp.asarray(lb.unpack16(lb.to_numpy(k)))))
    for b in range(3):
        exp = None if bool(rinf[b]) else (jctx.fp.decode(rx[b]), jctx.fp.decode(ry[b]))
        assert _affine(ctx, tuple(v[b] for v in got)) == exp


@pytest.mark.slow
def test_online_msm_without_glv_matches_reference_package(ctxs):
    jctx, ctx = ctxs
    pts, ks = _online_case(ctx)
    (px, py), got = _online_msm(ctx, pts, ks, glv=False)
    jk, _ = _both_scalars(ctx, ks)
    ref = jmsm.msm(jctx.g1, (jnp.asarray(convert.to_reference(px)),
                             jnp.asarray(convert.to_reference(py))), jk, c=6,
                   use_pallas=False, glv=False)
    (rx, ry), _ = jctx.g1.to_affine(tuple(v[None] for v in ref))
    assert got == (jctx.fp.decode(rx)[0], jctx.fp.decode(ry)[0])
