"""The port's flat MSM route (G2 over the Fp2 tower) and msm_gls4_g2 on the
CPU, against the host sum sum_i k_i Q_i over refmath, with G2Group.madd and
the segmented sum's degenerate lanes, and against the JAX package's XLA MSM
(the JAX compile of a G2 MSM takes minutes on the CPU: `slow`)."""

import numpy as np
import pytest
import torch

from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import msm as msm_mod
from constantine_tpu_torch.ops.ec import ECGroup
from constantine_tpu_torch.ops.glv import msm_gls4_g2
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

NR = -1


@pytest.fixture(scope="module")
def ctx():
    return get_curve("BLS12_381")


def _g2_points(ctx, n, seed):
    rng = np.random.default_rng(seed)
    return [rm.ec2_mul(int.from_bytes(rng.bytes(32), "big") % (ctx.r - 1) + 1, ctx.g2_aff,
                       (0, 0), NR, ctx.p) for _ in range(n)]


def _encode(ctx, pts):
    F = ctx.fp
    return tuple(F.encode([c for q in pts for c in q[i]]).reshape(len(pts), 2, F.NL)
                 for i in (0, 1))


def _host_sum(ctx, ks, pts):
    acc = None
    for k, q in zip(ks, pts):
        acc = rm.ec2_add(acc, rm.ec2_mul(k, q, (0, 0), NR, ctx.p), (0, 0), NR, ctx.p)
    return acc


def _affine(ctx, R):
    """A batchless Jacobian G2 point -> host affine ((x0, x1), (y0, y1)) or None."""
    (x, y), inf = ctx.g2.to_affine(tuple(t[None] for t in R))
    if bool(inf[0]):
        return None
    fp2 = ctx.g2.F
    xs, ys = fp2.decode(x), fp2.decode(y)
    return (tuple(xs), tuple(ys))


def _limbs(ks, nl):
    from constantine_tpu_torch.ops import limbs as lb
    return lb.to_tensor(lb.ints_to_limbs(ks, nl))


# -- the flat route itself -------------------------------------------------------------


@pytest.mark.parametrize("c", [2, 3, None])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_flat_route_g2(ctx, n, c):
    """64-bit scalars (lane 0 zero) through msm's G2 route: the host sum."""
    pts = _g2_points(ctx, n, 100 + n)
    rng = np.random.default_rng(200 + n)
    ks = [0] + [int.from_bytes(rng.bytes(8), "big") for _ in range(n - 1)]
    R = msm_mod.msm(ctx.g2, _encode(ctx, pts), _limbs(ks, 2), c=c, scalar_bits=64)
    assert _affine(ctx, R) == _host_sum(ctx, ks, pts)


@pytest.mark.parametrize("c", [2, 3, None])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_msm_gls4_g2(ctx, n, c):
    """255-bit scalars through the GLS-4 split and the flat route: lane 0
    zero, lane 1 r - 1, and (n = 8) a repeated point and a point beside its
    negation, each pair with equal scalars."""
    pts = _g2_points(ctx, n, 300 + n)
    rng = np.random.default_rng(400 + n)
    ks = [int.from_bytes(rng.bytes(32), "big") % ctx.r for _ in range(n)]
    ks[0] = 0
    if n > 1:
        ks[1] = ctx.r - 1
    if n == 8:
        pts[3], ks[3] = pts[2], ks[2]
        pts[5], ks[5] = rm.ec2_neg(pts[4], ctx.p), ks[4]
    R = msm_gls4_g2(ctx, _encode(ctx, pts), ctx.scalars_to_limbs(ks), c=c)
    assert _affine(ctx, R) == _host_sum(ctx, ks, pts)


def test_flat_route_special_lanes(ctx):
    """256-bit scalars 0, r - 1, 2^255 - 1, 2^256 - 1, a repeated point with
    equal scalars, and Q beside -Q with equal scalars."""
    pts = _g2_points(ctx, 8, 7)
    pts[5] = pts[4]
    pts[7] = rm.ec2_neg(pts[6], ctx.p)
    ks = [0, ctx.r - 1, 2**255 - 1, 2**256 - 1, 12345, 12345, 2**200 + 1, 2**200 + 1]
    R = msm_mod.msm(ctx.g2, _encode(ctx, pts), _limbs(ks, 8))
    assert _affine(ctx, R) == _host_sum(ctx, ks, pts)


def test_flat_route_window_groups(ctx):
    """max_flat small enough for three groups of windows, one of them padded."""
    pts = _g2_points(ctx, 3, 9)
    rng = np.random.default_rng(10)
    ks = [int.from_bytes(rng.bytes(4), "big") for _ in range(3)]
    W = -(-32 // 3) + 1                                  # 12 windows of c = 3
    R = msm_mod.msm(ctx.g2, _encode(ctx, pts), _limbs(ks, 1), c=3, scalar_bits=32,
                    max_flat=3 * 5)                      # 5 windows a group: 5, 5, 2 + 3
    assert W == 12
    assert _affine(ctx, R) == _host_sum(ctx, ks, pts)


def test_flat_route_all_zero(ctx):
    pts = _g2_points(ctx, 2, 11)
    R = msm_mod.msm(ctx.g2, _encode(ctx, pts), _limbs([0, 0], 2))
    assert _affine(ctx, R) is None


def test_segmented_sum_doubles_and_cancels(ctx):
    """Keys [1, 1 | 2, 2 | 3, 3, 3 | 5]: a run of [Q, Q] (the add doubles),
    [R, -R] (infinity), [inf, S, S] and a lone T."""
    g2 = ctx.g2
    Q, R_, S, T = _g2_points(ctx, 4, 12)
    pts = [Q, Q, R_, rm.ec2_neg(R_, ctx.p), S, S, S, T]
    J = g2.from_affine(_encode(ctx, pts))
    J = tuple(v.clone() for v in J)
    J[2][4] = 0                                          # lane 4 at infinity
    keys = torch.tensor([1, 1, 2, 2, 3, 3, 3, 5])
    out = msm_mod._segmented_sum(g2, keys, J, 8)
    got = [_affine(ctx, tuple(v[i] for v in out)) for i in range(8)]
    dbl = rm.ec2_add(Q, Q, (0, 0), NR, ctx.p)
    assert got == [Q, dbl, R_, None, None, S, rm.ec2_add(S, S, (0, 0), NR, ctx.p), T]


def test_suffix_and_sum_all(ctx):
    pts = _g2_points(ctx, 5, 13)
    J = ctx.g2.from_affine(_encode(ctx, pts))
    suf = msm_mod._suffix_sum(ctx.g2, J, 5)
    for j in range(5):
        assert _affine(ctx, tuple(v[j] for v in suf)) == _host_sum(ctx, [1] * (5 - j), pts[j:])
    assert _affine(ctx, msm_mod._sum_all(ctx.g2, J, 5)) == _host_sum(ctx, [1] * 5, pts)


def test_best_window_size_is_the_references():
    from constantine_tpu.ops.msm import best_window_size as ref
    for n in (1, 2, 7, 8, 100, 512, 4096, 1 << 20, 1 << 30):
        for bits in (64, 255):
            assert msm_mod.best_window_size(n, bits) == ref(n, bits)


# -- madd and dispatch -----------------------------------------------------------------------


def test_g2_madd_degenerate_lanes(ctx):
    """Jacobian P + affine Q: a plain lane, P = Q (doubles), P = -Q
    (infinity), P = infinity (gives Q), against the host law."""
    g2 = ctx.g2
    A, B, C = _g2_points(ctx, 3, 14)
    Pj = g2.double(g2.from_affine(_encode(ctx, [A, B, C, A])))       # Z != 1
    twoA, twoB, twoC = (rm.ec2_add(v, v, (0, 0), NR, ctx.p) for v in (A, B, C))
    Qa = [B, twoB, rm.ec2_neg(twoC, ctx.p), C]
    Pj = tuple(v.clone() for v in Pj)
    Pj[2][3] = 0
    out = g2.madd(Pj, _encode(ctx, Qa))
    got = [_affine(ctx, tuple(v[i] for v in out)) for i in range(4)]
    assert got == [rm.ec2_add(twoA, B, (0, 0), NR, ctx.p),
                   rm.ec2_add(twoB, twoB, (0, 0), NR, ctx.p), None, C]


def test_g2_madd_matches_reference_limbs(ctx):
    """G2Group.madd and the JAX package's ECGroup.madd over Fp2 on the same
    Montgomery limbs, the degenerate lanes included: equal limb for limb."""
    import jax
    import jax.numpy as jnp
    from constantine_tpu.named.precompute import get_curve as jget
    from constantine_tpu_torch.ops import limbs as lb
    jctx = jget("BLS12_381")
    A, B, C = _g2_points(ctx, 3, 15)
    g2 = ctx.g2
    Pj = g2.double(g2.from_affine(_encode(ctx, [A, B, C, A])))
    Pj = tuple(v.clone() for v in Pj)
    Pj[2][3] = 0
    twoB = rm.ec2_add(B, B, (0, 0), NR, ctx.p)
    twoC = rm.ec2_add(C, C, (0, 0), NR, ctx.p)
    Q = _encode(ctx, [B, twoB, rm.ec2_neg(twoC, ctx.p), C])
    got = g2.madd(Pj, Q)

    def to_j(t):
        return jnp.asarray(lb.unpack16(lb.to_numpy(t)))

    want = jax.jit(jctx.g2.madd)(tuple(map(to_j, Pj)), tuple(map(to_j, Q)))
    for g, w in zip(got, want):
        assert np.array_equal(lb.to_numpy(g), lb.pack16(np.asarray(w)))


def test_dispatch(ctx, monkeypatch):
    """G1 runs the kernel pipeline (msm_gpu), G2 the flat route; an 8-limb
    G1 has no point kernels, so it cannot be built."""
    seen = []
    monkeypatch.setattr(msm_mod, "msm_gpu", lambda *a, **k: seen.append("gpu"))
    monkeypatch.setattr(msm_mod, "_msm_flat", lambda *a, **k: seen.append("flat"))
    gx, gy = ctx.g1_gen
    msm_mod.msm(ctx.g1, (gx, gy), ctx.scalars_to_limbs([5]))
    msm_mod.msm(ctx.g2, ctx.g2_gen, ctx.scalars_to_limbs([5]))
    assert seen == ["gpu", "flat"]
    with pytest.raises(ValueError, match="12-limb"):
        ECGroup(ctx.fr, 0, ctx.fr.encode(4))


@pytest.mark.slow
def test_flat_route_matches_reference_limbs(ctx):
    """N = 3 through the port's and the JAX package's XLA G2 MSM (c = 2,
    64-bit scalars): equal affine limbs."""
    import jax.numpy as jnp
    from constantine_tpu.named.precompute import get_curve as jget
    from constantine_tpu.ops.msm import msm as jmsm
    from constantine_tpu_torch.ops import limbs as lb
    jctx = jget("BLS12_381")
    pts = _g2_points(ctx, 3, 16)
    ks = [3, 2**64 - 1, 987654321]
    xy = _encode(ctx, pts)
    R = msm_mod.msm(ctx.g2, xy, _limbs(ks, 2), c=2, scalar_bits=64)
    (x, y), _ = ctx.g2.to_affine(tuple(t[None] for t in R))
    jxy = tuple(jnp.asarray(lb.unpack16(lb.to_numpy(t))) for t in xy)
    jk = jnp.asarray(lb.unpack16(lb.ints_to_limbs(ks, 2)))
    JR = jmsm(jctx.g2, jxy, jk, c=2, scalar_bits=64, use_pallas=False, glv=False)
    (jx, jy), _ = jctx.g2.to_affine(tuple(t[None] for t in JR))
    assert np.array_equal(lb.to_numpy(x), lb.pack16(np.asarray(jx)))
    assert np.array_equal(lb.to_numpy(y), lb.pack16(np.asarray(jy)))
