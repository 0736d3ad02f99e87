"""The port's hash-to-curve pieces against the JAX package and a host oracle.

expand_message_xmd against RFC 9380 K.1; hash_to_field (host-only) and the
GLS-4 digits and SqrtCtx roots (XLA on the CPU, small) against the JAX
package, exactly; hash_to_g1 and hash_to_g2 against the host big-int oracle
of ``bls_oracle`` (RFC 9380 over refmath, cofactors cleared by h_eff, not by
the Budroni-Pintore formula the port uses); the G2 ladder against refmath, the
GLS-4 route against the 255-bit ladder, and the G2 subgroup check. Inputs
come from seeds with numpy; everything runs the plain versions on the CPU.
"""

import numpy as np
import pytest
import torch

from constantine_tpu_torch import convert
from constantine_tpu_torch.models import hash_to_curve as h2c_mod
from constantine_tpu_torch.models.hash_to_curve import expand_message_xmd, get_h2c, hash_to_field
from constantine_tpu_torch.named import h2c_constants as HC
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.glv import get_gls4, scalar_mul_gls4_g2
from constantine_tpu_torch.ops.sqrt import get_sqrt_fp, get_sqrt_fp2
from constantine_tpu_torch.ops.subgroups import is_in_subgroup_g2
from constantine_tpu_torch.utils import refmath as rm
from bls_oracle import DST, NR, HostFp2, map_to_curve_host, oracle_hash_to_g1, oracle_hash_to_g2

torch.set_num_threads(1)


# -- helpers -----------------------------------------------------------------------


def _fp2_pairs(fp2, t):
    d = fp2.decode(t)
    return [(d[2 * i], d[2 * i + 1]) for i in range(len(d) // 2)]


def _g2_affine(ctx, P):
    (x, y), inf = ctx.g2.to_affine(P)
    xs, ys = _fp2_pairs(ctx.g2.F, x), _fp2_pairs(ctx.g2.F, y)
    return [None if bool(inf[i]) else (xs[i], ys[i]) for i in range(len(xs))]


def _g2_points(ctx, pts):
    fp2 = ctx.g2.F
    return (torch.stack([fp2.encode(list(q[0])) for q in pts]),
            torch.stack([fp2.encode(list(q[1])) for q in pts]))


def _msgs(seed, n, size=32):
    rng = np.random.default_rng(seed)
    return [rng.bytes(size) for _ in range(n)]


@pytest.fixture(scope="module")
def ctx():
    return get_curve("BLS12_381")


# -- expand_message_xmd, hash_to_field --------------------------------------------


def test_expand_message_xmd_rfc_vectors():
    """RFC 9380 K.1 (tests/test_hash_to_curve.py:35-44)."""
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    assert expand_message_xmd(b"", dst, 0x20).hex() == (
        "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235")
    assert expand_message_xmd(b"abc", dst, 0x20).hex() == (
        "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615")


@pytest.mark.parametrize("m", [1, 2])
def test_hash_to_field_matches_reference(ctx, m):
    from constantine_tpu.models.hash_to_curve import hash_to_field as jax_hash_to_field
    msgs = [b"", b"abc"] + _msgs(11, 2, 100)        # <= 4 messages: the JAX host route
    assert hash_to_field(msgs, DST, 2, m, ctx.p) == jax_hash_to_field(msgs, DST, 2, m, ctx.p)


# -- the towers' field additions without a host read -------------------------------


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_field_ct_ops_match_host(ctx, name):
    """Field.add_ct, sub_ct, neg_ct (limbs.ripple's carries) against python
    ints and the host-read add, sub, neg: every pair of edge values (long
    carry and borrow chains, 0, p - 1) and seeded pairs."""
    from constantine_tpu_torch.ops import limbs as lbm
    F = getattr(ctx, name)
    p, NL = F.p_int, F.NL
    edge = [0, 1, p - 1, p - 2, (1 << 32) - 1, 1 << 32, (1 << 64) - 1, (p + 1) // 2,
            p - (1 << 32), (1 << (32 * (NL - 1))) - 1, 1 << (32 * (NL - 1))]
    rng = np.random.default_rng(81 + NL)
    xs = [x for x in edge for _ in edge] + [int.from_bytes(rng.bytes(48), "big") % p
                                            for _ in range(64)]
    ys = [y for _ in edge for y in edge] + [int.from_bytes(rng.bytes(48), "big") % p
                                            for _ in range(64)]
    a, b = F.from_int(xs), F.from_int(ys)
    assert lbm.limbs_to_ints(F.add_ct(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert lbm.limbs_to_ints(F.sub_ct(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert lbm.limbs_to_ints(F.neg_ct(a)) == [-x % p for x in xs]
    for ct, pub in ((F.add_ct(a, b), F.add(a, b)), (F.sub_ct(a, b), F.sub(a, b)),
                    (F.neg_ct(a), F.neg(a))):
        assert torch.equal(ct, pub)


# -- square roots ---------------------------------------------------------------------


def _fp2_inputs(ctx, seed, n):
    """Seeded squares, seeded (mostly non-square) values, 0 and 1."""
    rng = np.random.default_rng(seed)
    p = ctx.p
    vals = [tuple(int.from_bytes(rng.bytes(48), "big") % p for _ in range(2)) for _ in range(n)]
    sq = [rm.fp2_mul(v, v, NR, p) for v in vals[: n // 2]]
    return sq + vals[n // 2:] + [(0, 0), (1, 0)]


def test_sqrt_fp2_same_root_as_reference(ctx):
    import jax.numpy as jnp
    from constantine_tpu.ops.sqrt import get_sqrt_fp2 as jax_sqrt_fp2
    vals = _fp2_inputs(ctx, 21, 6)
    fp2 = ctx.g2.F
    a = torch.stack([fp2.encode(list(v)) for v in vals])
    root, ok = get_sqrt_fp2("BLS12_381").sqrt(a)
    jroot, jok = jax_sqrt_fp2("BLS12_381").sqrt(jnp.asarray(convert.to_reference(a)))
    assert np.array_equal(convert.to_reference(root), np.asarray(jroot))
    assert ok.tolist() == np.asarray(jok).tolist()
    for v, r, o in zip(vals, _fp2_pairs(fp2, root), ok.tolist()):
        want = rm.fp2_sqrt(v, NR, ctx.p)
        assert o == (want is not None)
        if o:
            assert r in (want, rm.fp2_neg(want, ctx.p))


def test_sqrt_fp_same_root_as_reference(ctx):
    import jax.numpy as jnp
    from constantine_tpu.ops.sqrt import get_sqrt_fp as jax_sqrt_fp
    rng = np.random.default_rng(22)
    vals = [int.from_bytes(rng.bytes(48), "big") % ctx.p for _ in range(4)] + [0, 4]
    a = ctx.fp.encode(vals)
    root, ok = get_sqrt_fp("BLS12_381").sqrt(a)
    jroot, jok = jax_sqrt_fp("BLS12_381").sqrt(jnp.asarray(convert.to_reference(a)))
    assert np.array_equal(convert.to_reference(root), np.asarray(jroot))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist() == [rm.sqrt_mod(v, ctx.p) is not None for v in vals]


# -- GLS-4 ---------------------------------------------------------------------------


def test_gls4_decompose_matches_reference_bit_for_bit(ctx):
    import jax.numpy as jnp
    from constantine_tpu.ops.glv import get_gls4 as jax_gls4
    g, jg = get_gls4("BLS12_381"), jax_gls4("BLS12_381")
    assert (g.mini_bits, g.LM, g.lam) == (jg.mini_bits, jg.LM, jg.lam) == (67, 6, jg.lam)
    rng = np.random.default_rng(31)
    r = ctx.r
    ks = [0, 1, r - 1, g.lam, r - g.lam] + [int.from_bytes(rng.bytes(32), "big") % r
                                            for _ in range(11)]
    port = ctx.scalars_to_limbs(ks)
    parts = g.decompose(port)
    ref = jg.decompose(jnp.asarray(lb.unpack16(lb.to_numpy(port))))
    for (k, neg), (jk, jneg) in zip(parts, ref):
        assert k.shape == (len(ks), 3) and k.dtype == torch.int32
        assert np.array_equal(convert.to_reference(k), np.asarray(jk))
        assert neg.tolist() == np.asarray(jneg).tolist()
    for i, k in enumerate(ks):
        digits = [lb.limbs_to_ints(pk[i:i + 1])[0] * (-1 if bool(pn[i]) else 1)
                  for pk, pn in parts]
        assert digits == g._decompose_host(k)
        assert sum(d * pow(g.lam, j, r) for j, d in enumerate(digits)) % r == k


# -- hash to curve -------------------------------------------------------------------


def test_host_oracle_matches_rfc_vector():
    """RFC 9380 J.10.1 (BLS12381G2_XMD:SHA-256_SSWU_RO_), msg = "": the
    oracle the port is held to gives the RFC's point."""
    P = oracle_hash_to_g2(b"", b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_")
    assert P == ((int("0141ebfbdca40eb85b87142e130ab689c673cf60f1a3e98d69335266f30d9b8d4ac44c1038e"
                      "9dcdd5393faf5c41fb78a", 16),
                  int("05cb8437535e20ecffaef7752baddf98034139c38452458baeefab379ba13dff5bf5dd71b72"
                      "418717047f5b0f37da03d", 16)),
                 (int("0503921d7f6a12805e72940b963c0cf3471c7b2a524950ca195d11062ee75ec076daf2d4bc"
                      "358c4b190c0c98064fdd92", 16),
                  int("12424ac32561493f3fe3c260708a12b7c620e7be00099a974e259ddc7d1f6395c3c811cdd1"
                      "9f1e8dbf3e9ecfdcbab8d6", 16)))


def test_hash_to_g2_against_host_oracle(ctx):
    msgs = [b"", b"abc"] + _msgs(41, 1)
    got = _g2_affine(ctx, get_h2c().hash_to_g2(msgs, DST, "cpu"))
    for msg, P in zip(msgs, got):
        want = oracle_hash_to_g2(msg)
        assert P == want, msg
        assert rm.ec2_mul(ctx.r, want, (0, 0), NR, ctx.p) is None


def test_hash_to_g1_against_host_oracle(ctx):
    dst = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
    msgs = [b"", b"abc"]
    (x, y), inf = ctx.g1.to_affine(get_h2c().hash_to_g1(msgs, dst, "cpu"))
    got = list(zip(ctx.fp.decode(x), ctx.fp.decode(y)))
    for msg, P in zip(msgs, got):
        want = oracle_hash_to_g1(msg, dst)
        assert P == want, msg
        assert rm.ec_mul(ctx.r, want, 0, ctx.p) is None
    assert not inf.any()


def test_sswu_zero_lane_gives_the_exceptional_x(ctx):
    """u = 0: Z^2 u^4 + Z u^2 = 0, the inversion's zero case (x1 = B/(Z A))."""
    fp2 = ctx.g2.F
    u = torch.stack([fp2.encode([0, 0]), fp2.encode([5, 7])])
    x, y = get_h2c().g2_map.map_to_curve(u)
    maps = (HC.G2_ISO_XNUM, HC.G2_ISO_XDEN, HC.G2_ISO_YNUM, HC.G2_ISO_YDEN)
    got = list(zip(_fp2_pairs(fp2, x), _fp2_pairs(fp2, y)))
    for v, P in zip([(0, 0), (5, 7)], got):
        assert P == map_to_curve_host(HostFp2(ctx.p), v, HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z, maps)


def test_isogeny_check_rejects_a_wrong_map(ctx):
    bad = list(HC.G2_ISO_XNUM)
    bad[1] = (bad[1][0], (bad[1][1] + 1) % ctx.p)
    with pytest.raises(ValueError, match="isogeny"):
        h2c_mod.SSWUMap(ctx.g2.F, get_sqrt_fp2("BLS12_381"), h2c_mod._HostFp2(ctx.p, NR),
                        HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z, bad, HC.G2_ISO_XDEN,
                        HC.G2_ISO_YNUM, HC.G2_ISO_YDEN, ctx.g2_b())


# -- the G2 ladder, GLS-4 and the subgroup check ----------------------------------------


def _ladder_inputs(ctx, seed, n):
    p, r = ctx.p, ctx.r
    rng = np.random.default_rng(seed)
    pts = [rm.ec2_mul(int.from_bytes(rng.bytes(32), "big") % r, ctx.g2_aff, (0, 0), NR, p)
           for _ in range(n)]
    return pts, _g2_points(ctx, pts), rng


def test_g2_scalar_mul_and_gls4_against_refmath(ctx):
    """The ladder at 64 bits (0, 1, 2^64 - 1) and the GLS-4 route at full
    width (1, r - 1, a seeded scalar) against refmath."""
    p, r = ctx.p, ctx.r
    pts, xy, rng = _ladder_inputs(ctx, 51, 3)
    ks = [0, 1, (1 << 64) - 1]
    got = ctx.g2.scalar_mul(ctx.scalars_to_limbs(ks), ctx.g2.from_affine(xy), scalar_bits=64)
    assert _g2_affine(ctx, got) == [rm.ec2_mul(k, q, (0, 0), NR, p) for k, q in zip(ks, pts)]
    ks = [1, r - 1, int.from_bytes(rng.bytes(32), "big") % r]
    got = scalar_mul_gls4_g2(ctx, ctx.scalars_to_limbs(ks), xy)
    assert _g2_affine(ctx, got) == [rm.ec2_mul(k, q, (0, 0), NR, p) for k, q in zip(ks, pts)]


@pytest.mark.slow
def test_g2_scalar_mul_255_bits_and_gls4_route(ctx):
    """The 255-bit ladder against refmath, the GLS-4 route against it."""
    p, r = ctx.p, ctx.r
    pts, xy, rng = _ladder_inputs(ctx, 52, 3)
    ks = [r - 1, int.from_bytes(rng.bytes(32), "big") % r, r]
    k = ctx.scalars_to_limbs(ks)
    ladder = ctx.g2.scalar_mul(k, ctx.g2.from_affine(xy), scalar_bits=255)
    want = [rm.ec2_mul(kk % r, q, (0, 0), NR, p) for kk, q in zip(ks, pts)]
    assert _g2_affine(ctx, ladder) == want
    assert _g2_affine(ctx, scalar_mul_gls4_g2(ctx, k, xy)) == want


def test_g1_group_predicates(ctx):
    """ECGroup.eq, is_on_curve, select and cneg on G1 (plain versions)."""
    g1, fp = ctx.g1, ctx.fp
    pts = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in (1, 2, 3)]
    P = g1.from_affine((fp.encode([q[0] for q in pts]), fp.encode([q[1] for q in pts])))
    D = g1.double(P)                                   # Z != 1
    Q = g1.add(P, P)
    assert g1.eq(D, Q).tolist() == [True] * 3
    assert g1.eq(D, P).tolist() == [False] * 3
    assert g1.is_on_curve(D).tolist() == [True] * 3
    bad = (D[0], fp.add(D[1], fp.encode([1, 1, 1])), D[2])
    assert g1.is_on_curve(bad).tolist() == [False] * 3
    m = torch.tensor([True, False, True])
    assert g1.eq(g1.select(m, P, D), (P[0], P[1], P[2])).tolist() == [True, False, True]
    assert g1.eq(g1.cneg(m, P), g1.neg(P)).tolist() == [True, False, True]
    inf = g1.infinity((3,))
    assert g1.eq(inf, inf).tolist() == [True] * 3 and g1.eq(inf, P).tolist() == [False] * 3


def test_g2_ct_add_matches_public_add(ctx):
    """add(ct=True) against the public add on P + Q, P + P, P + (-P),
    inf + Q and P + inf."""
    p = ctx.p
    pts = [rm.ec2_mul(k, ctx.g2_aff, (0, 0), NR, p) for k in (3, 5, 7, 9, 11)]
    g2 = ctx.g2
    P = g2.from_affine(_g2_points(ctx, pts))
    Q = tuple(t.clone() for t in g2.from_affine(_g2_points(ctx, [pts[1], pts[1], pts[2],
                                                                 pts[3], pts[4]])))
    Q[1][2] = g2.F.neg(P[1][2])                 # lane 2: P + (-P)
    P = tuple(t.clone() for t in P)
    P[2][3] = 0                                 # lane 3: inf + Q
    Q[2][4] = 0                                 # lane 4: P + inf
    Q[0][2], Q[2][2] = P[0][2], P[2][2]
    ct, pub = _g2_affine(ctx, g2.add(P, Q, ct=True)), _g2_affine(ctx, g2.add(P, Q))
    assert ct == pub
    assert ct[1] == rm.ec2_mul(2, pts[1], (0, 0), NR, p) and ct[2] is None
    assert ct[3] == pts[3] and ct[4] == pts[4]
    assert g2.is_on_curve(g2.add(P, Q, ct=True)).all()


def test_is_in_subgroup_g2(ctx):
    """G2 multiples are in G2; SSWU outputs before clearing are not."""
    fp2 = ctx.g2.F
    inside = [rm.ec2_mul(k, ctx.g2_aff, (0, 0), NR, ctx.p) for k in (1, 2, 12345)]
    u = torch.stack([fp2.encode([3, 4]), fp2.encode([9, 1])])
    ox, oy = get_h2c().g2_map.map_to_curve(u)
    x, y = _g2_points(ctx, inside)
    Q = ctx.g2.from_affine((torch.cat([x, ox]), torch.cat([y, oy])))
    assert ctx.g2.is_on_curve(Q).all()
    assert is_in_subgroup_g2(ctx, Q).tolist() == [True] * 3 + [False] * 2
    outside = list(zip(_fp2_pairs(fp2, ox), _fp2_pairs(fp2, oy)))
    assert all(rm.ec2_mul(ctx.r, q, (0, 0), NR, ctx.p) is not None for q in outside)
