"""The port's Fp2/Fp6/Fp12 towers and G2 group against the JAX package.

The same Montgomery coefficients (made from a numpy seed, encoded by the JAX
package) go through the reference towers (XLA on the CPU) and the port's
plain torch towers; outputs must be equal limb for limb after the 16/32-bit
digit repack. G2 is held against the host reference math in affine form.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.ops.pairing import get_pairing as jax_get_pairing
from constantine_tpu.ops.towers import build_tower as jax_build_tower
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import towers
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env():
    ctx = get_curve("BLS12_381")
    jfp2, jfp6, jfp12 = jax_build_tower("BLS12_381")
    rng = np.random.default_rng(44)
    vals = [int.from_bytes(rng.bytes(48), "big") % ctx.p for _ in range(4 * 12)]
    elems = np.stack([jfp12.encode(vals[12 * i:12 * i + 12]) for i in range(4)])
    elems[3] = 0                                        # the zero element
    return ctx, (jfp2, jfp6, jfp12), elems


def _port(a):
    return convert.from_reference(np.asarray(a))


def _same(port_out, jax_out):
    assert np.array_equal(convert.to_reference(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("level", [2, 6, 12])
def test_tower_mul_square_inv_match_reference(env, level):
    """mul at every level; square at Fp2 and Fp12 (quadratic levels); inv at
    Fp2 and Fp6 (Fp12's inverse is the quadratic inverse over Fp6 inv; its
    value is held through the final exponentiation's GT values)."""
    ctx, jt, elems = env
    jf = jt[{2: 0, 6: 1, 12: 2}[level]]
    pf = towers.build_tower(ctx)[{2: 0, 6: 1, 12: 2}[level]]
    a = elems[:, :level]
    b = a[[1, 2, 0, 3]]
    _same(pf.mul(_port(a), _port(b)), jf.mul(jnp.asarray(a), jnp.asarray(b)))
    if level != 6:
        _same(pf.square(_port(a)), jf.square(jnp.asarray(a)))
    if level != 12:
        _same(pf.inv(_port(a)), jf.inv(jnp.asarray(a)))      # 0 -> 0 in lane 3


def test_fp12_frobenius_conj_cyclotomic_match_reference(env):
    ctx, _, elems = env
    jpr = jax_get_pairing("BLS12_381")
    p12 = towers.build_tower(ctx)[2]
    a = jnp.asarray(elems)
    pa = _port(elems)
    for power in (1, 2):
        _same(p12.frobenius(pa, power), jpr.frobenius(a, power))
    _same(p12.conj12(pa), jpr.conj12(a))
    _same(p12.cyclotomic_square(pa), jpr.cyclotomic_square(a))
    one = p12.one((2,), "cpu")
    _same(one, jpr.fp12.broadcast_one((2,)))
    assert p12.eq(one, pa[:2]).tolist() == [False, False]
    assert p12.eq(pa, pa).all()


def test_plain_multiply_towers_match_kernel_multiply_towers(env):
    """The towers the kernels' plain versions use (mul=mont_mul_plain, Fp
    inversion by Fermat) give the default towers' values."""
    ctx, _, elems = env
    default = towers.build_tower(ctx)[2]
    plain = towers.build_tower(ctx, mul=lambda a, b: mont_mul_plain(a, b, ctx.fp))[2]
    a = _port(elems)
    b = a[[2, 0, 1, 3]]
    assert torch.equal(plain.mul(a, b), default.mul(a, b))
    assert torch.equal(plain.inv(a), default.inv(a))


def test_fp_div2_and_frobenius_constants(env):
    ctx, _, _ = env
    F = ctx.fp
    vals = [0, 1, 2, 3, ctx.p - 1, ctx.p - 2, (ctx.p + 1) // 2]
    half = towers.fp_div2(F, F.encode(vals))
    inv2 = pow(2, -1, ctx.p)
    assert F.decode(half) == [v * inv2 % ctx.p for v in vals]
    jpr = jax_get_pairing("BLS12_381")
    p12 = towers.build_tower(ctx)[2]
    for power, ref in ((1, jpr.gamma1), (2, jpr.gamma2)):
        assert np.array_equal(convert.to_reference(p12.gamma(power, "cpu")), np.asarray(ref))


def test_g2_group_matches_host_math():
    ctx = get_curve("BLS12_381")
    g2, F, p = ctx.g2, ctx.fp, ctx.p
    ks = [3, 5, 5, 7]
    pts = [rm.ec2_mul(k, ctx.g2_aff, (0, 0), -1, p) for k in ks]
    enc = tuple(F.encode([c for q in pts for c in q[i]]).reshape(4, 2, F.NL) for i in (0, 1))
    P = g2.double(g2.from_affine(enc))                            # Z != 1
    Q = g2.from_affine(tuple(t[[1, 2, 0, 3]] for t in enc),
                       inf_mask=torch.tensor([False, False, False, True]))
    Q = (Q[0], torch.cat([Q[1][:2], g2.F.neg(Q[1][2:3]), Q[1][3:]]), Q[2])
    (x, y), inf = g2.to_affine(g2.add(P, Q))
    want = [rm.ec2_add(rm.ec2_mul(2, pts[0], (0, 0), -1, p), pts[1], (0, 0), -1, p),
            rm.ec2_add(rm.ec2_mul(2, pts[1], (0, 0), -1, p), pts[2], (0, 0), -1, p),
            rm.ec2_add(rm.ec2_mul(2, pts[2], (0, 0), -1, p), rm.ec2_neg(pts[0], p),
                       (0, 0), -1, p),
            rm.ec2_mul(2, pts[3], (0, 0), -1, p)]
    xs, ys = F.decode(x.reshape(-1, F.NL)), F.decode(y.reshape(-1, F.NL))
    got = [None if inf[i] else ((xs[2 * i], xs[2 * i + 1]), (ys[2 * i], ys[2 * i + 1]))
           for i in range(4)]
    assert got == want
    R = g2.from_affine(enc)
    assert g2.is_inf(g2.add(R, g2.neg(R))).all()                 # P + (-P)
    (x2, _), _ = g2.to_affine(g2.add(R, R))                       # P + P doubles
    assert F.decode(x2[0]) == list(rm.ec2_mul(2, pts[0], (0, 0), -1, p)[0])
