"""Port GLV decomposition (G1) against the JAX package's GLV, bit for bit.

The same scalars (made from a seed with numpy, plus the edge scalars 0, 1,
r - 1, lambda and r - lambda) go through the reference ``GLV.decompose``
(XLA on the CPU) and the port's; the mini-scalars must agree limb for limb
after the 16/32-bit repack, and with the host-int decomposition.
"""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu.ops import glv as jglv
from constantine_tpu.ops import msm as jmsm
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import glv, msm
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def glvs():
    return jglv.get_glv("BLS12_381"), glv.get_glv("BLS12_381")


def _scalars(ctx, g):
    rng = np.random.default_rng(7)
    ks = [int.from_bytes(rng.bytes(32), "big") % ctx.r for _ in range(32)]
    return ks + [0, 1, ctx.r - 1, g.lam, ctx.r - g.lam]


def test_constants_match_reference(glvs):
    jg, g = glvs
    for name in ("lam", "beta", "basis", "mini_bits", "LM", "w1", "w2", "s1", "s2"):
        assert getattr(g, name) == getattr(jg, name), name
    assert (g.mini_bits, g.LM, g.w2.bit_length()) == (130, 10, 257)
    for name in ("m_a1", "m_a2", "m_b1", "m_b2"):
        assert np.array_equal(getattr(g, name), np.asarray(getattr(jg, name))), name
    assert np.array_equal(g.w1_digits, np.asarray(jg.w1_limbs))
    assert np.array_equal(g.w2_digits, np.asarray(jg.w2_limbs))
    assert np.array_equal(convert.to_reference(g.beta_mont), np.asarray(jg.beta_mont))


def test_decompose_matches_reference_bit_for_bit(glvs):
    jg, g = glvs
    ctx = g.ctx
    ks = _scalars(ctx, g)
    port = ctx.scalars_to_limbs(ks)
    k1, n1, k2, n2 = g.decompose(port)
    ref = jg.decompose(jnp.asarray(lb.unpack16(lb.to_numpy(port))))
    assert k1.shape == k2.shape == (len(ks), 5) and k1.dtype == torch.int32
    for ours, r in ((k1, ref[0]), (k2, ref[2])):
        assert np.array_equal(convert.to_reference(ours), np.asarray(r))
    for ours, r in ((n1, ref[1]), (n2, ref[3])):
        assert np.array_equal(ours.numpy(), np.asarray(r))
    m1, m2 = lb.limbs_to_ints(k1), lb.limbs_to_ints(k2)
    for i, k in enumerate(ks):
        d1 = -m1[i] if bool(n1[i]) else m1[i]
        d2 = -m2[i] if bool(n2[i]) else m2[i]
        assert (d1, d2) == g._decompose_host(k)
        assert (d1 + d2 * g.lam - k) % ctx.r == 0
        assert max(abs(d1), abs(d2)) < 1 << g.mini_bits


def test_endo_and_split_match_reference_and_host(glvs):
    """phi(P) = [lambda]P, and the MSM's split (signed mini-scalars, points
    and their conditional negations) equals the reference's _apply_glv."""
    jg, g = glvs
    ctx = g.ctx
    jctx = jax_get_curve("BLS12_381")
    pts = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in (1, 2, 12345, 1 << 40)]
    px = ctx.fp.encode([q[0] for q in pts])
    py = ctx.fp.encode([q[1] for q in pts])
    ex, ey = g.endo((px, py))
    for i, q in enumerate(pts):
        assert (ctx.fp.decode(ex[i]), ctx.fp.decode(ey[i])) == rm.ec_mul(g.lam, q, 0, ctx.p)
    ks = _scalars(ctx, g)[-4:]
    port_k = ctx.scalars_to_limbs(ks)
    (sx, sy), sk, bits = msm._apply_glv(ctx.g1, g, (px, py), port_k)
    (rx, ry), rk, rbits = jmsm._apply_glv(
        jctx.g1, jg, (jnp.asarray(convert.to_reference(px)), jnp.asarray(convert.to_reference(py))),
        jnp.asarray(lb.unpack16(lb.to_numpy(port_k))))
    assert bits == rbits == 130
    for ours, r in ((sx, rx), (sy, ry), (sk, rk)):
        assert np.array_equal(convert.to_reference(ours), np.asarray(r))


def test_glv_for_group_picks_g1_and_raises_on_failure():
    assert msm._glv_for_group("BLS12_381.G1") is glv.get_glv("BLS12_381")
    assert msm._glv_for_group("BLS12_381.G2") is None
    with pytest.raises(ValueError, match="a = 0"):
        glv.GLV(types.SimpleNamespace(a=1, name="a1-curve"))
    with pytest.raises(KeyError):
        msm._glv_for_group("NO_SUCH_CURVE.G1")
