"""Port limbs and field arithmetic against the JAX package, limb for limb.

The same Montgomery values (made from a seed with numpy, encoded by the JAX
package) go through the reference ``Field`` (XLA on the CPU) and the port's
plain path; outputs must be equal after the 16/32-bit digit repack.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu.ops import limbs as jlb
from constantine_tpu.ops.msm_tpu import _pack16
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import mont_mul, mont_mul_plain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctxs():
    return jax_get_curve("BLS12_381"), get_curve("BLS12_381")


def _ints(p, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(n)]
    return vals + [0, 1, p - 1]


def _fields(ctxs, which):
    jctx, ctx = ctxs
    return (jctx.fp, ctx.fp) if which == "fp" else (jctx.fr, ctx.fr)


def test_limb_codecs_match_reference():
    rng = np.random.default_rng(0)
    xs = [int.from_bytes(rng.bytes(48), "big") >> 2 for _ in range(16)] + [0, 1]
    ours = lb.ints_to_limbs(xs, 12)
    ref = jlb.ints_to_limbs(xs, 24)
    assert np.array_equal(lb.pack16(ref), ours)
    assert np.array_equal(lb.unpack16(ours), ref)
    assert lb.limbs_to_ints(ours) == xs
    data = b"".join(x.to_bytes(48, "big") for x in xs)
    assert np.array_equal(lb.bytes_be_to_limbs(data, 48, 12),
                          lb.pack16(jlb.bytes_be_to_limbs(data, 48, 24)))
    assert lb.limbs_to_bytes_be(ours, 48) == jlb.limbs_to_bytes_be(ref, 48) == data
    t = lb.to_tensor(ours)
    assert t.dtype == torch.int32 and np.array_equal(lb.to_numpy(t), ours)
    assert np.array_equal(np.asarray(_pack16(jnp.asarray(ref))), ours)


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_field_constants_match_reference(ctxs, which):
    jF, F = _fields(ctxs, which)
    assert F.R_int == jF.R_int
    for name in ("p", "r2", "one"):
        assert np.array_equal(lb.pack16(getattr(jF, name)), getattr(F, name)), name
    assert F.p_int * F.m0ninv % (1 << 32) == (1 << 32) - 1
    assert F.m0ninv & 0xFFFF == int(jF.m0ninv)


_BINARY = ("add", "sub", "mul", "eq")
_UNARY = ("neg", "double", "square", "to_mont", "from_mont", "is_zero")


@pytest.mark.parametrize("which", ["fp", "fr"])
@pytest.mark.parametrize("op", _BINARY + _UNARY + ("cselect",))
def test_field_op_matches_reference(ctxs, which, op):
    jF, F = _fields(ctxs, which)
    xs = _ints(F.p_int, 9, seed=1)
    ys = _ints(F.p_int, 9, seed=2)[::-1]
    ys[3] = xs[3]                                   # one equal pair for eq
    ja, jb = jF.encode(xs), jF.encode(ys)
    a, b = convert.from_reference(ja), convert.from_reference(jb)
    if op in _BINARY:
        ref, got = getattr(jF, op)(jnp.asarray(ja), jnp.asarray(jb)), getattr(F, op)(a, b)
    elif op in _UNARY:
        ref, got = getattr(jF, op)(jnp.asarray(ja)), getattr(F, op)(a)
    else:
        cond = np.arange(len(xs)) % 3 == 0
        ref = jF.cselect(jnp.asarray(cond), jnp.asarray(ja), jnp.asarray(jb))
        got = F.cselect(torch.from_numpy(cond), a, b)
    ref = np.asarray(ref)
    if ref.dtype == bool:
        assert np.array_equal(got.numpy(), ref)
    else:
        assert np.array_equal(convert.to_reference(got), ref)


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_inv_and_batch_inv_match_reference(ctxs, which):
    jF, F = _fields(ctxs, which)
    xs = _ints(F.p_int, 3, seed=3)
    ja = jF.encode(xs)
    a = convert.from_reference(ja)
    got = F.batch_inv(a)                       # batch_inv_packed: one Fermat inversion
    assert np.array_equal(convert.to_reference(got), np.asarray(jF.batch_inv(jnp.asarray(ja))))
    p = F.p_int
    assert F.decode(got) == [pow(x, -1, p) if x else 0 for x in xs]
    assert F.decode(F.inv(a[[0, 5]])) == [pow(xs[0], -1, p), pow(xs[5], -1, p)]


def test_mont_mul_plain_broadcasts_and_keeps_shape(ctxs):
    _, ctx = ctxs
    F = ctx.fp
    a = F.encode(_ints(F.p_int, 5, seed=4)).reshape(2, 4, 12)
    b = F.encode([7])
    got = mont_mul(a, b, F)
    assert got.shape == (2, 4, 12)
    assert torch.equal(got, mont_mul_plain(a, b.expand(2, 4, 12), F))
    assert F.decode(got.reshape(-1, 12)) == [x * 7 % F.p_int
                                              for x in F.decode(a.reshape(-1, 12))]


def test_mont_mul_rejects_mixed_devices(ctxs):
    _, ctx = ctxs
    F = ctx.fp
    a = F.encode([3])
    with pytest.raises((ValueError, RuntimeError)):
        mont_mul(a, a.to("meta"), F)
