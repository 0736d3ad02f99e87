"""The port's NTT (K3′ plain versions, and ntt.cuh built on the host), G1
scalar multiplication and EC-FFT against the JAX package, limb for limb.

The JAX side runs on the CPU backend, where every transform takes its XLA
radix-2 route; the port's 2-D inputs of n >= 1024 take the four-step route,
so those comparisons hold the four-step against the radix-2. Points are
compared in affine form: Jacobian coordinates depend on the formulas' path.
The JAX EC-FFT takes 20-45 s to compile a transform on the CPU, so only
its forward transform at n = 4 is tier-1; the inverse and n = 8 are `slow`.
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
from constantine_tpu.ops.ec_fft import ECFFTDomain as JaxECFFTDomain
from constantine_tpu.ops.ntt import get_domain as jax_get_domain
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
from constantine_tpu_torch.ops.cuda_ntt import (ntt_bfly, ntt_bfly_plain, ntt_stages,
                                                ntt_stages_plain)
from constantine_tpu_torch.ops.ec_fft import ECFFTDomain
from constantine_tpu_torch.ops.ntt import bit_reversal_perm, get_domain
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def env():
    return jax_get_curve("BLS12_381"), get_curve("BLS12_381")


def _fr_elems(F, shape, seed):
    """Montgomery Fr tensor of `shape` (..., NL) from numpy's generator, with
    0, 1 and r - 1 in the first three places."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    xs = [int.from_bytes(rng.bytes(32), "big") % F.p_int for _ in range(n)]
    xs[:3] = [0, 1, F.p_int - 1][:n]
    return F.encode(xs).reshape(tuple(shape) + (F.NL,))


def _ref(x):
    return jnp.asarray(convert.to_reference(x))


def _port(a):
    return convert.from_reference(np.asarray(a))


@pytest.mark.parametrize("log_n", [3, 4, 5, 6])
def test_batched_ntt_matches_reference(env, log_n):
    _, ctx = env
    n = 1 << log_n
    x = _fr_elems(ctx.fr, (3, n), log_n)
    dom, jdom = get_domain("BLS12_381", log_n), jax_get_domain("BLS12_381", log_n)
    assert torch.equal(dom.ntt(x), _port(jdom.ntt(_ref(x))))
    assert torch.equal(dom.intt(x), _port(jdom.intt(_ref(x))))


@pytest.mark.parametrize("log_n", [10, 12])
def test_four_step_ntt_matches_reference(env, log_n):
    _, ctx = env
    n = 1 << log_n
    x = _fr_elems(ctx.fr, (n,), 100 + log_n)
    dom, jdom = get_domain("BLS12_381", log_n), jax_get_domain("BLS12_381", log_n)
    assert dom._use_four_step(x)
    assert torch.equal(dom.ntt(x), _port(jdom.ntt(_ref(x))))
    assert torch.equal(dom.intt(x), _port(jdom.intt(_ref(x))))


@pytest.mark.parametrize("log_n", [10, 12])
def test_four_step_equals_radix2(env, log_n):
    _, ctx = env
    x = _fr_elems(ctx.fr, (1 << log_n,), 200 + log_n)
    dom = get_domain("BLS12_381", log_n)
    for inverse in (False, True):
        assert torch.equal(dom._transform_four_step(x, inverse), dom._transform(x, inverse))


def test_coset_ntt_matches_reference(env):
    _, ctx = env
    x = _fr_elems(ctx.fr, (1024,), 7)
    dom, jdom = get_domain("BLS12_381", 10), jax_get_domain("BLS12_381", 10)
    ev = dom.coset_ntt(x, 7)
    assert torch.equal(ev, _port(jdom.coset_ntt(_ref(x), 7)))
    assert torch.equal(dom.coset_intt(x, 7), _port(jdom.coset_intt(_ref(x), 7)))
    assert torch.equal(dom.coset_intt(ev, 7), x)


def test_domain_tables_match_reference(env):
    _, ctx = env
    dom, jdom = get_domain("BLS12_381", 6), jax_get_domain("BLS12_381", 6)
    assert dom.domain_int == jdom.domain_int
    assert np.array_equal(dom.brp, np.asarray(jdom.brp))
    assert torch.equal(dom.n_inv("cpu"), _port(jdom.n_inv))
    for inverse, jtabs in ((False, jdom.tw_fwd), (True, jdom.tw_inv)):
        for got, want in zip(dom.twiddles(inverse, "cpu"), jtabs):
            assert torch.equal(got, _port(want))


# (batch, ns, lanes, h): the FK20 batched NTT's last stage, the verify's cell
# iNTT, the four-step's middle-axis stages of 8192 (n1 = 64 over 128 lanes,
# n2 = 128 over 64), and the first stage (w = 1)
STAGES = [(4, 128, 1, 64), (3, 64, 1, 8), (1, 64, 128, 16), (1, 128, 64, 64), (2, 16, 3, 1)]


def _stage_inputs(ctx, shape, seed):
    B, ns, lanes, h = shape
    F = ctx.fr
    x = _fr_elems(F, (B, ns, lanes), seed)
    tw = _fr_elems(F, (h,), seed + 1)
    tw[0] = F.encode(1)                         # w = 1, as every stage's k = 0
    return x, tw


@pytest.mark.parametrize("shape", STAGES)
def test_bfly_stage_plain_matches_reference_formula(env, shape):
    """The plain K3′ stage against the reference's _bfly body (t = b·w,
    (a + t, a - t)) on its reshape/concatenate layout, JAX field ops."""
    jctx, ctx = env
    B, ns, lanes, h = shape
    x, tw = _stage_inputs(ctx, shape, sum(shape))
    JF = jctx.fr
    y = _ref(x).reshape(B, ns // (2 * h), 2 * h, lanes, -1)
    a, b = y[:, :, :h], y[:, :, h:]
    t = JF.mul(b, jnp.broadcast_to(_ref(tw)[:, None, :], b.shape))
    want = jnp.concatenate([JF.add(a, t), JF.sub(a, t)], axis=2).reshape(B, ns, lanes, -1)
    got = ntt_bfly(ctx.fr, x, tw, h)
    assert torch.equal(got, ntt_bfly_plain(ctx.fr, x, tw, h))
    assert torch.equal(got, _port(want))
    out = x.clone()
    assert ntt_bfly(ctx.fr, out, tw, h, out=out) is out and torch.equal(out, got)


def test_stage_wrappers_reject_bad_input(env):
    _, ctx = env
    x, tw = _stage_inputs(ctx, (1, 16, 1, 4), 3)
    for args in ((x[0], tw, 4), (x, tw, 3), (x, tw, 16), (x, tw[:2], 4)):
        with pytest.raises(ValueError):
            ntt_bfly(ctx.fr, *args)
    # the pass's store factor (the four-step's twiddle matrix): a table of
    # 1 or ns * lanes rows on the pass's device
    y, fac = x.reshape(1, 16, 1, -1), x.reshape(16, -1)
    dom = get_domain("BLS12_381", 4)
    tw, brp = dom.packed_twiddles(False, "cpu"), dom._brp_index(16, "cpu")
    for bad in (fac[:8], fac[:, :4], fac.reshape(2, 8, -1), fac.to(torch.int64),
                torch.stack([fac, fac], 1)[:, 0], fac.to("meta")):
        for kw in ({"out_fac": bad}, {"in_fac": bad}):
            with pytest.raises(ValueError):
                ntt_stages(ctx.fr, y, tw, brp, 4, **kw)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("ntt_host") / "libntt_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "ntt_host.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(out))


@pytest.mark.parametrize("shape", STAGES)
def test_kernel_code_matches_plain(host_lib, env, shape):
    """ntt.cuh's per-butterfly code, looped on the host, against the plain
    stage, in place; and the pass's store factor (the twiddle-matrix
    product) against K1's plain."""
    _, ctx = env
    F = ctx.fr
    B, ns, lanes, h = shape
    x, tw = _stage_inputs(ctx, shape, 7 * sum(shape))
    buf = np.array(lb.to_numpy(x))
    twn = np.array(lb.to_numpy(tw))
    mod = np.ascontiguousarray(F.mod_words)
    fn = host_lib.ctt_host_ntt_bfly
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    fn.restype = None
    fn(mod.ctypes.data, buf.ctypes.data, buf.ctypes.data, twn.ctypes.data, B, ns, lanes, h)
    assert torch.equal(lb.to_tensor(buf), ntt_bfly_plain(F, x, tw, h))
    # the twiddle-matrix product as the pass's store factor: ntt_stages'
    # host pass over every stage, a factor a destination element, against
    # K1's plain product after the plain pass
    stages = ns.bit_length() - 1
    fac = _fr_elems(F, (ns * lanes,), 11 * sum(shape))
    tws = np.ascontiguousarray(lb.to_numpy(get_domain("BLS12_381", stages)
                                           .packed_twiddles(False, "cpu")))
    brp = np.ascontiguousarray(bit_reversal_perm(ns))
    fn = host_lib.ctt_host_ntt_stages
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_uint32]
    fn.restype = None
    xs = np.ascontiguousarray(lb.to_numpy(x))
    fs = np.ascontiguousarray(lb.to_numpy(fac))
    out = np.zeros_like(xs)
    fn(mod.ctypes.data, xs.ctypes.data, out.ctypes.data, tws.ctypes.data, brp.ctypes.data, None,
       1, fs.ctypes.data, fs.shape[0], 0, B, ns, lanes, stages, 1, 0, 0, 0)
    plain = ntt_stages_plain(F, x, lb.to_tensor(tws), torch.as_tensor(brp), stages)
    assert torch.equal(lb.to_tensor(out), mont_mul_plain(plain, fac.reshape(1, ns, lanes, F.NL)
                                                         .expand_as(plain), F))


# -- G1 scalar multiplication and the EC-FFT --------------------------------------------


def _points(ctx, ks):
    return [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in ks]


def _affine_port(ctx, P):
    (x, y), inf = ctx.g1.to_affine(tuple(v.reshape(-1, v.shape[-1]) for v in P))
    xs, ys = ctx.fp.decode(x), ctx.fp.decode(y)
    return [None if i else (a, b) for a, b, i in zip(xs, ys, inf.tolist())]


def _affine_ref(jctx, P):
    (x, y), inf = jctx.g1.to_affine(tuple(v.reshape(-1, v.shape[-1]) for v in P))
    fp = get_curve("BLS12_381").fp
    xs, ys = fp.decode(_port(x)), fp.decode(_port(y))
    return [None if i else (a, b) for a, b, i in zip(xs, ys, np.asarray(inf).tolist())]


def test_scalar_mul_matches_reference(env):
    """Scalars 0, 1, 2^64 - 1 and a random one over 64 bits (the ladder is
    the same at FK20's 255); the third lane's point is infinity."""
    jctx, ctx = env
    pts = _points(ctx, [5, 7, 11, 13])
    ks = [0, 1, 2 ** 64 - 1, int(np.random.default_rng(3).integers(2, 2 ** 63))]
    X = ctx.fp.encode([q[0] for q in pts])
    Y = ctx.fp.encode([q[1] for q in pts])
    inf = torch.tensor([False, False, True, False])
    P = ctx.g1.double(ctx.g1.from_affine((X, Y), inf_mask=inf))         # Z != 1
    got = _affine_port(ctx, ctx.g1.scalar_mul(ctx.scalars_to_limbs(ks), P, scalar_bits=64))
    want = _affine_ref(jctx, jctx.g1.scalar_mul(jnp.asarray(jctx.scalars_to_limbs(ks)),
                                                tuple(_ref(v) for v in P), scalar_bits=64))
    assert got == want
    two = [rm.ec_mul(2, q, 0, ctx.p) for q in pts]
    assert got == [None, two[1], None, rm.ec_mul(ks[3] * 2, pts[3], 0, ctx.p)]


@pytest.mark.parametrize("log_n, inverse", [
    (2, False),
    pytest.param(2, True, marks=pytest.mark.slow),
    pytest.param(3, False, marks=pytest.mark.slow),
    pytest.param(3, True, marks=pytest.mark.slow),
])
def test_ec_fft_matches_reference(env, log_n, inverse):
    """The port's EC-FFT against the JAX package's and the host DFT; the
    port's runs over a trailing batch axis of 2 (the JAX one has none)."""
    jctx, ctx = env
    n = 1 << log_n
    pts = _points(ctx, [3 * i + 2 for i in range(2 * n)])
    X = ctx.fp.encode([q[0] for q in pts]).reshape(n, 2, -1)
    Y = ctx.fp.encode([q[1] for q in pts]).reshape(n, 2, -1)
    w = ctx.root_of_unity(log_n)
    dom = ECFFTDomain(ctx.g1, ctx.r, w, log_n)
    jdom = JaxECFFTDomain(jctx.g1, ctx.r, w, log_n)
    P = ctx.g1.from_affine((X, Y))
    got = _affine_port(ctx, (dom.ifft if inverse else dom.fft)(P))
    jP = tuple(_ref(v[:, 0]) for v in P)
    want = _affine_ref(jctx, (jdom.ifft if inverse else jdom.fft)(jP))
    assert got[0::2] == want
    wk = pow(w, -1, ctx.r) if inverse else w
    scale = pow(n, -1, ctx.r) if inverse else 1
    host = []
    for k in range(n):
        for b in range(2):
            acc = None
            for i in range(n):
                acc = rm.ec_add(acc, rm.ec_mul(pow(wk, i * k, ctx.r) * scale % ctx.r,
                                               pts[2 * i + b], 0, ctx.p), 0, ctx.p)
            host.append(acc)
    assert got == host
