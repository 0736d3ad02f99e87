"""The port's pairing (K11 and K12 plain versions, multi_pairing,
pairing_check) against GT values the JAX package computed, and the kernels'
own code (csrc/tower.cuh, pairing.cuh, g1.cuh built with g++) against the
plain versions.

The JAX pairing takes minutes to compile on the CPU, so its values are
kept in tests/data/torch_pairing_golden.json; a `slow` test regenerates
them. The Miller value is not canonical (line scalings differ by factors
the final exponentiation kills), so K11 is held against its own plain
version and the JAX package only after the final exponentiation.
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_g1 import get_cuda_g1
from constantine_tpu_torch.ops.pairing import get_pairing
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_pairing_golden.json"
CSRC = ROOT / "constantine_tpu_torch" / "csrc"


def _g1(ctx, ks):
    pts = [rm.ec_mul(k % ctx.r, ctx.g, 0, ctx.p) for k in ks]
    return ctx.fp.encode([q[0] for q in pts]), ctx.fp.encode([q[1] for q in pts])


def _g2(ctx, ks):
    pts = [rm.ec2_mul(k % ctx.r, ctx.g2_aff, (0, 0), -1, ctx.p) for k in ks]
    return tuple(ctx.fp.encode([c for q in pts for c in q[i]]).reshape(-1, 2, ctx.fp.NL)
                 for i in (0, 1))


def _hex(pr, v):
    return [hex(x) for x in pr.fp12.decode(v)]


@pytest.fixture(scope="module")
def env():
    ctx = get_curve("BLS12_381")
    golden = json.loads(GOLDEN.read_text())
    s = {k: int(v, 16) for k, v in golden["scalars"].items()}
    return ctx, get_pairing(), golden, s


@pytest.fixture(scope="module")
def single(env):
    """e(G1, G2) and e([a]G1, [b]G2) through the plain K11 and K12."""
    ctx, pr, _, s = env
    P, Q = _g1(ctx, [1, s["a"]]), _g2(ctx, [1, s["b"]])
    f = pr.miller_loop(P, Q)
    return P, Q, f, pr.final_exp(f)


def test_pairing_matches_reference_golden(env, single):
    _, pr, golden, _ = env
    gt = single[3]
    assert _hex(pr, gt[0]) == golden["e(G1,G2)"]
    assert _hex(pr, gt[1]) == golden["e([a]G1,[b]G2)"]
    assert not pr.fp12.eq(gt, pr.fp12.one((2,), "cpu")).any()


def test_multi_pairing_bilinearity_skip_mask_and_reference_product(env):
    """One multi-pairing: e([a]G1, [b]G2) e(-[ab]G1, G2) cancels
    (bilinearity), a fifth pair e(G1, G2) (not one, by the golden file) is
    masked out, and what is left is the golden e([c]G1, [d]G2) e([b]G1, [a]G2)."""
    ctx, pr, golden, s = env
    a, b, c, d = (s[k] for k in "abcd")
    P = _g1(ctx, [a, -a * b, c, b, 1])
    Q = _g2(ctx, [b, 1, d, a, 1])
    gt = pr.multi_pairing(P, Q, skip_mask=torch.tensor([False, False, False, False, True]))
    assert _hex(pr, gt) == golden["e([c]G1,[d]G2)*e([b]G1,[a]G2)"]
    assert not pr.fp12.eq(gt, pr.fp12.one((), "cpu"))


# -- the kernels' code, built on the host -------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("pairing_host") / "libpairing_host.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(CSRC / "pairing_host.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(out))


def _np(t):
    return np.ascontiguousarray(lb.to_numpy(t))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def test_constants_layout_matches_the_kernels(host_lib, env):
    _, pr, _, _ = env
    assert host_lib.ctt_host_pairing_consts_size() == pr.engine._consts.nbytes
    assert host_lib.ctt_host_g1_consts_size() == get_cuda_g1()._consts.nbytes


def test_kernel_miller_loop_and_final_exp_match_plain(host_lib, env, single):
    """pairing.cuh's lanes (K11, K12) against the plain versions, limb for
    limb, on e(G1, G2) and e([a]G1, [b]G2)."""
    _, pr, _, _ = env
    P, Q, f, gt = single
    consts = pr.engine._consts
    ins = [_np(t) for t in (P[0], P[1], Q[0], Q[1])]
    out = np.zeros((2, 12, 12), np.uint32)
    host_lib.ctt_host_miller_loop(_ptr(consts), *map(_ptr, ins), _ptr(out), 2)
    assert np.array_equal(out, _np(f))
    fin = _np(f)
    host_lib.ctt_host_final_exp(_ptr(consts), _ptr(fin), _ptr(out), 2)
    assert np.array_equal(out, _np(gt))


def test_kernel_tower_ops_match_plain(host_lib, env):
    """tower.cuh's Fp12 products against the plain towers."""
    ctx, pr, _, _ = env
    p12 = pr.engine.p12
    rng = np.random.default_rng(9)
    a = ctx.fp.encode([int.from_bytes(rng.bytes(48), "big") % ctx.p
                       for _ in range(36)]).reshape(3, 12, 12)
    b = a[[1, 2, 0]]
    line = b.clone()
    line[:, 2:8] = 0                   # (lA, 0, 0) + (0, lC, lB) w, memory order
    sparse_in = torch.cat([line[:, 0:2], line[:, 8:10], line[:, 10:12]], 1)
    sparse_in = torch.nn.functional.pad(sparse_in, (0, 0, 0, 6))
    want = {0: p12.mul(a, b), 1: p12.square(a), 2: p12.cyclotomic_square(a),
            3: p12.conj12(a), 4: p12.frobenius(a, 1), 5: p12.frobenius(a, 2),
            6: p12.inv(a), 7: p12.mul(a, line)}
    consts = pr.engine._consts
    for op, ref in want.items():
        x, y = _np(a), _np(sparse_in if op == 7 else b)
        out = np.zeros_like(x)
        host_lib.ctt_host_fp12_op(_ptr(consts), op, _ptr(x), _ptr(y), _ptr(out), 3)
        assert np.array_equal(out, _np(ref)), f"op {op}"


def test_kernel_g1_decompress_matches_plain(host_lib):
    """g1.cuh's lane (K13) against the plain version: G1 points with both
    signs, a non-square x, and an on-curve point outside G1."""
    ctx = get_curve("BLS12_381")
    F, p = ctx.fp, ctx.p
    pts = [rm.ec_mul(k, ctx.g, 0, p) for k in (1, 2, 77)]
    x_out = next(x for x in range(3, 100)
                 if rm.sqrt_mod(x ** 3 + 4, p) is not None
                 and rm.ec_mul(ctx.r, (x, rm.sqrt_mod(x ** 3 + 4, p)), 0, p) is not None)
    x_nsq = next(x for x in range(3, 100) if rm.sqrt_mod(x ** 3 + 4, p) is None)
    xs = [q[0] for q in pts] + [x_out, x_nsq]
    sign = torch.tensor([True, False, True, False, True])
    dec = get_cuda_g1()
    xm = F.encode(xs)
    y, ok = dec.decompress_mont(xm, sign)
    assert ok.tolist() == [True, True, True, False, False]
    yh = np.zeros((5, 12), np.uint32)
    okh = np.zeros(5, np.int32)
    s32 = sign.to(torch.int32).numpy()
    host_lib.ctt_host_g1_decompress(_ptr(dec._consts), _ptr(_np(xm)), _ptr(s32), _ptr(yh),
                                    _ptr(okh), 5)
    assert np.array_equal(yh, _np(y)) and okh.tolist() == ok.int().tolist()


@pytest.mark.slow
def test_golden_file_matches_reference_package():
    assert _reference_golden() == json.loads(GOLDEN.read_text())


def _reference_golden():
    """The golden file's values, computed by the JAX package (minutes on the
    CPU: the XLA pairing's compile)."""
    from constantine_tpu.ops.pairing import get_pairing as jax_get_pairing
    import jax.numpy as jnp
    jpr = jax_get_pairing("BLS12_381")
    ctx = jpr.ctx
    p, r = ctx.p, ctx.r
    rng = np.random.default_rng(12)
    a, b, c, d = (int.from_bytes(rng.bytes(32), "big") % r for _ in range(4))
    Ps = [ctx.g] + [rm.ec_mul(k, ctx.g, 0, p) for k in (a, c, b)]
    Qs = [ctx.g2_aff] + [rm.ec2_mul(k, ctx.g2_aff, (0, 0), -1, p) for k in (b, d, a)]
    px = jnp.asarray(ctx.fp.encode([q[0] for q in Ps]))
    py = jnp.asarray(ctx.fp.encode([q[1] for q in Ps]))
    qx = jnp.asarray(np.stack([jpr.fp2.encode(list(q[0])) for q in Qs]))
    qy = jnp.asarray(np.stack([jpr.fp2.encode(list(q[1])) for q in Qs]))
    gt = jpr.pairing((px, py), (qx, qy))

    def hx(v):
        return [hex(x) for x in jpr.fp12.decode(v)]
    golden = json.loads(GOLDEN.read_text())
    return {"recipe": golden["recipe"],
            "scalars": {k: hex(v) for k, v in zip("abcd", (a, b, c, d))},
            "e(G1,G2)": hx(gt[0]), "e([a]G1,[b]G2)": hx(gt[1]),
            "e([c]G1,[d]G2)*e([b]G1,[a]G2)": hx(jpr.fp12.mul(gt[2], gt[3]))}
