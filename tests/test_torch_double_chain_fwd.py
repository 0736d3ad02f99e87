"""K3 double_k's team lane and K8's prefix scan, built with g++ and held
against the plain versions and the JAX package.

K3 double (``csrc/ec_kernels.cu``) runs ``ec.cuh``'s ``double_k_lane``: a
team of SM_TEAM threads a lane, k doublings over ``ec_double_team`` with the
point in registers between them, the store split among the members.
``csrc/ec_host.cpp`` (``ctt_host_ec_double_k_team``) plays the team with one
thread (``Solo``) or a thread for each member of a team of 2 or 4 meeting at
``host_team.h``'s barrier, the lanes in order or reversed, into outputs
filled with a sentinel (every word must be written by its member). Held
limb for limb against the plain chain (``CudaEC.double_k`` on CPU tensors:
``ec_double`` k times) and against the JAX package's ``ECGroup.double``
composed k times, at k = 1, 2 and 12 on seeded points, a point at infinity
and a point with Y = 0. ``PrecomputedMSM`` builds each table layer with one
``double_k`` call.

K8 (``csrc/field_kernels.cu``) runs ``csrc/chain.cuh``'s ``chain_fwd_phase``,
the forward chain as a prefix scan over segments of S links, a thread a
segment. ``csrc/chain_host.cpp`` (``ctt_host_chain_fwd``) plays every block
of a launch, each phase's threads in order or reversed, the tile and the
outputs filled with a sentinel. Held against ``_chain_fwd_plain`` at the
paths' C = 32 with the card's segment lengths and blocks, the plain scan (S
= 1) and S = 8, and at short, odd and ragged chains, and, composed with
K10's host scan into a batched inversion, against the JAX package's
``Field.batch_inv``.
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
from constantine_tpu_torch.ops import cuda_ec
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import CHAIN_MAX_C
from constantine_tpu_torch.ops.msm_precomp import PrecomputedMSM
from constantine_tpu_torch.utils import refmath as rm

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
NL = 12
SENTINEL = 0xDEADBEEF
SM_TEAM = int(re.search(r"constexpr int SM_TEAM = (\d+);",
                        (CSRC / "ec_kernels.cu").read_text()).group(1))
TEAMS = sorted({1, 2, SM_TEAM})
P_, I_ = ctypes.c_void_p, ctypes.c_int


def _build(tmp_path_factory, name, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp(name) / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC", *flags,
                    "-o", str(out), str(CSRC / f"{name}.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def ec_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "ec_host", "-pthread")
    lib.ctt_host_ec_double_k_team.argtypes = [P_, I_, I_] + [P_] * 6 + [I_, I_]
    lib.ctt_host_ec_double_k_team.restype = I_
    return lib


@pytest.fixture(scope="module")
def chain_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "chain_host")
    for name in ("ctt_host_chain_fwd", "ctt_host_chain_bwd_inv"):
        fn = getattr(lib, name)
        fn.argtypes = ([I_] + [P_] * (4 if name == "ctt_host_chain_fwd" else 5)
                       + [I_] * (5 if name == "ctt_host_chain_fwd" else 4) + [ctypes.c_uint32])
        fn.restype = I_
    lib.ctt_host_chain_max_c.restype = I_
    return lib


@pytest.fixture(scope="module")
def ctxs():
    return jax_get_curve("BLS12_381"), get_curve("BLS12_381")


def _np(t):
    return np.ascontiguousarray(lb.to_numpy(t))


def _mod(F):
    return np.ascontiguousarray(F.mod_words)


# -- K3 double_k: the team lane ------------------------------------------------------


@pytest.fixture(scope="module")
def points(ctxs):
    """10 lanes as (n, NL) Montgomery tensors: 8 seeded points [k]G in
    Jacobian form with Z = lambda != 1, then one at infinity (Z = 0, X and Y
    not 1) and one with Y = 0."""
    _, ctx = ctxs
    p = ctx.p
    rng = np.random.default_rng(13)
    pts = [rm.ec_mul(int(k), ctx.g, 0, p) for k in rng.integers(2, 1 << 62, size=8)]
    lam = [int(v) % (p - 2) + 2 for v in rng.integers(2, 1 << 62, size=10)]
    pts += [pts[0], pts[1]]
    X = [x * l * l % p for (x, _), l in zip(pts, lam)]
    Y = [y * pow(l, 3, p) % p for (_, y), l in zip(pts, lam)]
    P = tuple(ctx.fp.encode(v) for v in (X, Y, lam))
    P[2][8] = 0
    P[1][9] = 0
    return P


@pytest.fixture(scope="module")
def doubled(ctxs, points):
    """{k: (the plain chain, the JAX package's ECGroup.double k times)}, both
    (n, NL) x 3."""
    jctx, ctx = ctxs
    planar = tuple(v.T.contiguous() for v in points)
    J = tuple(jnp.asarray(convert.to_reference(v)) for v in points)
    out, ref = {}, J
    for k in range(1, 13):
        ref = jctx.g1.double(ref)
        if k in (1, 2, 12):
            plain = tuple(v.T for v in ctx.g1.pec.double_k(planar, k))
            out[k] = plain, tuple(convert.from_reference(np.asarray(v)) for v in ref)
    return out


@pytest.mark.parametrize("T", TEAMS)
@pytest.mark.parametrize("k", [1, 2, 12])
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_double_k_lane_matches_plain_and_reference(ec_lib, ctxs, points, doubled, T, k, reverse):
    _, ctx = ctxs
    ins = [_np(v.T.contiguous()) for v in points]
    n = ins[0].shape[1]
    outs = [np.full_like(ins[0], SENTINEL) for _ in range(3)]
    assert ec_lib.ctt_host_ec_double_k_team(
        _mod(ctx.fp).ctypes.data, T, int(reverse), *(a.ctypes.data for a in ins),
        *(o.ctypes.data for o in outs), n, k) == 0
    assert not any((o == SENTINEL).any() for o in outs), "a word was never written"
    plain, ref = doubled[k]
    for a, b, c in zip(outs, plain, ref):
        got = lb.to_tensor(a).T
        assert torch.equal(got, b)
        assert torch.equal(got, c)
    assert not outs[2][:, 8].any() and not outs[2][:, 9].any()   # Z = 0 and Y = 0 -> infinity


def test_double_k_lane_zero_doublings_and_team_sizes(ec_lib, ctxs, points):
    """k = 0 copies every lane; a team size the host build lacks is refused."""
    _, ctx = ctxs
    ins = [_np(v.T.contiguous()) for v in points]
    n = ins[0].shape[1]
    outs = [np.full_like(ins[0], SENTINEL) for _ in range(3)]
    mod = _mod(ctx.fp).ctypes.data
    assert ec_lib.ctt_host_ec_double_k_team(mod, SM_TEAM, 0, *(a.ctypes.data for a in ins),
                                            *(o.ctypes.data for o in outs), n, 0) == 0
    assert all(np.array_equal(a, o) for a, o in zip(ins, outs))
    assert ec_lib.ctt_host_ec_double_k_team(mod, 3, 0, *(a.ctypes.data for a in ins),
                                            *(o.ctypes.data for o in outs), n, 1) == -1
    with pytest.raises(ValueError):
        ctx.g1.pec.double_k(tuple(v.T.contiguous() for v in points), -1)


def test_precompute_doubles_a_layer_in_one_call(ctxs, monkeypatch):
    """PrecomputedMSM's table layers: one double_k of c doublings a layer,
    none of them through a per-doubling loop; the layers are the c-fold
    doubling of the last."""
    _, ctx = ctxs
    g, F = ctx.g1, ctx.fp
    pts = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in (3, 5, 7)]
    aff = (F.encode([q[0] for q in pts]), F.encode([q[1] for q in pts]))
    calls = []
    orig = cuda_ec.CudaEC.double_k

    def spy(self, P, k):
        calls.append(k)
        return orig(self, P, k)

    monkeypatch.setattr(cuda_ec.CudaEC, "double_k", spy)
    pm = PrecomputedMSM(g, aff, c=4, scalar_bits=16)
    assert pm.W == 5 and calls == [4] * 4
    tx, ty = pm._tables
    for j in range(pm.W):
        want = [rm.ec_mul(1 << (4 * j), q, 0, ctx.p) for q in pts]
        got = list(zip(F.decode(tx[3 * j:3 * j + 3]), F.decode(ty[3 * j:3 * j + 3])))
        assert got == want, f"layer {j}"


# -- K8: the prefix scan, built with g++ ----------------------------------------------


def _fields(ctxs, which):
    jctx, ctx = ctxs
    return (jctx.fp, ctx.fp) if which == "fp" else (jctx.fr, ctx.fr)


def _ints(p, n, seed):
    """n values below p from a seed, with 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(n)]
    return ([0, 1, p - 1] + vals)[:n]


def _planar(F, C, Mw, seed):
    """(C, NL, Mw) Montgomery elements from a seed, 0, 1 and p - 1 among them."""
    return F.encode(_ints(F.p_int, C * Mw, seed)).reshape(C, Mw, F.NL).permute(0, 2,
                                                                               1).contiguous()


def host_chain_fwd(lib, F, dC, S, G, reverse=False):
    """K8's scan over segments of S links on the host into sentinel-filled
    outputs; returns (pe, bp, the scan's levels)."""
    C, NL, Mw = dC.shape
    d = _np(dC)
    pe = np.full((C, NL, Mw), SENTINEL, np.uint32)
    bp = np.full((NL, Mw), SENTINEL, np.uint32)
    levels = lib.ctt_host_chain_fwd(NL, _mod(F).ctypes.data, d.ctypes.data, pe.ctypes.data,
                                    bp.ctypes.data, C, S, Mw, G, int(reverse), SENTINEL)
    assert not (pe == SENTINEL).all(1).any(), "a link was never stored"
    assert not (bp == SENTINEL).all(0).any(), "a chain's product was never stored"
    return lb.to_tensor(pe), lb.to_tensor(bp), levels


# (C, S, Mw, G): the paths' chains of 32 at the card's two configurations
# (segments of 2 links, 4 lanes a block; 4 links, 16 lanes) on two blocks
# and on a ragged block, the plain scan (S = 1) and segments of 8, short,
# odd, ragged and single-link chains
CARD_FWD = {(int(a), int(b)) for a, b in re.findall(
    r"launch_chain_fwd_sg<N, (\d+), (\d+)>", (CSRC / "field_kernels.cu").read_text())}
SCANS = [(32, 2, 16, 4), (32, 4, 40, 16), (32, 2, 6, 4), (32, 4, 20, 16), (32, 1, 24, 8),
         (32, 8, 20, 16), (4, 1, 12, 4), (5, 2, 7, 3), (1, 2, 5, 4), (2, 4, 8, 8), (17, 4, 9, 4),
         (31, 2, 3, 2), (31, 8, 5, 4), (3, 1, 4, 2)]


@pytest.mark.parametrize("which", ["fp", "fr"])
@pytest.mark.parametrize("shape", SCANS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_host_fwd_scan_matches_plain(ctxs, chain_lib, which, shape, reverse):
    _, F = _fields(ctxs, which)
    C, S, Mw, G = shape
    dC = _planar(F, C, Mw, seed=3 * C + Mw + G + S)
    pe, bp, levels = host_chain_fwd(chain_lib, F, dC, S, G, reverse)
    assert levels == (-(-C // S) - 1).bit_length()
    want_pe, want_bp = F.affine.chain_fwd(dC)
    assert torch.equal(pe, want_pe)
    assert torch.equal(bp, want_bp)


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_host_scans_invert_like_reference(ctxs, chain_lib, which):
    """x (C * Mw lanes) chained down C as batch_inv_packed does: K8's host
    scan, the chain products inverted, K10's host scan -- equal to the JAX
    package's Field.batch_inv of x."""
    jF, F = _fields(ctxs, which)
    C, Mw = 8, 6
    xs = [v or 1 for v in _ints(F.p_int, C * Mw, seed=23)]          # no zero lanes
    ja = jF.encode(xs)
    x = convert.from_reference(ja)
    dC = x.T.reshape(F.NL, C, Mw).transpose(0, 1).contiguous()
    pe, bp, _ = host_chain_fwd(chain_lib, F, dC, S=2, G=4, reverse=True)
    bpinv = _np(F.encode([pow(v, -1, F.p_int) for v in F.decode(bp.T)]).T.contiguous())
    inv = np.full((C, F.NL, Mw), SENTINEL, np.uint32)
    assert chain_lib.ctt_host_chain_bwd_inv(F.NL, _mod(F).ctypes.data, _np(pe).ctypes.data,
                                            _np(dC).ctypes.data, bpinv.ctypes.data,
                                            inv.ctypes.data, C, Mw, 4, 0, SENTINEL) == 3
    got = lb.to_tensor(inv).transpose(0, 1).reshape(F.NL, C * Mw).T
    ref = jF.batch_inv(jnp.asarray(ja), chain=C)
    assert np.array_equal(convert.to_reference(got), np.asarray(ref))
    assert F.decode(got) == [pow(v, -1, F.p_int) for v in xs]


def test_host_fwd_scan_bounds(ctxs, chain_lib):
    """The host build, the kernel and the wrapper take chains of at most
    CHAIN_MAX_C links, of 8 or 12 limbs; the wrapper raises on a longer one.
    The segment lengths and blocks the kernel launches are among SCANS'."""
    _, ctx = ctxs
    F = ctx.fr
    assert chain_lib.ctt_host_chain_max_c() == CHAIN_MAX_C
    assert CARD_FWD and CARD_FWD <= {(S, G) for C, S, _, G in SCANS if C == CHAIN_MAX_C}
    z = np.zeros((CHAIN_MAX_C + 1, F.NL, 2), np.uint32)
    mod = _mod(F).ctypes.data
    for nl, C, S in ((F.NL, CHAIN_MAX_C + 1, 2), (10, 4, 2), (F.NL, 4, 0)):
        assert chain_lib.ctt_host_chain_fwd(nl, mod, z.ctypes.data, z.ctypes.data,
                                            z.ctypes.data, C, S, 2, 2, 0, 0) == -1
    with pytest.raises(ValueError):
        F.affine.chain_fwd(torch.zeros((CHAIN_MAX_C + 1, F.NL, 2), dtype=torch.int32))
