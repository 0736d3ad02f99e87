"""K7 scaled_doubles' team lane and K9's safegcd inverse as the card runs
them, built with g++ and held against the plain versions and host big ints.

K7 (``csrc/ec_kernels.cu``) runs ``ec.cuh``'s ``scaled_doubles_lane``: a team
of SM_TEAM threads a window, each doubling ``ec_double_team`` in 3 levels of
products. ``csrc/pairing_host.cpp`` plays the team with one thread
(``Solo``) or with a thread for each member meeting at a barrier, into
outputs filled with a sentinel (every word must be written by its member).
The team doubling is held limb for limb against ``ec_double`` (one thread,
``ctt_host_ec_double`` of ``csrc/ec_host.cpp``) and the plain doubling on
seeded points, a point at infinity (Z = 0) and a point with Y = 0; the lane
loop against ``_scaled_doubles_plain`` (the reference's masked ladder) at
(W, c) = (4, 3) and the online commit's (15, 9), whose last lane runs 126
doublings, and against [2^(c w)] P_w worked out with the JAX package's
``refmath`` (pure Python, no JAX import).

K9 (``csrc/field_kernels.cu``) runs ``inv.cuh``'s ``fe_inv``: Bernstein-Yang
divsteps in a fixed number of batches of INV_BITS. ``ctt_host_fe_inv`` runs
it over Fp and Fr, with the R^3 words the wrapper hands the kernel, against
pow(a, -1, m) in Montgomery form (aR -> a^-1 R)
on 0, 1, R mod m, m - 1, powers of two, runs of ones and of zeros and 2,000
seeded values, and against the plain Fermat power ``_fermat_inv_plain``; the
batches it reports cover Bernstein-Yang's divstep bound, and one batch of
divsteps equals the divsteps of that bound's theorem on the integers. No
JAX.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu.utils import refmath as pkg_rm
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_ec import ec_double
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
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
    lib = _build(tmp_path_factory, "ec_host")
    lib.ctt_host_ec_double.argtypes = [P_] * 7 + [I_]
    lib.ctt_host_ec_double.restype = None
    lib.ctt_host_fe_inv.argtypes = [I_] + [P_] * 4 + [I_]
    lib.ctt_host_fe_inv.restype = I_
    lib.ctt_host_divsteps.argtypes = [I_, ctypes.c_uint32, ctypes.c_uint32, P_, P_]
    lib.ctt_host_divsteps.restype = I_
    return lib


@pytest.fixture(scope="module")
def team_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "pairing_host", "-pthread")
    lib.ctt_host_ec_double_team.argtypes = [P_, I_] + [P_] * 6 + [I_]
    lib.ctt_host_ec_double_team.restype = I_
    lib.ctt_host_scaled_doubles_team.argtypes = [P_, I_, I_] + [P_] * 6 + [I_, I_]
    lib.ctt_host_scaled_doubles_team.restype = I_
    return lib


@pytest.fixture(scope="module")
def ctx():
    return get_curve("BLS12_381")


def _jacobian(ctx, n, seed):
    """n seeded G1 points [k]G as host ints (x, y) and in Jacobian form with
    Z = lambda != 1: (X, Y, Z) Montgomery tensors (n, NL)."""
    p = ctx.p
    rng = np.random.default_rng(seed)
    pts = [rm.ec_mul(int(k), ctx.g, 0, p) for k in rng.integers(2, 1 << 62, size=n)]
    lam = [int(v) % (p - 2) + 2 for v in rng.integers(2, 1 << 62, size=n)]
    X = [x * l * l % p for (x, _), l in zip(pts, lam)]
    Y = [y * pow(l, 3, p) % p for (_, y), l in zip(pts, lam)]
    return pts, tuple(ctx.fp.encode(v) for v in (X, Y, lam))


def _affine(ctx, X, Y, Z):
    """Montgomery Jacobian words (NL,) x 3 -> host (x, y), None at Z = 0."""
    p = ctx.p
    rinv = pow(1 << (32 * NL), -1, p)
    x, y, z = (lb.limbs_to_int(v) * rinv % p for v in (X, Y, Z))
    if z == 0:
        return None
    zi = pow(z, -1, p)
    return x * zi * zi % p, y * pow(zi, 3, p) % p


def _np(t):
    return np.ascontiguousarray(lb.to_numpy(t))


def _mod(F):
    return np.ascontiguousarray(F.mod_words)


# -- the team doubling ---------------------------------------------------------


@pytest.fixture(scope="module")
def rows(ctx):
    """8 seeded points, then one at infinity (Z = 0, X and Y not 1) and one
    with Y = 0, as (n, NL) Montgomery tensors."""
    _, (X, Y, Z) = _jacobian(ctx, 10, seed=7)
    Z[8] = 0
    Y[9] = 0
    return X, Y, Z


@pytest.mark.parametrize("T", TEAMS)
def test_double_team_matches_ec_double(ec_lib, team_lib, ctx, rows, T):
    F = ctx.fp
    ins = [_np(t) for t in rows]
    n = ins[0].shape[0]
    one = [np.zeros_like(ins[0]) for _ in range(3)]
    ec_lib.ctt_host_ec_double(_mod(F).ctypes.data, *(a.ctypes.data for a in ins),
                              *(o.ctypes.data for o in one), n)
    team = [np.full_like(ins[0], SENTINEL) for _ in range(3)]
    assert team_lib.ctt_host_ec_double_team(_mod(F).ctypes.data, T, *(a.ctypes.data for a in ins),
                                            *(o.ctypes.data for o in team), n) == 0
    assert not any((o == SENTINEL).any() for o in team), "a word was never written"
    for a, b in zip(team, one):
        assert np.array_equal(a, b)
    plain = ec_double(F, lambda a, b: mont_mul_plain(a, b, F), rows)
    for a, b in zip(team, plain):
        assert torch.equal(lb.to_tensor(a), b)
    assert not team[2][8].any() and not team[2][9].any()       # Z = 0 and Y = 0 -> infinity


def test_double_team_sizes_of_the_host_build(team_lib, ctx):
    z = np.zeros((1, NL), np.uint32)
    assert team_lib.ctt_host_ec_double_team(_mod(ctx.fp).ctypes.data, 3,
                                            *(z.ctypes.data for _ in range(6)), 1) == -1


# -- K7's lane -------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(4, 3), (15, 9)], ids=["W4c3", "W15c9"])
def window(request, ctx):
    """K7's input at (W, c): planar (NL, W) columns of seeded points, lane 1
    at infinity and lane 3 with Y = 0; the plain version's output."""
    W, c = request.param
    pts, (X, Y, Z) = _jacobian(ctx, W, seed=W * 100 + c)
    Z[1] = 0
    Y[3] = 0
    P = tuple(v.T.contiguous() for v in (X, Y, Z))
    return W, c, pts, P, ctx.g1.pec._scaled_doubles_plain(P, c, W)


@pytest.mark.parametrize("T", TEAMS)
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_scaled_doubles_lane_matches_plain(team_lib, ctx, window, T, reverse):
    W, c, pts, P, plain = window
    ins = [_np(t) for t in P]
    outs = [np.full_like(ins[0], SENTINEL) for _ in range(3)]
    assert team_lib.ctt_host_scaled_doubles_team(
        _mod(ctx.fp).ctypes.data, T, int(reverse), *(a.ctypes.data for a in ins),
        *(o.ctypes.data for o in outs), W, c) == 0
    assert not any((o == SENTINEL).any() for o in outs), "a word was never written"
    for a, b in zip(outs, plain):
        assert torch.equal(lb.to_tensor(a), b)
    for w in range(W):
        got = _affine(ctx, *(o[:, w] for o in outs))
        want = None if w in (1, 3) else pkg_rm.ec_mul(1 << (c * w), pts[w], 0, ctx.p)
        assert got == want, f"lane {w}"


# -- K9's safegcd ------------------------------------------------------------------


def _inv_inputs(m, seed):
    """0, 1, R mod m, m - 1, powers of two, runs of ones and of zeros, 2,000
    seeded values (all < m)."""
    d = m.bit_length()
    R = 1 << (32 * (8 if d <= 256 else 12))
    rng = np.random.default_rng(seed)
    vals = [0, 1, R % m, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2]
    vals += [1 << k for k in range(d - 1)]
    vals += [(1 << k) - 1 for k in range(2, d, 3)]                       # runs of ones
    vals += [(1 << (d - 2)) | 1, (1 << (d - 2)) | (1 << (d // 2)), 3 << (d - 3)]   # zeros
    vals += [m - (1 << k) for k in range(0, d - 2, 5)]
    vals += [int.from_bytes(rng.bytes(48), "big") % m for _ in range(2000)]
    return [v % m for v in vals]


def _fe_inv(lib, F, vals):
    x = np.ascontiguousarray(lb.ints_to_limbs(vals, F.NL).astype(np.uint32))
    out = np.full_like(x, SENTINEL)
    r3 = np.ascontiguousarray(F.affine._r3_words)
    batches = lib.ctt_host_fe_inv(F.NL, _mod(F).ctypes.data, r3.ctypes.data, x.ctypes.data,
                                  out.ctypes.data, len(vals))
    return out, batches


def _divstep_bits(lib):
    """inv.cuh's INV_BITS, the divsteps of one batch."""
    t, bits = (ctypes.c_int * 4)(), ctypes.c_int()
    lib.ctt_host_divsteps(-1, 1, 0, t, ctypes.byref(bits))
    return bits.value


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_safegcd_matches_montgomery_inverse(ec_lib, ctx, which):
    F = getattr(ctx, which)
    m, R = F.p_int, 1 << (32 * F.NL)
    vals = _inv_inputs(m, seed=30)
    out, batches = _fe_inv(ec_lib, F, vals)
    d = m.bit_length()
    bound = (49 * d + 57) // 17
    assert (d, bound) == ((381, 1101) if which == "fp" else (255, 738))
    assert _divstep_bits(ec_lib) == 30
    assert batches == -(-bound // 30) == (37 if which == "fp" else 25)
    got = lb.limbs_to_ints(out)
    want = [pow(v, -1, m) * R * R % m if v else 0 for v in vals]   # aR -> a^-1 R
    bad = [v for v, a, b in zip(vals, got, want) if a != b]
    assert not bad, f"{len(bad)} lanes differ, first {bad[:3]}"


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_safegcd_matches_fermat_plain(ec_lib, ctx, which):
    """The kernel's inverse against the plain version K9 is held to on the
    card, on the special values and 32 seeded ones, and the host ints."""
    F = getattr(ctx, which)
    vals = _inv_inputs(F.p_int, seed=5)
    vals = vals[:7] + vals[-32:]
    out, _ = _fe_inv(ec_lib, F, vals)
    x = lb.to_tensor(lb.ints_to_limbs(vals, F.NL)).T.contiguous()       # (NL, n) lanes
    plain = F.affine._fermat_inv_plain(x)
    assert torch.equal(lb.to_tensor(out).T.contiguous(), plain)
    assert F.decode(lb.to_tensor(out)) == [pow(v, -1, F.p_int) if v else 0
                                           for v in F.decode(lb.to_tensor(
                                               lb.ints_to_limbs(vals, F.NL)))]


def _divsteps(delta, f, g, n):
    """n of Bernstein-Yang's divsteps on the integers (f odd), delta from 1:
    (delta, f, g) and the matrix (u, v, q, r) with u f0 + v g0 = 2^n f and
    q f0 + r g0 = 2^n g."""
    u, v, q, r = 1, 0, 0, 1
    for _ in range(n):
        if delta > 0 and g & 1:
            delta, f, g, u, v, q, r = 1 - delta, g, (g - f) // 2, 2 * q, 2 * r, q - u, r - v
        elif g & 1:
            delta, g, u, v, q, r = 1 + delta, (g + f) // 2, 2 * u, 2 * v, q + u, r + v
        else:
            delta, g, u, v = 1 + delta, g // 2, 2 * u, 2 * v
    return delta, f, g, (u, v, q, r)


def test_divsteps_batch_is_bernstein_yang(ec_lib):
    """A batch of inv.cuh's divsteps on one word equals B divsteps on the
    integers (delta 1 - delta at a swap, the proven count's variant), from
    delta = 1 and from seeded deltas, with the matrix the whole batch."""
    B = _divstep_bits(ec_lib)
    rng = np.random.default_rng(B)
    t, bits = (ctypes.c_int * 4)(), ctypes.c_int()
    for i in range(400):
        f = int(rng.integers(0, 1 << B)) | 1
        g = int(rng.integers(0, 1 << B)) if i % 7 else (1 << (B - 1)) * (i % 2)
        delta = 1 if i < 100 else int(rng.integers(-200, 200))
        eta = ec_lib.ctt_host_divsteps(-delta, f, g, t, ctypes.byref(bits))
        d2, f2, g2, m = _divsteps(delta, f, g, B)
        assert (-eta, tuple(t)) == (d2, m)
        u, v, q, r = m
        assert u * f + v * g == f2 << B and q * f + r * g == g2 << B
        assert abs(u) + abs(v) <= 1 << B and abs(q) + abs(r) <= 1 << B


def test_safegcd_widths_of_the_host_build(ec_lib, ctx):
    z = np.zeros((1, NL), np.uint32)
    assert ec_lib.ctt_host_fe_inv(10, *(z.ctypes.data for _ in range(4)), 1) == -1
