"""K1's product chains and K10's suffix scan, against the JAX package.

K1. ``mont_prod(F, f0, ..., f_{m-1}, squarings=k)`` computes (f0 ... f_{m-1})
^(2^k) in one launch on the card; its plain version, the one CPU tensors
run, is the chain of ``mont_mul_plain``. The same Montgomery values (made
from a seed with numpy, 0, 1 and p - 1 among them) go through the JAX
package's ``Field.mul`` and ``Field.square`` composed in the same chain, with
the broadcast factors expanded for it; the port gets them as periodic
broadcasts (a constant row, a row of the batch's last axis, an ``expand``
of it). Exact.

K10. ``csrc/chain.cuh``'s scan, built with g++ through
``csrc/chain_host.cpp``: every block of a launch, each phase's threads in
order or reversed, the tile filled with a sentinel and the output too, so a
word read before it is written, or never stored, shows. Held against
``_chain_bwd_inv_plain`` at the paths' C = 32 and at short, odd and ragged
chains, and, composed into a batched inversion, against the JAX package's
``Field.batch_inv``.
"""

import ctypes
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
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_field import (CHAIN_MAX_C, mont_mul, mont_mul_plain,
                                                  mont_prod, mont_prod_plain)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
SENTINEL = 0xDEADBEEF
P_, I_ = ctypes.c_void_p, ctypes.c_int
BATCH = (3, 4)          # every JAX call at one shape: one compile per field and op


@pytest.fixture(scope="module")
def ctxs():
    return jax_get_curve("BLS12_381"), get_curve("BLS12_381")


def _fields(ctxs, which):
    jctx, ctx = ctxs
    return (jctx.fp, ctx.fp) if which == "fp" else (jctx.fr, ctx.fr)


def _ints(p, n, seed):
    """n values below p from a seed, with 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(n)]
    return ([0, 1, p - 1] + vals)[:n]


# -- K1: product chains ---------------------------------------------------------

# (m, k, periods): a factor of period n is (3, 4, NL); 4 a row of the last
# axis, given as (4, NL); "4e" the same row expanded to (3, 4, NL) (stride 0);
# 1 a constant (NL,); "1e" a (1, 1, NL) constant expanded
CHAINS = [(1, 1, ("n",)), (1, 12, ("n",)), (2, 0, ("n", "n")), (2, 0, ("n", 1)),
          (2, 0, (1, "n")), (3, 0, ("n", 4, "n")), (3, 0, ("n", "4e", 1)),
          (4, 0, ("n", 4, "1e", "n")), (2, 3, ("n", 4)), (4, 2, (1, "n", "n", 4)),
          (3, 12, ("n", "n", 1))]


def _factor(jF, F, period, seed):
    """(the port's operand, the JAX package's (3, 4, 2NL) digits). A full
    operand holds 0, 1 and p - 1; a row or a constant random values."""
    rows = {"n": 12, 4: 4, "4e": 4, 1: 1, "1e": 1}[period]
    xs = _ints(F.p_int, 12, seed) if rows == 12 else _ints(F.p_int, rows + 3, seed)[3:]
    ja = np.asarray(jF.encode(xs))
    lead = {12: BATCH, 4: (4,), 1: ()}[rows]
    full = np.broadcast_to(ja.reshape(lead + ja.shape[-1:]), BATCH + ja.shape[-1:])
    t = convert.from_reference(ja).reshape(lead + (F.NL,))
    if period == "4e":
        t = t.expand(BATCH + (F.NL,))
    elif period == "1e":
        t = t.reshape(1, 1, F.NL).expand(BATCH + (F.NL,))
    return t, np.ascontiguousarray(full)


@pytest.mark.parametrize("which", ["fp", "fr"])
@pytest.mark.parametrize("chain", CHAINS, ids=lambda c: f"m{c[0]}k{c[1]}-" + "-".join(
    map(str, c[2])))
def test_mont_prod_plain_matches_reference_chain(ctxs, which, chain):
    jF, F = _fields(ctxs, which)
    m, k, periods = chain
    ops = [_factor(jF, F, per, seed=17 * j + m + k) for j, per in enumerate(periods)]
    ref = jnp.asarray(ops[0][1])
    for _, jx in ops[1:]:
        ref = jF.mul(ref, jnp.asarray(jx))
    for _ in range(k):
        ref = jF.square(ref)
    factors = [t for t, _ in ops]
    got = mont_prod(F, *factors, squarings=k)
    assert got.shape == BATCH + (F.NL,)
    assert np.array_equal(convert.to_reference(got), np.asarray(ref))
    assert torch.equal(mont_prod_plain(F, *factors, squarings=k), got)
    vals = [F.decode(t.expand(BATCH + (F.NL,)).reshape(-1, F.NL)) for t in factors]
    want = []
    for i in range(12):
        v = 1
        for col in vals:
            v = v * col[i] % F.p_int
        want.append(pow(v, 1 << k, F.p_int))
    assert F.decode(got.reshape(-1, F.NL)) == want


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_field_chain_methods(ctxs, which):
    """Field.square, prod, from_mont and to_mont over mont_prod, against the
    JAX package's."""
    jF, F = _fields(ctxs, which)
    ja = jF.encode(_ints(F.p_int, 12, seed=5))
    a = convert.from_reference(ja)
    for name in ("square", "from_mont", "to_mont"):
        assert np.array_equal(convert.to_reference(getattr(F, name)(a)),
                              np.asarray(getattr(jF, name)(jnp.asarray(ja)))), name
    assert torch.equal(F.prod(a, a.flip(0), squarings=1),
                       mont_mul_plain(*(mont_mul_plain(a, a.flip(0), F),) * 2, F))


def test_mont_prod_rejects_what_the_kernel_does_not_take(ctxs):
    _, ctx = ctxs
    F = ctx.fr
    a = F.encode(_ints(F.p_int, 12, seed=6)).reshape(BATCH + (F.NL,))
    with pytest.raises(ValueError):
        mont_prod(F, a)                                   # no product
    with pytest.raises(ValueError):
        mont_prod(F, *(a,) * 5)                           # five factors
    with pytest.raises(ValueError):
        mont_prod(F, a, squarings=-1)
    with pytest.raises(ValueError):                       # a broadcast inside the batch
        mont_prod(F, a, a[:, :1].expand_as(a))
    with pytest.raises(ValueError):
        mont_prod(F, a, a.to("meta"))
    with pytest.raises(ValueError):
        mont_prod(ctx.fp, a, a)                           # 8 limbs, not Fp's 12
    assert torch.equal(mont_mul(a, a[0], F), mont_mul_plain(a, a[0], F))


# -- K10: the suffix scan, built with g++ ---------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("chain_host") / "libchain_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "chain_host.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.ctt_host_chain_bwd_inv.argtypes = [I_] + [P_] * 5 + [I_] * 4 + [ctypes.c_uint32]
    lib.ctt_host_chain_bwd_inv.restype = I_
    lib.ctt_host_chain_max_c.restype = I_
    return lib


def host_chain_bwd_inv(lib, F, pe, dC, bpinv, G, reverse=False):
    """K10's scan on the host into a sentinel-filled output; returns (inv,
    the scan's levels)."""
    C, NL, Mw = dC.shape
    ins = [np.ascontiguousarray(lb.to_numpy(t)) for t in (pe, dC, bpinv)]
    out = np.full((C, NL, Mw), SENTINEL, np.uint32)
    mod = np.ascontiguousarray(F.mod_words)
    levels = lib.ctt_host_chain_bwd_inv(NL, mod.ctypes.data, *(x.ctypes.data for x in ins),
                                        out.ctypes.data, C, Mw, G, int(reverse), SENTINEL)
    assert not (out == SENTINEL).all(1).any(), "an element was never stored"
    return lb.to_tensor(out), levels


def _planar(F, C, Mw, seed):
    """(C, NL, Mw) Montgomery elements from a seed, 0, 1 and p - 1 among them."""
    xs = _ints(F.p_int, C * Mw, seed)
    return F.encode(xs).reshape(C, Mw, F.NL).permute(0, 2, 1).contiguous()


# (C, Mw, G): the paths' chains of 32 at the card's blocks (G = 4 for Fr, 8
# for Fp), on two blocks and on a ragged block, one block of 32 lanes,
# short, odd and single-link chains
SCANS = [(32, 16, 4), (32, 24, 8), (32, 32, 16), (32, 20, 16), (32, 32, 32), (4, 12, 4),
         (5, 7, 3), (1, 5, 4), (2, 8, 8), (17, 9, 4), (31, 3, 2)]


@pytest.mark.parametrize("which", ["fp", "fr"])
@pytest.mark.parametrize("shape", SCANS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_host_scan_matches_plain(ctxs, host_lib, which, shape, reverse):
    _, F = _fields(ctxs, which)
    C, Mw, G = shape
    pe, dC = _planar(F, C, Mw, seed=C + Mw), _planar(F, C, Mw, seed=7 * C + G)
    bpinv = _planar(F, 1, Mw, seed=Mw)[0]
    got, levels = host_chain_bwd_inv(host_lib, F, pe, dC, bpinv, G, reverse)
    assert levels == (C - 1).bit_length()
    assert torch.equal(got, F.affine.chain_bwd_inv(pe, dC, bpinv))


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_host_scan_inverts_like_reference(ctxs, host_lib, which):
    """x (C * Mw lanes) chained down C as batch_inv_packed does: the plain
    forward chain, the chain products inverted, the host scan -- equal to the
    JAX package's Field.batch_inv of x."""
    jF, F = _fields(ctxs, which)
    C, Mw = 8, 6
    xs = [v or 1 for v in _ints(F.p_int, C * Mw, seed=11)]          # no zero lanes
    ja = jF.encode(xs)
    x = convert.from_reference(ja)
    dC = x.T.reshape(F.NL, C, Mw).transpose(0, 1).contiguous()
    pe, bp = F.affine.chain_fwd(dC)
    bpinv = F.encode([pow(v, -1, F.p_int) for v in F.decode(bp.T)]).T.contiguous()
    inv, _ = host_chain_bwd_inv(host_lib, F, pe, dC, bpinv, G=4, reverse=True)
    got = inv.transpose(0, 1).reshape(F.NL, C * Mw).T
    ref = jF.batch_inv(jnp.asarray(ja), chain=C)
    assert np.array_equal(convert.to_reference(got), np.asarray(ref))
    assert F.decode(got) == [pow(v, -1, F.p_int) for v in xs]


def test_host_scan_bounds(ctxs, host_lib):
    """The host build, the kernel and the wrapper take chains of at most
    CHAIN_MAX_C links; the wrapper raises on a longer one."""
    _, ctx = ctxs
    F = ctx.fr
    assert host_lib.ctt_host_chain_max_c() == CHAIN_MAX_C
    z = torch.zeros((CHAIN_MAX_C + 1, F.NL, 2), dtype=torch.int32)
    out = np.zeros(z.shape, np.uint32)
    zn = np.ascontiguousarray(z.numpy())
    mod = np.ascontiguousarray(F.mod_words)
    assert host_lib.ctt_host_chain_bwd_inv(F.NL, mod.ctypes.data, zn.ctypes.data, zn.ctypes.data,
                                           zn.ctypes.data, out.ctypes.data, CHAIN_MAX_C + 1,
                                           2, 2, 0, 0) == -1
    with pytest.raises(ValueError):
        F.affine.chain_bwd_inv(z, z, z[0])
