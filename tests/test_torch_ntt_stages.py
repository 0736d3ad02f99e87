"""K3′ ntt_stages as the card runs it: ``csrc/ntt.cuh``'s pass over a tile in
shared memory, built with g++ through ``csrc/ntt_host.cpp``, against the
plain pass and the JAX package's NTTDomain.

A pass bit-reverses axis ns of a (batch, ns, lanes, 8) array and runs its
first stages over tiles of 2^stages rows by G lanes: a load (the gather
folded in), a phase per stage, a store. ``ctt_host_ntt_stages`` plays every
block of the launch, and in each phase the block's threads one after the
other, in order or reversed, the barrier between phases; the tile starts
filled with a sentinel and the output too, so a word read before it is
written, or never stored, shows. Shapes: the four-step's column and row
passes (4096: (1, 64, 64); 8192: (1, 64, 128) and (1, 128, 64)), the
batched radix-2 passes (FK20's (64, 128, 1), the cell iNTT's (128, 64, 1)),
the coset transform's first 12 of 13 stages at 8192, tiles that split the
lanes, and a pass of fewer stages than ns has. Whole transforms made of
host passes (and ntt_bfly for a stage left over) are held against the JAX
package's at small n, forward and inverse, with 0, 1 and r - 1 among the
inputs, and against the port's four-step at n = 1024.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constantine_tpu.ops.ntt import get_domain as jax_get_domain
from constantine_tpu_torch import convert
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import cuda_ntt
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops import ntt as ntt_mod
from constantine_tpu_torch.ops.cuda_ntt import (ntt_bfly_plain, ntt_stages, ntt_stages_plain,
                                                pass_stages, tile_cols)
from constantine_tpu_torch.ops.ntt import bit_reversal_perm, get_domain

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
SENTINEL = 0xDEADBEEF
P_ = ctypes.c_void_p
I_ = ctypes.c_int


@pytest.fixture(scope="module")
def fr():
    return get_curve("BLS12_381").fr


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("ntt_host") / "libntt_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "ntt_host.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.ctt_host_ntt_stages.argtypes = [P_] * 5 + [I_] * 7 + [ctypes.c_uint32]
    lib.ctt_host_ntt_stages.restype = None
    return lib


def _fr_elems(F, shape, seed):
    """Montgomery Fr tensor of `shape` (..., NL), with 0, 1 and r - 1 first."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    xs = [int.from_bytes(rng.bytes(32), "big") % F.p_int for _ in range(n)]
    xs[:3] = [0, 1, F.p_int - 1][:n]
    return F.encode(xs).reshape(tuple(shape) + (F.NL,))


def host_pass(lib, F, y, tw, brp, stages, cols=None, nthr=0, reverse=False):
    """ntt_stages' pass on the host into a sentinel-filled output."""
    B, ns, lanes, NL = y.shape
    cols = tile_cols(lanes) if cols is None else cols
    x = np.ascontiguousarray(lb.to_numpy(y))
    out = np.full_like(x, SENTINEL)
    t = np.ascontiguousarray(lb.to_numpy(tw))
    b = np.ascontiguousarray(brp.numpy().astype(np.int64))
    mod = np.ascontiguousarray(F.mod_words)
    lib.ctt_host_ntt_stages(mod.ctypes.data, x.ctypes.data, out.ctypes.data, t.ctypes.data,
                            b.ctypes.data, B, ns, lanes, stages, cols, nthr, int(reverse),
                            SENTINEL)
    assert not (out == SENTINEL).all(-1).any(), "an element was never stored"
    return lb.to_tensor(out)


# (batch, ns, lanes, stages, cols): the four-step's passes at 4096 and 8192,
# the batched radix-2 passes, tiles splitting the lanes, fewer stages than ns
# has, and the coset transform's first pass at 8192
PASSES = [(1, 64, 64, 6, 4), (1, 64, 128, 6, 4), (1, 128, 64, 7, 4), (64, 128, 1, 7, 1),
          (128, 64, 1, 6, 1), (2, 16, 8, 4, 2), (1, 32, 16, 5, 8), (3, 32, 1, 3, 1),
          (2, 64, 4, 2, 4), (1, 8192, 1, 12, 1)]


@pytest.mark.parametrize("shape", PASSES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_host_pass_matches_plain(fr, host_lib, shape, reverse):
    B, ns, lanes, stages, cols = shape
    dom = get_domain("BLS12_381", ns.bit_length() - 1)
    y = _fr_elems(fr, (B, ns, lanes), sum(shape))
    brp = torch.as_tensor(bit_reversal_perm(ns))
    for inverse in (False, True):
        tw = dom.packed_twiddles(inverse, "cpu")
        want = ntt_stages_plain(fr, y, tw, brp, stages)
        assert torch.equal(ntt_stages(fr, y, tw, brp, stages), want)
        assert torch.equal(host_pass(host_lib, fr, y, tw, brp, stages, cols,
                                     reverse=reverse), want)


@pytest.mark.parametrize("nthr", [1, 32, 96])
def test_host_pass_any_thread_count(fr, host_lib, nthr):
    """The phases split their work over any number of threads."""
    y = _fr_elems(fr, (2, 32, 4), nthr)
    dom = get_domain("BLS12_381", 5)
    tw, brp = dom.packed_twiddles(False, "cpu"), torch.as_tensor(bit_reversal_perm(32))
    assert torch.equal(host_pass(host_lib, fr, y, tw, brp, 5, 2, nthr=nthr, reverse=True),
                       ntt_stages_plain(fr, y, tw, brp, 5))


def _host_transform(lib, F, dom, y, inverse):
    """NTTDomain._stages with the host pass in place of ntt_stages."""
    ns, L = y.shape[1], y.shape[1].bit_length() - 1
    tw = dom.packed_twiddles(inverse, "cpu")
    k = pass_stages(ns, y.shape[2], F.NL)
    y = host_pass(lib, F, y, tw, dom._brp_index(ns, "cpu"), k)
    for s in range(k, L):
        y = ntt_bfly_plain(F, y, tw[(1 << s) - 1:(2 << s) - 1], 1 << s)
    return y


@pytest.mark.parametrize("log_n", [1, 3, 5, 6])
def test_host_transform_matches_reference(fr, host_lib, log_n):
    """Batched radix-2 transforms of host passes against the JAX package's
    NTTDomain, forward and inverse."""
    n = 1 << log_n
    x = _fr_elems(fr, (3, n), log_n)
    dom, jdom = get_domain("BLS12_381", log_n), jax_get_domain("BLS12_381", log_n)
    xj = jnp.asarray(convert.to_reference(x))
    for inverse, want in ((False, jdom.ntt(xj)), (True, jdom.intt(xj))):
        got = _host_transform(host_lib, fr, dom, x.reshape(3, n, 1, fr.NL), inverse)
        got = dom._scale(got.reshape(3, n, fr.NL), inverse)
        assert torch.equal(got, convert.from_reference(np.asarray(want)))


def test_host_four_step_matches_port(fr, host_lib):
    """The four-step at n = 1024 from host passes equals the port's."""
    dom = get_domain("BLS12_381", 10)
    x = _fr_elems(fr, (1024,), 10)
    for inverse in (False, True):
        n1, n2, twm = dom._four_step_tables(inverse, "cpu")
        y = _host_transform(host_lib, fr, dom, x.reshape(1, n1, n2, fr.NL), inverse)
        y = cuda_ntt.ntt_twm(fr, y.reshape(-1, fr.NL), twm)
        y = y.reshape(n1, n2, fr.NL).transpose(0, 1).contiguous().reshape(1, n2, n1, fr.NL)
        y = dom._scale(_host_transform(host_lib, fr, dom, y, inverse).reshape(-1, fr.NL),
                       inverse)
        assert torch.equal(y, dom.intt(x) if inverse else dom.ntt(x))


def test_pass_plan_launches(fr, monkeypatch):
    """A four-step transform is two ntt_stages launches, a batched radix-2
    transform one, and the 8192 coset transform one and an ntt_bfly: paths
    i / j / k / l's 4 / 5 / 1 / 13 stage launches a call."""
    assert [pass_stages(ns, lanes, fr.NL) for ns, lanes in
            ((64, 64), (64, 128), (128, 64), (128, 1), (64, 1), (8192, 1))] == [6, 6, 7, 7, 6, 12]
    calls = []
    for name in ("ntt_stages", "ntt_bfly"):
        orig = getattr(ntt_mod, name)
        monkeypatch.setattr(ntt_mod, name,
                            lambda *a, _n=name, _f=orig, **k: (calls.append(_n), _f(*a, **k))[1])
    dom = get_domain("BLS12_381", 13)
    x = _fr_elems(fr, (8192,), 13)
    dom.ntt(x)
    assert calls == ["ntt_stages"] * 2
    calls.clear()
    dom.coset_ntt(x, 7)
    assert calls == ["ntt_stages", "ntt_bfly"]
    calls.clear()
    get_domain("BLS12_381", 7).ntt(_fr_elems(fr, (64, 128), 7))
    assert calls == ["ntt_stages"]


def test_pass_wrapper_rejects_bad_input(fr):
    dom = get_domain("BLS12_381", 4)
    y = _fr_elems(fr, (1, 16, 2), 3)
    tw, brp = dom.packed_twiddles(False, "cpu"), torch.as_tensor(bit_reversal_perm(16))
    for args in ((y[0], tw, brp, 4), (y, tw, brp, 5), (y, tw, brp, 0), (y, tw[:6], brp, 4),
                 (y, tw, brp[:8], 4), (y, tw, brp.int(), 4), (y.transpose(1, 2), tw, brp, 1)):
        with pytest.raises(ValueError):
            ntt_stages(fr, *args)
    with pytest.raises(ValueError):
        ntt_stages(fr, _fr_elems(fr, (1, 8192, 2), 1), get_domain("BLS12_381", 13)
                   .packed_twiddles(False, "cpu"), torch.as_tensor(bit_reversal_perm(8192)), 13)
