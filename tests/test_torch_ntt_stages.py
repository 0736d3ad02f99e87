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
the first 12 of 13 stages of a radix-2 transform of 8192, tiles that split
the lanes, and a pass of fewer stages than ns has. Whole transforms made of
host passes (and ntt_bfly for a stage left over) are held against the JAX
package's at small n, forward and inverse, with 0, 1 and r - 1 among the
inputs, and the two fused host passes of the four-step against the port's
at n = 1024. The pass plan: a four-step or coset transform is two
ntt_stages launches and nothing else. The pass's factors and transposed
store are held in tests/test_torch_ntt_fused.py.
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
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops import ntt as ntt_mod
from constantine_tpu_torch.ops.cuda_ntt import ntt_stages, ntt_stages_plain, pass_stages, tile_cols
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
    lib.ctt_host_ntt_stages.argtypes = [P_] * 6 + [I_, P_] + [I_] * 9 + [ctypes.c_uint32]
    lib.ctt_host_ntt_stages.restype = None
    return lib


def _fr_elems(F, shape, seed):
    """Montgomery Fr tensor of `shape` (..., NL), with 0, 1 and r - 1 first."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    xs = [int.from_bytes(rng.bytes(32), "big") % F.p_int for _ in range(n)]
    xs[:3] = [0, 1, F.p_int - 1][:n]
    return F.encode(xs).reshape(tuple(shape) + (F.NL,))


def host_pass(lib, F, y, tw, brp, stages, cols=None, nthr=0, reverse=False, in_fac=None,
              out_fac=None, transposed=False):
    """ntt_stages' pass on the host into a sentinel-filled output."""
    B, ns, lanes, NL = y.shape
    cols = tile_cols(lanes) if cols is None else cols
    x = np.ascontiguousarray(lb.to_numpy(y))
    out = np.full((B, lanes, ns, NL) if transposed else x.shape, SENTINEL, dtype=x.dtype)
    t = np.ascontiguousarray(lb.to_numpy(tw))
    b = np.ascontiguousarray(brp.numpy().astype(np.int64))
    mod = np.ascontiguousarray(F.mod_words)
    facs = [None if f is None else np.ascontiguousarray(lb.to_numpy(f))
            for f in (in_fac, out_fac)]
    lib.ctt_host_ntt_stages(mod.ctypes.data, x.ctypes.data, out.ctypes.data, t.ctypes.data,
                            b.ctypes.data,
                            None if facs[0] is None else facs[0].ctypes.data,
                            1 if facs[0] is None else facs[0].shape[0],
                            None if facs[1] is None else facs[1].ctypes.data,
                            1 if facs[1] is None else facs[1].shape[0], int(transposed),
                            B, ns, lanes, stages, cols, nthr, int(reverse), SENTINEL)
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


def _host_stages(lib):
    """ntt_stages with the host pass in its place."""
    def run(F, y, tw, brp, stages, *, in_fac=None, out_fac=None, transposed=False):
        return host_pass(lib, F, y, tw, brp, stages, in_fac=in_fac, out_fac=out_fac,
                         transposed=transposed, reverse=True)
    return run


@pytest.mark.parametrize("log_n", [1, 3, 5, 6])
def test_host_transform_matches_reference(fr, host_lib, log_n, monkeypatch):
    """Batched radix-2 transforms of host passes (1/n on the inverse's
    store) against the JAX package's NTTDomain, forward and inverse."""
    monkeypatch.setattr(ntt_mod, "ntt_stages", _host_stages(host_lib))
    n = 1 << log_n
    x = _fr_elems(fr, (3, n), log_n)
    dom, jdom = get_domain("BLS12_381", log_n), jax_get_domain("BLS12_381", log_n)
    xj = jnp.asarray(convert.to_reference(x))
    for inverse, want in ((False, jdom.ntt(xj)), (True, jdom.intt(xj))):
        got = dom.intt(x) if inverse else dom.ntt(x)
        assert torch.equal(got, convert.from_reference(np.asarray(want)))


def test_host_four_step_matches_port(fr, host_lib, monkeypatch):
    """The four-step at n = 1024 from its two fused host passes (the column
    pass's twiddle matrix and transposed store, the row pass's 1/n) equals
    the port's plain route."""
    dom = get_domain("BLS12_381", 10)
    x = _fr_elems(fr, (1024,), 10)
    want = [dom.ntt(x), dom.intt(x)]
    monkeypatch.setattr(ntt_mod, "ntt_stages", _host_stages(host_lib))
    for inverse in (False, True):
        assert torch.equal(dom.intt(x) if inverse else dom.ntt(x), want[inverse])


def _plan(monkeypatch, fr, fn):
    """The kernel calls fn makes through ops/ntt.py: ntt_stages (with its
    factors and store), ntt_bfly and K1 products (Field.mul, Field.prod),
    each stubbed to return zeros of its output's shape."""
    calls = []

    def stages(F, y, tw, brp, stages, *, in_fac=None, out_fac=None, transposed=False):
        calls.append(("ntt_stages", in_fac is not None, out_fac is not None, transposed))
        B, ns, lanes, NL = y.shape
        return y.new_zeros((B, lanes, ns, NL) if transposed else y.shape)

    def k1(*factors, **kw):
        calls.append(("mont_mul",))
        return torch.zeros(torch.broadcast_shapes(*(f.shape for f in factors)),
                           dtype=torch.int32)

    monkeypatch.setattr(ntt_mod, "ntt_stages", stages)
    monkeypatch.setattr(ntt_mod, "ntt_bfly", lambda F, y, *a, **k: (calls.append(("ntt_bfly",)),
                                                                      y)[1])
    monkeypatch.setattr(fr, "mul", k1)
    monkeypatch.setattr(fr, "prod", k1)
    fn()
    return calls


def test_pass_plan_launches(fr, monkeypatch):
    """A four-step transform is two ntt_stages launches and nothing else:
    the column pass (twiddle matrix, transposed) and the row pass (1/n on
    the inverse); a coset transform of 8192 the same two, the shift on the
    column pass's load (forward) or the row pass's store (inverse); a
    batched radix-2 transform one pass, 1/n on its store; a radix-2
    transform too long for a tile one pass, ntt_bfly for the stages left,
    and a K1 product for the inverse's factor; above the four-step's tile
    limit (2^22 at 8 limbs) a 2-D input takes the radix-2 route."""
    assert [pass_stages(ns, lanes, fr.NL) for ns, lanes in
            ((64, 64), (64, 128), (128, 64), (128, 1), (64, 1), (8192, 1))] == [6, 6, 7, 7, 6, 12]
    dom = get_domain("BLS12_381", 13)
    x = _fr_elems(fr, (8192,), 13)
    col, row = ("ntt_stages", False, True, True), ("ntt_stages", False, False, False)
    row_f = ("ntt_stages", False, True, False)
    col_s = ("ntt_stages", True, True, True)
    for fn, want in ((lambda: dom.ntt(x), [col, row]), (lambda: dom.intt(x), [col, row_f]),
                     (lambda: dom.coset_ntt(x, 7), [col_s, row]),
                     (lambda: dom.coset_intt(x, 7), [col, row_f])):
        assert _plan(monkeypatch, fr, fn) == want
    xb = x.reshape(1, 8192, fr.NL)
    left = [("ntt_stages", False, False, False), ("ntt_bfly",)]
    assert _plan(monkeypatch, fr, lambda: dom.ntt(xb)) == left
    assert _plan(monkeypatch, fr, lambda: dom.intt(xb)) == left + [("mont_mul",)]
    assert _plan(monkeypatch, fr, lambda: dom.coset_ntt(xb, 7)) == [
        ("ntt_stages", True, False, False), ("ntt_bfly",)]
    assert _plan(monkeypatch, fr, lambda: dom.coset_intt(xb, 7)) == left + [("mont_mul",)]
    cells = _fr_elems(fr, (128, 64), 6)
    d6 = get_domain("BLS12_381", 6)
    assert _plan(monkeypatch, fr, lambda: d6.ntt(cells)) == [("ntt_stages", False, False, False)]
    assert _plan(monkeypatch, fr, lambda: d6.intt(cells)) == [("ntt_stages", False, True, False)]
    assert ntt_mod.four_step_split(22, fr.NL) == (2048, 2048)
    assert ntt_mod.four_step_split(23, fr.NL) is None
    for log_n, four in ((16, True), (22, True), (23, False), (24, False)):
        big = object.__new__(ntt_mod.NTTDomain)         # the route only: no tables
        big.F, big.log_n, big.n = fr, log_n, 1 << log_n
        assert big._use_four_step(torch.empty(0, fr.NL)) == four


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
