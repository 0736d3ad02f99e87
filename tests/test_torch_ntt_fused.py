"""K3′ ntt_stages with its factors and transposed store: ``csrc/ntt.cuh``'s
pass built with g++ through ``csrc/ntt_host.cpp``, against the plain pass
(``ntt_stages_plain``: K1's plain product before and after, a transpose),
host ints and the JAX package's NTTDomain.

The pass takes a load factor (the element gathered from (b, row, lane)
times in_fac[row * lanes + lane], or in_fac[0]), a store factor (each
element times the factor of its place in the output, or out_fac[0]) and a
transposed store ((batch, lanes, ns) out): the four-step's column pass
stores its product with the twiddle matrix transposed (the reference's
``ntt_twm``), the last pass stores 1/n, and a coset transform's shift
powers ride on the first pass's load (forward) or the last pass's store
(inverse). ``ctt_host_ntt_stages`` plays every block, in each phase the
block's threads in order or reversed, into a sentinel-filled tile and
output, so a word read before it is written, or never stored, shows. Each
variant runs at the PeerDAS paths' pass shapes and at (1, 256, 256). Whole
transforms of host passes are held against the JAX package's ntt / intt
(four-step at n = 1024 and 4096) and coset_ntt / coset_intt (n = 1024) and
against the port's radix-2 route.
"""

import ctypes
import functools
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
from constantine_tpu_torch.ops.cuda_field import mont_mul_plain
from constantine_tpu_torch.ops.cuda_ntt import ntt_stages, ntt_stages_plain, tile_cols
from constantine_tpu_torch.ops.ntt import get_domain

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "constantine_tpu_torch" / "csrc"
SENTINEL = 0xDEADBEEF
P_ = ctypes.c_void_p
I_ = ctypes.c_int

# name: (load factor period, store factor period, transposed); "n" = ns * lanes
VARIANTS = {"load": ("n", None, False), "store_1": (None, 1, False),
            "store_n": (None, "n", False), "transposed": (None, None, True),
            "column": (None, "n", True), "coset_column": ("n", "n", True),
            "load_1_store_n": (1, "n", False)}
# (batch, ns, lanes): the four-step's passes at 8192 (columns, rows) and 4096
# and the cell iNTT's batched radix-2 pass, at every variant; a wider tile at
# each option alone
CASES = ([(shape, v) for shape in ((1, 64, 128), (1, 128, 64), (1, 64, 64), (128, 64, 1))
          for v in VARIANTS]
         + [((1, 256, 256), v) for v in ("load", "store_1", "store_n", "transposed")])


@pytest.fixture(scope="module")
def fr():
    return get_curve("BLS12_381").fr


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("ntt_fused") / "libntt_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-o", str(out), str(CSRC / "ntt_host.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.ctt_host_ntt_stages.argtypes = [P_] * 6 + [I_, P_] + [I_] * 9 + [ctypes.c_uint32]
    lib.ctt_host_ntt_stages.restype = None
    return lib


def _fr_elems(F, shape, seed):
    """Montgomery Fr tensor of `shape` (..., NL): canonical random limbs
    (the top limb below p's), with 0, 1 and r - 1 first."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    limbs = rng.integers(0, 1 << 32, size=(n, F.NL), dtype=np.uint64).astype(np.uint32)
    limbs[:, -1] %= np.uint32(F.p_int >> (32 * (F.NL - 1)))
    x = lb.to_tensor(limbs)
    x[:3] = F.encode([0, 1, F.p_int - 1])[:n]
    return x.reshape(tuple(shape) + (F.NL,))


def host_pass(lib, F, y, tw, brp, stages, *, in_fac=None, out_fac=None, transposed=False,
              nthr=0, reverse=False):
    """ntt_stages' pass on the host into a sentinel-filled output."""
    B, ns, lanes, NL = y.shape
    x = np.ascontiguousarray(lb.to_numpy(y))
    out = np.full((B, lanes, ns, NL) if transposed else x.shape, SENTINEL, dtype=x.dtype)
    t = np.ascontiguousarray(lb.to_numpy(tw))
    b = np.ascontiguousarray(brp.numpy().astype(np.int64))
    mod = np.ascontiguousarray(F.mod_words)
    fi, fo = (None if f is None else np.ascontiguousarray(lb.to_numpy(f))
              for f in (in_fac, out_fac))
    lib.ctt_host_ntt_stages(mod.ctypes.data, x.ctypes.data, out.ctypes.data, t.ctypes.data,
                            b.ctypes.data, None if fi is None else fi.ctypes.data,
                            1 if fi is None else fi.shape[0],
                            None if fo is None else fo.ctypes.data,
                            1 if fo is None else fo.shape[0], int(transposed), B, ns, lanes,
                            stages, tile_cols(lanes), nthr, int(reverse), SENTINEL)
    assert not (out == SENTINEL).all(-1).any(), "an element was never stored"
    return lb.to_tensor(out)


@functools.lru_cache(maxsize=None)
def _case(shape, variant):
    """Inputs of a full pass at `shape` with the variant's factors, and the
    plain version's output."""
    F = get_curve("BLS12_381").fr
    B, ns, lanes = shape
    stages = ns.bit_length() - 1
    dom = get_domain("BLS12_381", stages)
    ip, op, tr = VARIANTS[variant]
    seed = sum(shape) + len(variant)
    facs = [None if p is None else _fr_elems(F, (ns * lanes if p == "n" else 1,), seed + i)
            for i, p in enumerate((ip, op))]
    args = dict(y=_fr_elems(F, shape, seed), tw=dom.packed_twiddles(variant == "load", "cpu"),
                brp=dom._brp_index(ns, "cpu"), stages=stages, in_fac=facs[0], out_fac=facs[1],
                transposed=tr)
    return args, ntt_stages_plain(F, **args)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[0])) + "-" + c[1])
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_fused_pass_matches_plain(fr, host_lib, case, reverse):
    args, want = _case(*case)
    assert torch.equal(host_pass(host_lib, fr, **args, reverse=reverse), want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_wrapper_takes_the_plain_pass_on_the_cpu(fr, variant):
    """ntt_stages on CPU tensors is the plain version with the same
    factors and store."""
    args, want = _case((2, 16, 4), variant)
    assert torch.equal(ntt_stages(fr, **args), want)


@pytest.mark.parametrize("nthr", [1, 32, 96])
def test_fused_pass_any_thread_count(fr, host_lib, nthr):
    """Every phase, the factors' included, splits its work over any number
    of threads; a pass of fewer stages than ns has, tiles splitting the
    lanes."""
    y = _fr_elems(fr, (2, 32, 4), nthr)
    dom = get_domain("BLS12_381", 5)
    tw, brp = dom.packed_twiddles(True, "cpu"), dom._brp_index(32, "cpu")
    fi, fo = _fr_elems(fr, (128,), nthr + 1), _fr_elems(fr, (128,), nthr + 2)
    for stages in (5, 3):
        got = host_pass(host_lib, fr, y, tw, brp, stages, in_fac=fi, out_fac=fo,
                        transposed=True, nthr=nthr, reverse=True)
        assert torch.equal(got, ntt_stages_plain(fr, y, tw, brp, stages, in_fac=fi, out_fac=fo,
                                                 transposed=True))


def test_factors_are_the_montgomery_products(fr, host_lib):
    """The store factor (the twiddle-matrix product, ntt_twm's) and the load
    factor against host ints: the pass with a factor equals the plain pass
    whose output (or input) was multiplied mod r element by element."""
    B, ns, lanes = 1, 64, 64
    dom = get_domain("BLS12_381", 6)
    tw, brp = dom.packed_twiddles(False, "cpu"), dom._brp_index(ns, "cpu")
    y, t = _fr_elems(fr, (B, ns, lanes), 1), _fr_elems(fr, (ns * lanes,), 2)
    r = fr.p_int
    ts = fr.decode(t.reshape(-1, fr.NL))
    base = fr.decode(ntt_stages_plain(fr, y, tw, brp, 6, transposed=True).reshape(-1, fr.NL))
    got = host_pass(host_lib, fr, y, tw, brp, 6, out_fac=t, transposed=True)
    assert fr.decode(got.reshape(-1, fr.NL)) == [a * b % r for a, b in zip(base, ts)]
    scaled = fr.encode([a * b % r for a, b in zip(fr.decode(y.reshape(-1, fr.NL)), ts)])
    got = host_pass(host_lib, fr, y, tw, brp, 6, in_fac=t)
    assert torch.equal(got, ntt_stages_plain(fr, scaled.reshape(y.shape), tw, brp, 6))


def _host_stages(lib):
    def run(F, y, tw, brp, stages, *, in_fac=None, out_fac=None, transposed=False):
        return host_pass(lib, F, y, tw, brp, stages, in_fac=in_fac, out_fac=out_fac,
                         transposed=transposed, reverse=True)
    return run


def _ref(x):
    return jnp.asarray(convert.to_reference(x))


def _port(a):
    return convert.from_reference(np.asarray(a))


@pytest.mark.parametrize("log_n", [10, 12])
def test_host_four_step_matches_reference(fr, host_lib, log_n, monkeypatch):
    """The four-step of two fused host passes against the JAX package's
    ntt / intt and the port's radix-2 route."""
    n = 1 << log_n
    x = _fr_elems(fr, (n,), 300 + log_n)
    dom, jdom = get_domain("BLS12_381", log_n), jax_get_domain("BLS12_381", log_n)
    monkeypatch.setattr(ntt_mod, "ntt_stages", _host_stages(host_lib))
    radix2 = [dom._transform(x, False), dom._transform(x, True)]
    assert dom._use_four_step(x)
    for inverse, ref in ((False, jdom.ntt), (True, jdom.intt)):
        got = dom.intt(x) if inverse else dom.ntt(x)
        assert torch.equal(got, radix2[inverse])
        assert torch.equal(got, _port(ref(_ref(x))))


def test_host_coset_matches_reference(fr, host_lib, monkeypatch):
    """coset_ntt / coset_intt at n = 1024 through the host passes (the shift
    on the column pass's load, n^-1 s^-k on the row pass's store) against
    the JAX package's and the port's radix-2 route; and back."""
    x = _fr_elems(fr, (1024,), 17)
    dom, jdom = get_domain("BLS12_381", 10), jax_get_domain("BLS12_381", 10)
    monkeypatch.setattr(ntt_mod, "ntt_stages", _host_stages(host_lib))
    radix2 = [dom._transform(x, False, in_fac=dom._coset_factors(7, False, "cpu")),
              dom._transform(x, True, out_fac=dom._coset_factors(7, True, "cpu"))]
    ev = dom.coset_ntt(x, 7)
    assert torch.equal(ev, radix2[0])
    assert torch.equal(ev, _port(jdom.coset_ntt(_ref(x), 7)))
    co = dom.coset_intt(x, 7)
    assert torch.equal(co, radix2[1])
    assert torch.equal(co, _port(jdom.coset_intt(_ref(x), 7)))
    assert torch.equal(dom.coset_intt(ev, 7), x)


def test_coset_factor_tables(fr):
    """s^i forward, n^-1 s^-k inverse, against host ints."""
    dom, r, s = get_domain("BLS12_381", 5), fr.p_int, 7
    fwd = fr.decode(dom._coset_factors(s, False, "cpu"))
    inv = fr.decode(dom._coset_factors(s, True, "cpu"))
    assert fwd == [pow(s, i, r) for i in range(32)]
    assert inv == [pow(32, -1, r) * pow(s, -k, r) % r for k in range(32)]
    n1, n2, twm = dom._four_step_tables(False, "cpu")
    w = dom.omega
    assert fr.decode(twm) == [pow(w, k1 * i2, r) for i2 in range(n2) for k1 in range(n1)]
    assert fr.decode(mont_mul_plain(twm, twm, fr)) == [pow(w, 2 * k1 * i2, r)
                                                       for i2 in range(n2) for k1 in range(n1)]
