"""The port's EVM precompiles on the CPU: the seven EIP-2537 BLS12-381 entry
points and the SHA-256 and RIPEMD-160 ones.

tests/data/torch_evm_golden.json holds calldata made from a seed
(``golden_inputs``: the recipe) and the JAX package's output for each; a
`slow` test regenerates it (the JAX pairing and MSMs take minutes to
compile on the CPU). The port's bytes must equal the file's, and the host
oracle of ``bls_oracle`` (the EIP's checks, refmath's group law and
MSMs, RFC 9380's maps with [h_eff] clearing) must give the same bytes, or
None, on every entry. The pairing entries are built with a known product.
"""

import contextlib
import functools
import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch.models import evm_precompiles as E
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.utils import refmath as rm
from bls_oracle import (HC, HostFp2, NR, fp_bytes, g1_bytes, g2_bytes, map_to_curve_host,
                        oracle_g1add, oracle_g1msm, oracle_g2add, oracle_g2msm,
                        oracle_map_fp2_to_g2, oracle_map_fp_to_g1, oracle_pairing_inputs_ok)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_evm_golden.json"
ENTRIES = json.loads(GOLDEN.read_text())["entries"]

PORT = {
    "g1add": E.eth_evm_bls12381_g1add, "g1msm": E.eth_evm_bls12381_g1msm,
    "g2add": E.eth_evm_bls12381_g2add, "g2msm": E.eth_evm_bls12381_g2msm,
    "pairingcheck": E.eth_evm_bls12381_pairingcheck,
    "map_fp_to_g1": E.eth_evm_bls12381_map_fp_to_g1,
    "map_fp2_to_g2": E.eth_evm_bls12381_map_fp2_to_g2,
    "sha256": E.eth_evm_sha256, "ripemd160": E.eth_evm_ripemd160,
}
ORACLE = {
    "g1add": oracle_g1add, "g1msm": oracle_g1msm, "g2add": oracle_g2add,
    "g2msm": oracle_g2msm, "map_fp_to_g1": oracle_map_fp_to_g1,
    "map_fp2_to_g2": oracle_map_fp2_to_g2,
    "sha256": lambda d: hashlib.sha256(d).digest(),
}                             # the pairing's products are known, RIPEMD-160 has vectors


# -- the golden inputs ---------------------------------------------------------------


def _points(seed: int):
    """Seeded host points and scalars: G1 and G2 points [k]G, a G1 point on
    the curve outside G1 and a G2 point on the twist outside G2 (an SSWU
    output before clearing)."""
    ctx = get_curve("BLS12_381")
    p, r = ctx.p, ctx.r
    rng = np.random.default_rng(seed)

    def k():
        return int.from_bytes(rng.bytes(32), "big") % (r - 1) + 1

    g1 = [rm.ec_mul(k(), ctx.g, 0, p) for _ in range(5)]
    g2 = [rm.ec2_mul(k(), ctx.g2_aff, (0, 0), NR, p) for _ in range(5)]
    x = next(x for x in range(3, 300) if rm.sqrt_mod(x ** 3 + 4, p) is not None
             and rm.ec_mul(r, (x, rm.sqrt_mod(x ** 3 + 4, p)), 0, p) is not None)
    g1_out = (x, rm.sqrt_mod(x ** 3 + 4, p))
    maps = (HC.G2_ISO_XNUM, HC.G2_ISO_XDEN, HC.G2_ISO_YNUM, HC.G2_ISO_YDEN)
    g2_out = map_to_curve_host(HostFp2(p), (3, 4), HC.G2_SSWU_A, HC.G2_SSWU_B, HC.G2_SSWU_Z,
                               maps)
    scalars = [int.from_bytes(rng.bytes(32), "big") for _ in range(5)]
    return g1, g2, g1_out, g2_out, scalars, rng


def golden_inputs():
    """[(op, calldata, note)]: the golden file's entries, from seeds."""
    ctx = get_curve("BLS12_381")
    p, r = ctx.p, ctx.r
    g1, g2, g1_out, g2_out, sc, rng = _points(2537)
    s32 = [s.to_bytes(32, "big") for s in sc]
    big = (2**256 - 1).to_bytes(32, "big")               # a scalar >= r
    out = []
    P, Q = g1[0], g1[1]
    for note, a, b in (("P + Q", P, Q), ("P + inf", P, None), ("P + P", P, P),
                       ("P + (-P)", P, rm.ec_neg(P, p)),
                       ("a point outside G1 + P (no subgroup check)", g1_out, P)):
        out.append(("g1add", g1_bytes(a) + g1_bytes(b), note))
    H, K = g2[0], g2[1]
    for note, a, b in (("Q + R", H, K), ("inf + R", None, K), ("Q + Q", H, H),
                       ("Q + (-Q)", H, rm.ec2_neg(H, p)),
                       ("a point outside G2 + Q (no subgroup check)", g2_out, H)):
        out.append(("g2add", g2_bytes(a) + g2_bytes(b), note))
    g1pairs = [g1_bytes(q) + s for q, s in zip(g1, s32)]
    g2pairs = [g2_bytes(q) + s for q, s in zip(g2, s32)]
    out += [("g1msm", g1pairs[0], "k = 1"),
            ("g1msm", g1pairs[1] + g1_bytes(g1[2]) + big, "k = 2, a scalar 2^256 - 1"),
            ("g1msm", b"".join(g1pairs[:2]) + g1_bytes(None) + s32[2] + g1_bytes(g1[3]) + big
             + g1pairs[4], "k = 5: an infinity pair and a scalar >= r"),
            ("g2msm", g2pairs[0], "k = 1"),
            ("g2msm", g2pairs[1] + g2_bytes(g2[2]) + big, "k = 2, a scalar 2^256 - 1"),
            ("g2msm", b"".join(g2pairs[:2]) + g2_bytes(None) + s32[2] + g2_bytes(g2[3]) + big
             + g2pairs[4], "k = 5: an infinity pair and a scalar >= r")]
    a, b, c = (int.from_bytes(rng.bytes(32), "big") % r for _ in range(3))
    aG, bH = rm.ec_mul(a, ctx.g, 0, p), rm.ec2_mul(b, ctx.g2_aff, (0, 0), NR, p)
    cH = rm.ec2_mul(c, ctx.g2_aff, (0, 0), NR, p)
    good = g1_bytes(aG) + g2_bytes(bH) + g1_bytes(rm.ec_mul(r - a * b % r, ctx.g, 0, p)) \
        + g2_bytes(ctx.g2_aff)
    bad = g1_bytes(aG) + g2_bytes(bH) + g1_bytes(rm.ec_mul(r - a * b % r - 1, ctx.g, 0, p)) \
        + g2_bytes(ctx.g2_aff)
    out += [("pairingcheck", good, "k = 2, true"), ("pairingcheck", bad, "k = 2, false"),
            ("pairingcheck", good + g1_bytes(None) + g2_bytes(cH),
             "k = 3, true, a pair with G1 at infinity")]
    u = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(3)]
    out += [("map_fp_to_g1", fp_bytes(0), "u = 0"), ("map_fp_to_g1", fp_bytes(u[0]), "seeded"),
            ("map_fp2_to_g2", fp_bytes(0) + fp_bytes(0), "u = 0"),
            ("map_fp2_to_g2", fp_bytes(u[1]) + fp_bytes(u[2]), "seeded")]
    msg = rng.bytes(100)
    out += [("sha256", b"", "empty"), ("sha256", msg, "100 seeded bytes"),
            ("ripemd160", b"", "empty"), ("ripemd160", msg, "100 seeded bytes")]
    # rejections
    out += [("g1add", g1_bytes(P) + g1_bytes(Q)[:-1], "255 bytes"),
            ("g1add", b"\x01" + g1_bytes(P)[1:] + g1_bytes(Q), "a top byte set"),
            ("g1add", fp_bytes(p) + fp_bytes(1) + g1_bytes(Q), "x = p"),
            ("g1add", g1_bytes((P[0], P[1] + 1)) + g1_bytes(Q), "off the curve"),
            ("g2add", g2_bytes(H)[:128] + fp_bytes(p) + g2_bytes(H)[192:] + g2_bytes(K),
             "y.c0 = p"),
            ("g2add", g2_bytes(((H[0][0], H[0][1] + 1), H[1])) + g2_bytes(K), "off the twist"),
            ("g1msm", b"", "empty"), ("g1msm", g1pairs[0][:-1], "159 bytes"),
            ("g1msm", g1pairs[0] + g1_bytes(g1_out) + s32[1], "a point outside G1"),
            ("g2msm", g2pairs[0] + g2_bytes(g2_out) + s32[1], "a point outside G2"),
            ("g2msm", g2pairs[0][:-1], "287 bytes"),
            ("pairingcheck", g1_bytes(g1_out) + g2_bytes(bH), "G1 point outside G1"),
            ("pairingcheck", good[:384] + g1_bytes(aG) + g2_bytes(g2_out),
             "G2 point outside G2"),
            ("pairingcheck", good[:-1], "767 bytes"),
            ("map_fp_to_g1", fp_bytes(p), "u = p"), ("map_fp_to_g1", fp_bytes(1)[1:], "63 bytes"),
            ("map_fp2_to_g2", fp_bytes(1) + fp_bytes(p), "u.c1 = p")]
    return out


@contextlib.contextmanager
def reference_precompiles():
    """The JAX package's precompiles module, its curve machines built with
    the outer jax.jit as the identity: each group operation inside stays the
    package's own jitted op, and the result is the same, but XLA-CPU no
    longer compiles the unrolled subgroup ladders as one program (over an
    hour on an 8-core CPU). On exit the machines' caches are cleared, so no
    machine built so outlives the block."""
    import types
    from constantine_tpu.models import evm_precompiles as J
    from constantine_tpu.models.hash_to_curve import get_h2c as jax_get_h2c
    from constantine_tpu.named.precompute import get_curve as jax_get_curve
    # built outside any trace: their constants' encode reads the host
    jctx = jax_get_curve("BLS12_381")
    jctx.g1, jctx.g2, jax_get_h2c()
    jax_mod = J.jax
    J._g1_machine.cache_clear()
    J._g2_machine.cache_clear()
    J.jax = types.SimpleNamespace(jit=lambda f, **kw: f)
    try:
        J._g1_machine("BLS12_381"), J._g2_machine("BLS12_381")
    finally:
        J.jax = jax_mod
    try:
        yield J
    finally:
        J._g1_machine.cache_clear()
        J._g2_machine.cache_clear()


def reference_outputs(op: str) -> dict:
    """{index: output hex or None} of the golden entries of precompile `op`,
    as the JAX package computes them."""
    name = op if op in ("sha256", "ripemd160") else f"bls12381_{op}"
    with reference_precompiles() as J:
        fn = getattr(J, f"eth_evm_{name}")
        out = {}
        for i, (o, data, _) in enumerate(golden_inputs()):
            if o == op:
                got = fn(data)
                out[i] = None if got is None else got.hex()
    return out


def golden_from_reference() -> dict:
    """The golden file as the JAX package computes it, one process a
    precompile (``python tests/test_torch_evm.py OP``): ~35 min on the CPU,
    the pairing's compile 20 of it. XLA-CPU has crashed compiling the
    pairing and the maps one after the other in one process."""
    inputs = golden_inputs()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    outputs = {}
    for op in dict.fromkeys(op for op, _, _ in inputs):
        run = subprocess.run([sys.executable, __file__, op], cwd=ROOT, env=env,
                             capture_output=True, text=True)
        assert run.returncode == 0, f"{op}: exit {run.returncode}\n{run.stderr[-4000:]}"
        outputs.update({int(i): v for i, v in json.loads(run.stdout.splitlines()[-1]).items()})
    entries = [{"op": op, "note": note, "input": data.hex(), "output": outputs[i]}
               for i, (op, data, note) in enumerate(inputs)]
    return {"recipe": "tests/test_torch_evm.py golden_inputs(): numpy default_rng(2537); outputs "
                      "from constantine_tpu.models.evm_precompiles, one process a precompile "
                      "(golden_from_reference())",
            "entries": entries}


def _ids():
    return [f"{i}-{e['op']}-{e['note']}" for i, e in enumerate(ENTRIES)]


@functools.lru_cache(maxsize=None)
def port_output(i):
    """Golden entry i through the port on the CPU, once a process (the tests
    of one entry may run in different workers)."""
    e = ENTRIES[i]
    return PORT[e["op"]](bytes.fromhex(e["input"]), device="cpu")


# -- the golden file and the oracle ----------------------------------------------------------


def test_golden_inputs_are_the_files():
    want = golden_inputs()
    assert [(e["op"], bytes.fromhex(e["input"]), e["note"]) for e in ENTRIES] == want


@pytest.mark.parametrize("i", range(len(ENTRIES)), ids=_ids())
def test_port_matches_golden(i):
    got = port_output(i)
    assert (None if got is None else got.hex()) == ENTRIES[i]["output"]


@pytest.mark.parametrize("i", [i for i, e in enumerate(ENTRIES) if ORACLE.get(e["op"])],
                         ids=[n for n, e in zip(_ids(), ENTRIES) if ORACLE.get(e["op"])])
def test_port_matches_oracle(i):
    e = ENTRIES[i]
    assert port_output(i) == ORACLE[e["op"]](bytes.fromhex(e["input"]))


def test_pairing_entries_are_known():
    """The pairing entries' products are known by construction: the valid
    ones pass the oracle's input checks and give 1, 0, 1; the rejected ones
    fail them."""
    pe = [e for e in ENTRIES if e["op"] == "pairingcheck"]
    ok = [oracle_pairing_inputs_ok(bytes.fromhex(e["input"])) for e in pe]
    assert ok == [True, True, True, False, False, False]
    assert [e["output"] for e in pe[:3]] == [(1).to_bytes(32, "big").hex(),
                                            bytes(32).hex(), (1).to_bytes(32, "big").hex()]


def test_ripemd160_vectors():
    """The RIPEMD-160 designers' test vectors, left-padded to 32 bytes."""
    vectors = {b"": "9c1185a5c5e9fc54612808977ee8f548b2258d31",
               b"abc": "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc",
               b"message digest": "5d0689ef49d2fae572b881b123a85ffa21595f36",
               b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq":
               "12a053384a9c0c88e405a06c27dcf49ada62eb2b",
               b"1234567890" * 8: "9b752e45573d4b39f4dbd3323cab82bf63326bfb"}
    for msg, want in vectors.items():
        assert E.eth_evm_ripemd160(msg, device="cpu") == bytes(12) + bytes.fromhex(want)


# -- rejections, infinity and dispatch -------------------------------------------------------


def test_every_rejection_is_none():
    """The golden file's entries after the hashes are rejections: None in
    the file and from the port; the ones before are not, and an on-curve
    point outside the subgroup is among them for both adds."""
    first = next(i for i, e in enumerate(ENTRIES) if e["note"] == "255 bytes")
    assert all(e["output"] is None for e in ENTRIES[first:])
    assert all(e["output"] is not None for e in ENTRIES[:first])
    assert all(port_output(i) is None for i in range(first, len(ENTRIES)))
    adds = [i for i, e in enumerate(ENTRIES) if "no subgroup check" in e["note"]]
    assert len(adds) == 2 and all(port_output(i) is not None for i in adds)


def test_more_rejections():
    """Branches the golden file leaves out: lengths, the top 16 bytes of each
    coordinate, infinity encodings with one coordinate set."""
    ctx = get_curve("BLS12_381")
    g1, g2, _, _, _, _ = _points(7)
    P, Q = g1_bytes(g1[0]), g2_bytes(g2[0])
    assert E.eth_evm_bls12381_g1add(P + P + b"\x00", device="cpu") is None
    assert E.eth_evm_bls12381_g2add(Q, device="cpu") is None
    for j in (0, 15):                                  # a set byte among the top 16 of y
        bad = bytearray(P)
        bad[64 + j] = 1
        assert E.eth_evm_bls12381_g1add(bytes(bad) + P, device="cpu") is None
        bad = bytearray(Q)
        bad[192 + j] = 1
        assert E.eth_evm_bls12381_g2add(Q + bytes(bad), device="cpu") is None
    # (0, 1) and (x = 0, y = nonzero) are not infinity and not on the curve
    assert E.eth_evm_bls12381_g1add(fp_bytes(0) + fp_bytes(1) + P, device="cpu") is None
    assert E.eth_evm_bls12381_g2add(bytes(192) + fp_bytes(1) + Q, device="cpu") is None
    assert E.eth_evm_bls12381_g2msm(b"", device="cpu") is None
    assert E.eth_evm_bls12381_pairingcheck(b"", device="cpu") is None
    assert E.eth_evm_bls12381_map_fp2_to_g2(fp_bytes(1), device="cpu") is None
    assert E.eth_evm_bls12381_g1msm(P + (ctx.r).to_bytes(32, "big"), device="cpu") == \
        bytes(128)                                      # [r]P is infinity


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert len(PORT) == 9
    for op, fn in PORT.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda", op
        with pytest.raises(RuntimeError, match="cuda"):
            fn(b"")


@pytest.mark.slow
def test_regenerate_golden_from_reference():
    """The JAX package's outputs on the golden inputs equal the file."""
    assert golden_from_reference() == json.loads(GOLDEN.read_text())


if __name__ == "__main__":
    # python tests/test_torch_evm.py OP: one JSON line, the JAX package's
    # outputs on OP's golden entries; --write: regenerate the golden file
    import conftest  # noqa: F401  (XLA's flags and the CPU backend, before jax loads)
    if sys.argv[1] == "--write":
        GOLDEN.write_text(json.dumps(golden_from_reference(), indent=1))
    else:
        print(json.dumps(reference_outputs(sys.argv[1])))
