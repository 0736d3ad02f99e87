"""The port's BLS signatures (BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_) on
the CPU: the golden file, the G1/G2 codec, the seven entry points' accept
and reject cases, and EIP-2333.

tests/data/torch_bls_golden.json was made by the JAX package: hash_to_g2 of
four messages (the empty one first) and the pubkeys and signatures of four
(sk, msg) pairs. The port's bytes must equal it, and a host big-int oracle
(``bls_oracle``: RFC 9380 and refmath ladders) checks the same
entries; a `slow` test regenerates it from the JAX package (its hash_to_g2
takes minutes to compile on the CPU). Other inputs come from seeds with
numpy, their signatures from the host oracle.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch.models import bls_signatures as bls_mod
from constantine_tpu_torch.models import eip2333
from constantine_tpu_torch.models.bls_signatures import DST, get_bls
from constantine_tpu_torch.models.hash_to_curve import get_h2c
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.utils import refmath as rm
from constantine_tpu_torch.utils.serialization import get_codec
from bls_oracle import (INF_G1, INF_G2, NR, g2_compress_host, host_pubkeys, host_sign,
                        oracle_hash_to_g2)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_bls_golden.json"


# -- inputs and host helpers --------------------------------------------------------


def golden_inputs():
    """The golden file's messages and (sk, msg) pairs, from seeds."""
    r = get_curve("BLS12_381").r
    rng = np.random.default_rng(61)
    h2g2_msgs = [b"", b"abc", b"abcdef0123456789", rng.bytes(32)]
    rng = np.random.default_rng(62)
    sks = [1] + [int.from_bytes(rng.bytes(32), "big") % r for _ in range(3)]
    return h2g2_msgs, sks, [rng.bytes(32) for _ in range(4)]


def golden_from_reference() -> dict:
    """The golden entries as the JAX package computes them (minutes on the CPU)."""
    from constantine_tpu.models.bls_signatures import get_bls as jax_get_bls
    from constantine_tpu.models.hash_to_curve import get_h2c as jax_get_h2c
    h2g2_msgs, sks, msgs = golden_inputs()
    jbls, jh2c = jax_get_bls(), jax_get_h2c()
    (x, y), inf = jbls.ctx.g2.to_affine(jh2c.hash_to_g2(h2g2_msgs, DST))
    assert not np.asarray(inf).any()
    xs, ys = jh2c.fp2.decode(x), jh2c.fp2.decode(y)
    pks, sigs = jbls.derive_pubkeys(sks), jbls.sign(sks, msgs)
    return {
        "dst": DST.decode(),
        "hash_to_g2": [{"msg": m.hex(), "x": [hex(c) for c in xv], "y": [hex(c) for c in yv]}
                       for m, xv, yv in zip(h2g2_msgs, xs, ys)],
        "pairs": [{"sk": hex(k), "msg": m.hex(), "pubkey": pks[48 * i:48 * i + 48].hex(),
                   "signature": sigs[96 * i:96 * i + 96].hex()}
                  for i, (k, m) in enumerate(zip(sks, msgs))],
    }


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def bls():
    return get_bls("cpu")


@pytest.fixture(scope="module")
def pairs(golden):
    """sks, msgs, concatenated pubkeys and signatures of the golden pairs."""
    g = golden["pairs"]
    return ([int(e["sk"], 16) for e in g], [bytes.fromhex(e["msg"]) for e in g],
            b"".join(bytes.fromhex(e["pubkey"]) for e in g),
            b"".join(bytes.fromhex(e["signature"]) for e in g))


def _sig(sigs, i):
    return sigs[96 * i:96 * i + 96]


def _pk(pks, i):
    return pks[48 * i:48 * i + 48]


# -- the golden file -------------------------------------------------------------------


def test_golden_inputs_are_the_files(golden):
    h2g2_msgs, sks, msgs = golden_inputs()
    assert golden["dst"] == DST.decode()
    assert [bytes.fromhex(e["msg"]) for e in golden["hash_to_g2"]] == h2g2_msgs
    assert [(int(e["sk"], 16), bytes.fromhex(e["msg"])) for e in golden["pairs"]] == \
        list(zip(sks, msgs))


def test_hash_to_g2_matches_golden(bls, golden):
    ctx = bls.ctx
    entries = golden["hash_to_g2"]
    (x, y), inf = bls._hash([bytes.fromhex(e["msg"]) for e in entries])
    fp2 = ctx.g2.F
    xs, ys = fp2.decode(x), fp2.decode(y)
    for i, e in enumerate(entries):
        assert [hex(v) for v in xs[2 * i:2 * i + 2]] == e["x"]
        assert [hex(v) for v in ys[2 * i:2 * i + 2]] == e["y"]
    assert not inf.any()


def test_pubkeys_and_signatures_match_golden(bls, pairs):
    sks, msgs, pks, sigs = pairs
    got_pks = bls.derive_pubkeys(sks)
    assert got_pks == pks
    assert got_pks[:48].hex().startswith("97f1d3a73197d794")       # sk = 1: G1
    assert bls.sign(sks, msgs) == sigs


def test_golden_against_host_oracle(golden, pairs):
    for e in golden["hash_to_g2"]:
        (x0, x1), (y0, y1) = oracle_hash_to_g2(bytes.fromhex(e["msg"]))
        assert e["x"] == [hex(x0), hex(x1)] and e["y"] == [hex(y0), hex(y1)]
    sks, msgs, pks, sigs = pairs
    assert host_pubkeys(sks) == pks
    assert host_sign(sks, msgs) == sigs


@pytest.mark.slow
def test_golden_file_regenerates_from_reference(golden):
    assert golden_from_reference() == golden


def test_sign_rejects_invalid_keys(bls):
    r = bls.ctx.r
    assert bls.sign([0], [b"m"]) is None
    assert bls.sign([5, r], [b"m", b"n"]) is None


# -- the codec -------------------------------------------------------------------------


def _cube_root_fp2(c, p):
    """A cube root of c in Fp2 (None if c is no cube): q - 1 = 9 t', so c^e
    for e = 3^-1 mod t' is a root up to a 9th root of unity."""
    q = p * p
    if rm.fp2_pow(c, (q - 1) // 3, NR, p) != (1, 0):
        return None
    t = (q - 1) // 9
    x = rm.fp2_pow(c, pow(3, -1, t), NR, p)
    g = next(z for z in ((2, 1), (3, 1), (1, 2), (5, 3))
             if rm.fp2_pow(z, (q - 1) // 3, NR, p) != (1, 0))
    zeta = rm.fp2_pow(g, t, NR, p)
    for _ in range(9):
        if rm.fp2_pow(x, 3, NR, p) == c:
            return x
        x = rm.fp2_mul(x, zeta, NR, p)
    return None


def _twist_point_with_real_y(ctx):
    """An on-curve E'(Fp2) point with y.c1 = 0 (y = (y0, 0), x^3 = y0^2 - b')."""
    p, b2 = ctx.p, ctx.g2_b()
    for y0 in range(2, 200):
        x = _cube_root_fp2(rm.fp2_sub((y0 * y0 % p, 0), b2, p), p)
        if x is not None:
            return (x, (y0, 0))
    raise AssertionError("no point with y.c1 = 0 found")


def test_g2_codec(bls, pairs):
    """Round trip, infinity, a missing compression flag, x >= p in either
    coordinate, x off the curve, a point outside G2, and the sign rule on a
    y with c1 = 0 (both signs), in one batch."""
    ctx, codec = bls.ctx, get_codec()
    p = ctx.p
    sigs = pairs[3]
    good = [_sig(sigs, i) for i in range(4)]
    no_flag = bytes([good[0][0] & 0x7F]) + good[0][1:]
    x1_big = bytes([0x80 | 0x1F]) + b"\xff" * 47 + good[0][48:]
    x0_big = good[0][:48] + (p + 5).to_bytes(48, "big")
    off = next(x for x in range(1, 50)
               if rm.fp2_sqrt(rm.fp2_add((x ** 3 % p, 0), ctx.g2_b(), p), NR, p) is None)
    off_curve = bytes([0x80]) + bytes(47) + off.to_bytes(48, "big")
    real = _twist_point_with_real_y(ctx)
    neg_real = (real[0], rm.fp2_neg(real[1], p))
    inf_bad = bytes([0xE0]) + bytes(95)                      # infinity with the sign bit
    data = good + [INF_G2, no_flag, x1_big, x0_big, off_curve, g2_compress_host(real),
                   g2_compress_host(neg_real), inf_bad]
    (x, y), inf, valid = codec.g2_decompress(b"".join(data), "cpu")
    assert inf.tolist() == [False] * 4 + [True] + [False] * 6 + [True]
    # the real-y points are on the twist but (whp) outside G2
    assert rm.ec2_mul(ctx.r, real, (0, 0), NR, p) is not None
    assert valid.tolist() == [True] * 5 + [False] * 7
    (_, y_nocheck), _, valid_nocheck = codec.g2_decompress(b"".join(data[9:11]), "cpu",
                                                         subgroup_check=False)
    assert valid_nocheck.tolist() == [True, True]
    fp2 = ctx.g2.F
    assert fp2.decode(y_nocheck) == [real[1][0], 0, neg_real[1][0], 0]
    assert codec.g2_compress((x[:4], y[:4])) == b"".join(good)
    assert codec.g2_compress((x[:5], y[:5]), inf[:5]) == b"".join(good) + INF_G2
    with pytest.raises(ValueError, match="multiple of 96"):
        codec.g2_decompress(good[0][:95], "cpu")


def test_g1_codec(bls, pairs):
    """K13's plain version through the codec: round trip, infinity, a bad
    flag and an infinity with a nonzero x."""
    codec = get_codec()
    pks = pairs[2]
    no_flag = bytes([pks[0] & 0x7F]) + pks[1:48]
    inf_x = bytes([0xC0]) + bytes(46) + b"\x01"
    (x, y), inf, valid = codec.g1_decompress(pks + INF_G1 + no_flag + inf_x, "cpu")
    assert inf.tolist() == [False] * 4 + [True, False, True]
    assert valid.tolist() == [True] * 5 + [False, False]
    assert codec.g1_compress((x[:4], y[:4])) == pks
    assert codec.g1_compress((x[:5], y[:5]), inf[:5]) == pks + INF_G1


# -- the entry points (tests/test_signatures.py:23-66 and the smoke's cases) -----------


def test_verify_accept_and_reject(bls, pairs):
    """One batch: valid lanes, an altered message, two swapped signatures, a
    bad flag, x >= p, a signature outside G2, and a pubkey at infinity."""
    ctx = bls.ctx
    sks, msgs, pks, sigs = pairs
    outside = g2_compress_host(_twist_point_with_real_y(ctx))
    lanes = [
        (0, msgs[0], _sig(sigs, 0)),                        # valid
        (1, b"altered", _sig(sigs, 1)),                     # altered message
        (2, msgs[2], _sig(sigs, 3)), (3, msgs[3], _sig(sigs, 2)),   # swapped
        (1, msgs[1], bytes([sigs[96] & 0x7F]) + _sig(sigs, 1)[1:]),  # bad flag
        (1, msgs[1], _sig(sigs, 1)[:48] + (ctx.p + 1).to_bytes(48, "big")),  # x >= p
        (1, msgs[1], outside),                              # outside G2
        (None, msgs[0], _sig(sigs, 0)),                     # pubkey at infinity
    ]
    pk_bytes = b"".join(INF_G1 if i is None else _pk(pks, i) for i, _, _ in lanes)
    ok = bls.verify(pk_bytes, [m for _, m, _ in lanes], b"".join(s for _, _, s in lanes))
    assert ok.tolist() == [True] + [False] * 7
    assert bls.verify(pks, msgs, sigs[:-1]).tolist() == [False] * 4
    assert bls.verify(b"", [], b"").tolist() == []


@pytest.fixture(scope="module")
def committee():
    """Three keys sign one message (host oracle): pubkeys, message, the
    three signatures and their aggregate."""
    sks, msg = [11, 22, 33], b"same message"
    return host_pubkeys(sks), msg, host_sign(sks, [msg] * 3), host_sign([sum(sks)], [msg])


def test_aggregate_signatures_and_fast_aggregate_verify(bls, committee):
    """The aggregate equals the host's and verifies under the pubkeys; a
    pubkey at infinity, no pubkeys or a malformed signature reject."""
    pks, msg, sigs, want = committee
    agg = bls.aggregate_signatures(sigs)
    assert agg == want
    assert bls.fast_aggregate_verify(pks, msg, agg) is True
    assert bls.fast_aggregate_verify(pks[:96] + INF_G1, msg, agg) is False
    assert bls.fast_aggregate_verify(b"", msg, agg) is False
    assert bls.aggregate_signatures(b"") is None
    assert bls.aggregate_signatures(sigs[:96] + bytes([sigs[96] & 0x7F]) + sigs[97:]) is None


@pytest.mark.slow
def test_fast_aggregate_verify_rejects_another_message(bls, committee):
    pks, msg, _, agg = committee
    assert bls.fast_aggregate_verify(pks, b"other", agg) is False


def test_aggregate_verify(bls, pairs):
    sks, msgs, pks, sigs = pairs
    agg = bls.aggregate_signatures(sigs)
    assert len(agg) == 96
    assert bls.aggregate_verify(pks, msgs, agg) is True
    assert bls.aggregate_verify(pks, [msgs[0], b"changed"] + msgs[2:], agg) is False
    assert bls.aggregate_verify(pks, msgs, agg[:95]) is False


@pytest.mark.slow
def test_batch_verify(bls, pairs):
    """Fixed blinding True, a replaced signature False, os.urandom blinding
    True (each call runs the 128-bit G1 and G2 ladders: the heaviest on the
    CPU)."""
    sks, msgs, pks, sigs = pairs
    seed = b"\x05" * 32
    assert bls.batch_verify(pks, msgs, sigs, secure_blinding=seed) is True
    replaced = sigs[:96] + host_sign([99], [msgs[1]]) + sigs[192:]
    assert bls.batch_verify(pks, msgs, replaced, secure_blinding=seed) is False
    assert bls.batch_verify(pks, msgs, sigs) is True
    assert bls.batch_verify(pks, msgs, sigs[:-96]) is False


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    sig, pk = INF_G2, INF_G1
    for call in (lambda: bls_mod.derive_pubkeys([1]),
                 lambda: bls_mod.sign([1], [b"m"]),
                 lambda: bls_mod.verify(pk, [b"m"], sig),
                 lambda: bls_mod.aggregate_signatures(sig),
                 lambda: bls_mod.fast_aggregate_verify(pk, b"m", sig),
                 lambda: bls_mod.aggregate_verify(pk, [b"m"], sig),
                 lambda: bls_mod.batch_verify(pk, [b"m"], sig),
                 lambda: get_bls(),
                 lambda: get_h2c().hash_to_g1([b"m"], DST),
                 lambda: get_h2c().hash_to_g2([b"m"], DST)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_bls_context_loads_no_trusted_setup():
    code = ("import sys; from constantine_tpu_torch.models.bls_signatures import get_bls; "
            "get_bls('cpu'); mods = [m for m in sys.modules if 'trusted_setup' in m "
            "or m.endswith('.kzg')]; print(mods); sys.exit(1 if mods else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- EIP-2333 ---------------------------------------------------------------------------


def test_eip2333_matches_reference():
    from constantine_tpu.models import eip2333 as jax_eip2333
    seed = bytes.fromhex(
        "c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e5349553"
        "1f09a6987599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04")
    m = eip2333.derive_master_sk(seed)
    assert m == 6083874454709270928345386274498605044986640685124978867557563392430687146096
    assert eip2333.derive_child_sk(m, 0) == \
        20397789859736650942317412262472558107875392172444076792671091975210932703118
    seed2 = np.random.default_rng(71).bytes(32)
    for s in (seed, seed2):
        assert eip2333.derive_path(s, [12381, 3600, 0]) == \
            jax_eip2333.derive_path(s, [12381, 3600, 0])
    assert eip2333.hkdf_mod_r(b"x" * 32, b"info") == jax_eip2333.hkdf_mod_r(b"x" * 32, b"info")
    with pytest.raises(ValueError):
        eip2333.derive_master_sk(b"short")
