"""EIP-4844 proving and verification in the port, on the CPU.

Against the JAX package: G1 decompression (K13's plain version, with the
host flag rules) and its subgroup bit, also against the host reference
[r]P == infinity; eval_at and compute_quotient at an off-domain and an
in-domain z; the Fiat-Shamir challenge bytes.

The verify entry points run on a linear-polynomial oracle that needs no
MSM: p(X) = a + bX has the blob e_i = a + b w_i (brp order), the commitment
[a]G1 + [b][tau]G1 ([tau]G1 is the setup's monomial G1 point 1) and, at any
z, y = a + bz and the proof [b]G1. The full-size proofs (the golden file
tests/data/torch_kzg_proof_golden.json, made by the JAX package) and the
JAX verify on the oracle's inputs are `slow`.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu_torch import convert
from constantine_tpu_torch.models import eip4844
from constantine_tpu_torch.models.kzg import KZG
from constantine_tpu_torch.models.trusted_setup import DEFAULT_SETUP, KZGSettings
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops import limbs as lb
from constantine_tpu_torch.ops.cuda_g1 import get_cuda_g1
from constantine_tpu_torch.ops.ntt import bit_reversal_perm
from constantine_tpu_torch.utils import refmath as rm
from constantine_tpu_torch.utils import serialization as ser

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROOF_GOLDEN = ROOT / "tests" / "data" / "torch_kzg_proof_golden.json"
INF = bytes([0xC0]) + bytes(47)


def _be(v: int) -> bytes:
    return v.to_bytes(32, "big")


@pytest.fixture(scope="module")
def env():
    ctx = get_curve("BLS12_381")
    kzg = KZG(KZGSettings(device="cpu"), precompute=False)
    tokens = Path(DEFAULT_SETUP).read_text().split()
    tau_g1 = ser.g1_decompress_host(bytes.fromhex(tokens[2 + 4096 + 65 + 1]))[0][0]
    return ctx, kzg, tau_g1


def oracle(env, a: int, b: int):
    """(blob, commitment, proof) of p(X) = a + bX."""
    ctx, _, tau_g1 = env
    p, r = ctx.p, ctx.r
    w = ctx.root_of_unity(12)
    blob = b"".join(_be((a + b * pow(w, int(i), r)) % r) for i in bit_reversal_perm(4096))
    C = rm.ec_add(rm.ec_mul(a, ctx.g, 0, p), rm.ec_mul(b, tau_g1, 0, p), 0, p)
    return blob, ser.g1_compress_affine(C), ser.g1_compress_affine(rm.ec_mul(b, ctx.g, 0, p))


# -- against the JAX package ------------------------------------------------------


def _g1_cases(ctx):
    """Compressed G1 encodings: points of G1 with both signs, an on-curve
    point outside G1, a non-square x, infinity, and bad flags."""
    p = ctx.p
    pts = [rm.ec_mul(k, ctx.g, 0, p) for k in (1, 2, 3, 1234567)]
    out = [ser.g1_compress_affine(q) for q in pts]
    out.append(ser.g1_compress_affine(rm.ec_neg(pts[1], p)))
    rng = np.random.default_rng(13)
    while True:
        x = int.from_bytes(rng.bytes(48), "big") % p
        y = rm.sqrt_mod(x ** 3 + 4, p)
        if y is not None:
            break
    assert rm.ec_mul(ctx.r, (x, y), 0, p) is not None          # outside G1
    out.append(ser.g1_compress_affine((x, y)))
    x_nsq = next(x for x in range(5, 100) if rm.sqrt_mod(x ** 3 + 4, p) is None)
    out.append(ser.g1_compress_affine((x_nsq, 0)))
    out.append(INF)
    bad = bytearray(out[0])
    bad[0] &= 0x7F                                               # not compressed
    out.append(bytes(bad))
    out.append(bytes([0xE0]) + bytes(47))                        # infinity with sign
    return b"".join(out)


def test_g1_decompression_matches_reference_and_host(env):
    """Host flags + K13 (plain) against the JAX codec with the subgroup
    check, and K13's subgroup bit against [r]P == infinity on the host."""
    from constantine_tpu.utils.serialization import get_codec
    ctx, kzg, _ = env
    data = _g1_cases(ctx)
    x, sign, inf, host_ok = ser.parse_g1_host(data)
    (xm, y), ok = get_cuda_g1().decompress(lb.to_tensor(x), torch.as_tensor(sign))
    valid = host_ok & (inf | ok.numpy())
    (jx, jy), jinf, jvalid = get_codec().g1_decompress(data, subgroup_check=True)
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert valid.tolist() == [True] * 5 + [False, False, True, False, False]
    assert inf.tolist() == np.asarray(jinf).tolist()
    fin = valid & ~inf
    assert np.array_equal(convert.to_reference(y)[fin], np.asarray(jy)[fin])
    assert np.array_equal(convert.to_reference(xm)[fin], np.asarray(jx)[fin])
    pts, _, _ = ser.g1_decompress_host(data[:7 * 48])             # on-curve lanes
    on_curve = [q for q in pts if q is not None]
    in_g1 = [rm.ec_mul(ctx.r, q, 0, ctx.p) is None for q in on_curve]
    assert ok[:6].tolist() == in_g1


@pytest.fixture(scope="module")
def evals(env):
    rng = np.random.default_rng(21)
    ctx = env[0]
    return [int.from_bytes(rng.bytes(32), "big") % ctx.r for _ in range(4096)]


@pytest.mark.parametrize("where", ["off", "in"])
def test_eval_at_and_quotient_match_reference(env, evals, where):
    from constantine_tpu.models.kzg import get_kzg as jax_get_kzg
    ctx, kzg, _ = env
    fr = ctx.fr
    z = 2 ** 200 + 12345 if where == "off" else pow(ctx.root_of_unity(12), 77, ctx.r)
    jk = jax_get_kzg()
    je = jnp.asarray(jk.fr.encode(evals))
    jz = jnp.asarray(jk.fr.encode([z])[0])
    pe, pz = fr.encode(evals), fr.encode(z)
    y, hit, in_dom = kzg.eval_at(pe, pz)
    q, y2 = kzg.compute_quotient(pe, pz)
    jq, jy = jk.compute_quotient(je, jz)             # jy is the JAX eval_at's y
    assert np.array_equal(convert.to_reference(y), np.asarray(jy))
    assert np.array_equal(convert.to_reference(q), np.asarray(jq))
    assert torch.equal(y, y2)
    assert bool(hit) == (where == "in")
    assert in_dom.nonzero().flatten().tolist() == (
        [int(np.flatnonzero(bit_reversal_perm(4096) == 77)[0])] if where == "in" else [])


def test_challenges_match_reference(env):
    from constantine_tpu.models import eip4844 as jax_eip4844
    ctx, _, _ = env
    rng = np.random.default_rng(5)
    blob = rng.bytes(eip4844.BYTES_PER_BLOB)
    c = ser.g1_compress_affine(rm.ec_mul(99, ctx.g, 0, ctx.p))
    z = eip4844.compute_challenge(blob, c)
    jz = ctx.fr.decode(convert.from_reference(np.asarray(
        jax_eip4844.compute_challenge(blob, c))))
    assert _be(z) == _be(jz)
    assert eip4844.hash_to_bls_field(b"abc") == ctx.fr.decode(convert.from_reference(
        np.asarray(jax_eip4844.hash_to_bls_field(b"abc"))))
    # the batch transcript, as the reference writes it inline
    # (constantine_tpu/models/eip4844.py:317-325)
    p2 = ser.g1_compress_affine(rm.ec_mul(7, ctx.g, 0, ctx.p))
    data = (jax_eip4844.RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + (4096).to_bytes(8, "big")
            + (2).to_bytes(8, "big") + blob + c + p2 + blob + p2 + c)
    want = int.from_bytes(hashlib.sha256(data).digest(), "big") % ctx.r
    assert eip4844.compute_batch_challenge([blob, blob], [c, p2], [p2, c]) == want


# -- the verify entry points on the oracle ------------------------------------------


def test_verify_kzg_proof_on_oracle(env):
    ctx, kzg, _ = env
    a, b, z = 12345, 678910, 2 ** 200 + 12345
    _, C, P = oracle(env, a, b)
    y = (a + b * z) % ctx.r
    assert eip4844.verify_kzg_proof(C, _be(z), _be(y), P, kzg) is True
    assert eip4844.verify_kzg_proof(C, _be(z), _be((y + 1) % ctx.r), P, kzg) is False


def test_verify_malformed_inputs_are_none(env):
    ctx, kzg, _ = env
    blob, C, P = oracle(env, 1, 2)
    z, y = _be(5), _be(11)
    bad_flag = bytes([C[0] & 0x7F]) + C[1:]
    assert eip4844.verify_kzg_proof(bad_flag, z, y, P, kzg) is None
    assert eip4844.verify_kzg_proof(C[:47], z, y, P, kzg) is None
    assert eip4844.verify_kzg_proof(C, _be(ctx.r), y, P, kzg) is None        # z >= r
    assert eip4844.verify_kzg_proof(C, z, y[:31], P, kzg) is None
    assert eip4844.verify_blob_kzg_proof(blob[:-1], C, P, kzg) is None
    assert eip4844.verify_blob_kzg_proof(blob, C, P + b"\x00", kzg) is None
    assert eip4844.verify_blob_kzg_proof_batch([blob], [C], [], kzg) is None
    assert eip4844.verify_blob_kzg_proof_batch([], [], [], kzg) is True
    assert eip4844.compute_kzg_proof(blob, _be(ctx.r), kzg) is None
    assert eip4844.compute_blob_kzg_proof(blob, bad_flag, kzg) is None
    outside = _g1_cases(ctx)[5 * 48:6 * 48]                   # on the curve, not in G1
    assert eip4844.verify_kzg_proof(C, z, y, outside, kzg) is None


def test_verify_blob_kzg_proof_on_oracle(env):
    _, kzg, _ = env
    blob, C, P = oracle(env, 31337, 4242)
    assert eip4844.verify_blob_kzg_proof(blob, C, P, kzg) is True


def test_verify_batch_on_oracle_and_the_f1_batch(env):
    """Two valid openings pass. The F1 batch (a nonzero blob, C = infinity,
    P = [y/z]G1 at its challenge z, y = p(z)) is rejected here, while the
    JAX package's verify_blob_kzg_proof_batch returns True on exactly this
    input: it masks the rhs MSM's scalars where the commitment, not the
    proof, is infinity (ROADMAP.md queue 3, F1)."""
    ctx, kzg, _ = env
    r = ctx.r
    b1, C1, P1 = oracle(env, 5, 6)
    b2, C2, P2 = oracle(env, 7, 8)
    assert eip4844.verify_blob_kzg_proof_batch([b1, b2], [C1, C2], [P1, P2], kzg) is True
    zf = eip4844.compute_challenge(b1, INF)
    yf = (5 + 6 * zf) % r
    Pf = ser.g1_compress_affine(rm.ec_mul(yf * pow(zf, -1, r) % r, ctx.g, 0, ctx.p))
    assert eip4844.verify_blob_kzg_proof_batch([b1], [INF], [Pf], kzg) is False


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    blob, z = bytes(eip4844.BYTES_PER_BLOB), _be(5)
    for call in (lambda: eip4844.compute_kzg_proof(blob, z),
                 lambda: eip4844.compute_blob_kzg_proof(blob, INF),
                 lambda: eip4844.verify_kzg_proof(INF, z, z, INF),
                 lambda: eip4844.verify_blob_kzg_proof(blob, INF, INF),
                 lambda: eip4844.verify_blob_kzg_proof_batch([blob], [INF], [INF])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# -- slow: full size, and the JAX package itself -------------------------------------


def _dense_blob(seed: int) -> bytes:
    """tests/test_torch_eip4844.py:dense_blob."""
    rng = np.random.default_rng(seed)
    r = get_curve("BLS12_381").r
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


@pytest.mark.slow
def test_full_proofs_on_cpu_match_golden():
    golden = json.loads(PROOF_GOLDEN.read_text())
    kzg = KZG(KZGSettings(device="cpu"))
    for entry in golden["blobs"]:
        blob = _dense_blob(entry["seed"])
        for k, z in golden["z"].items():
            proof, y = eip4844.compute_kzg_proof(blob, _be(int(z, 16)), kzg)
            assert (proof.hex(), y.hex()) == (entry[f"proof_{k}"], entry[f"y_{k}"])
        C = bytes.fromhex(entry["commitment"])
        assert eip4844.compute_blob_kzg_proof(blob, C, kzg).hex() == entry["blob_proof"]


@pytest.mark.slow
def test_proof_golden_file_matches_reference_package():
    assert _reference_proofs() == json.loads(PROOF_GOLDEN.read_text())


def _reference_proofs():
    from constantine_tpu.models import eip4844 as jax_eip4844
    golden = json.loads(PROOF_GOLDEN.read_text())
    kzg_golden = json.loads((ROOT / "tests" / "data" / "torch_kzg_golden.json").read_text())
    ctx = get_curve("BLS12_381")
    zs = {"off": 2 ** 200 + 12345, "in": pow(ctx.root_of_unity(12), 5, ctx.r)}
    out = {"recipe": golden["recipe"], "z": {k: hex(v) for k, v in zs.items()}, "blobs": []}
    for e in kzg_golden["blobs"]:
        blob = _dense_blob(e["seed"])
        ent = {"seed": e["seed"], "commitment": e["commitment"]}
        for k, z in zs.items():
            proof, y = jax_eip4844.compute_kzg_proof(blob, _be(z))
            ent[f"proof_{k}"], ent[f"y_{k}"] = proof.hex(), y.hex()
        ent["blob_proof"] = jax_eip4844.compute_blob_kzg_proof(
            blob, bytes.fromhex(e["commitment"])).hex()
        out["blobs"].append(ent)
    return out


@pytest.mark.slow
def test_reference_verify_agrees_on_oracle_except_f1(env):
    """The JAX package's verify (its CPU route) on the oracle's inputs: the
    same answers as the port, except on the F1 batch, where it says True."""
    from constantine_tpu.models import eip4844 as jax_eip4844
    ctx, _, _ = env
    r = ctx.r
    a, b, z = 12345, 678910, 2 ** 200 + 12345
    b1, C1, P1 = oracle(env, a, b)
    y = (a + b * z) % r
    assert jax_eip4844.verify_kzg_proof(C1, _be(z), _be(y), P1) is True
    assert jax_eip4844.verify_kzg_proof(C1, _be(z), _be((y + 1) % r), P1) is False
    zf = eip4844.compute_challenge(b1, INF)
    Pf = ser.g1_compress_affine(rm.ec_mul((a + b * zf) * pow(zf, -1, r) % r, ctx.g, 0, ctx.p))
    assert jax_eip4844.verify_blob_kzg_proof_batch([b1], [INF], [Pf]) is True
