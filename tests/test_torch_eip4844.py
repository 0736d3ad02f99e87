"""Port setup loading, carry-over and blob_to_kzg_commitment.

The full 4096-point commitment runs on the card in chip_smoke.py; here on
the CPU it is `slow`, as is regenerating the golden commitments with the
JAX package (tests/data/torch_kzg_golden.json, which chip_smoke.py also
checks the card against).
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from constantine_tpu_torch import convert
from constantine_tpu_torch.models import eip4844
from constantine_tpu_torch.models.kzg import KZG, get_kzg
from constantine_tpu_torch.models.trusted_setup import DEFAULT_SETUP, KZGSettings
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.ops.ntt import bit_reversal_perm
from constantine_tpu_torch.utils import refmath as rm
from constantine_tpu_torch.utils import serialization as ser

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_kzg_golden.json"


def dense_blob(seed: int) -> bytes:
    """4096 canonical field elements from numpy's generator (same recipe in
    chip_smoke.py; the golden file keeps each blob's sha256)."""
    rng = np.random.default_rng(seed)
    r = get_curve("BLS12_381").r
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


@pytest.fixture(scope="module")
def settings():
    return KZGSettings(device="cpu")


def test_setup_loader_matches_reference_cache(settings):
    x, y = convert.load_npz_lagrange()
    assert torch.equal(settings.g1_lagrange_brp[0], x)
    assert torch.equal(settings.g1_lagrange_brp[1], y)


def test_setup_points_are_on_curve_and_brp_ordered(settings):
    """Lane i of the loaded setup is file point brp(i), parsed here on its
    own: the count of G1 points, the count of G2 points, then the G1 hex."""
    ctx = settings.ctx
    tokens = Path(DEFAULT_SETUP).read_text().split()
    assert int(tokens[0]) == 4096
    brp = bit_reversal_perm(4096)
    lanes = (0, 1, 2, 4095)
    pts, _, ok = ser.g1_decompress_host(bytes.fromhex("".join(tokens[2 + brp[i]] for i in lanes)))
    assert ok.all()
    x, y = settings.g1_lagrange_brp
    for i, q in zip(lanes, pts):
        assert (ctx.fp.decode(x[i]), ctx.fp.decode(y[i])) == q
        assert rm.ec_is_on_curve(q, 0, 4, ctx.p)


def test_g1_codec_round_trip():
    ctx = get_curve("BLS12_381")
    pts = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in (1, 2, 3, 12345)] + [None]
    data = b"".join(ser.g1_compress_affine(q) for q in pts)
    back, inf, valid = ser.g1_decompress_host(data)
    assert back == pts and valid.all() and list(inf) == [False] * 4 + [True]
    xs = np.stack([ctx.fp.from_int(q[0]).numpy().view(np.uint32) for q in pts[:4]]
                  + [np.zeros(12, np.uint32)])
    big = np.array([q[1] >= (ctx.p + 1) // 2 for q in pts[:4]] + [False])
    assert ser.g1_compress_canonical(xs, big, inf) == data
    bad = bytearray(data[:48])
    bad[0] &= 0x7F                                    # compression flag cleared
    assert not ser.g1_decompress_host(bytes(bad))[2][0]
    with pytest.raises(ValueError):
        ser.g1_decompress_host(data[:47])


def test_blob_to_polynomial_rejects_non_canonical():
    r = get_curve("BLS12_381").r
    blob = bytearray(eip4844.BYTES_PER_BLOB)
    assert eip4844.blob_to_polynomial(bytes(blob))[1]
    blob[32 * 7: 32 * 8] = r.to_bytes(32, "big")
    poly, ok = eip4844.blob_to_polynomial(bytes(blob))
    assert not ok and poly.shape == (4096, 8)
    assert eip4844.blob_to_kzg_commitment(bytes(blob), device="cpu") is None
    assert eip4844.blob_to_kzg_commitment(b"\x00" * 31, device="cpu") is None


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        eip4844.blob_to_kzg_commitment(bytes(eip4844.BYTES_PER_BLOB))
    with pytest.raises(RuntimeError, match="cuda"):
        KZGSettings()


def test_commitment_batch_of_no_blobs_is_empty_and_invalid_is_none():
    r = get_curve("BLS12_381").r
    assert eip4844.blob_to_kzg_commitment_batch([], device="cpu") == []
    bad = bytearray(eip4844.BYTES_PER_BLOB)
    bad[32 * 4095:] = r.to_bytes(32, "big")
    zero = bytes(eip4844.BYTES_PER_BLOB)
    assert eip4844.blob_to_kzg_commitment_batch([zero, bytes(bad)], device="cpu") is None
    assert eip4844.blob_to_kzg_commitment_batch([zero, zero[:-1]], device="cpu") is None


def test_batch_and_kzg_context_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        eip4844.blob_to_kzg_commitment_batch([bytes(eip4844.BYTES_PER_BLOB)])
    for precompute in (True, False):
        with pytest.raises(RuntimeError, match="cuda"):
            get_kzg(precompute=precompute)


@pytest.mark.slow
def test_online_commit_and_batch_on_cpu_match_golden(settings):
    """KZG(precompute=False), the online MSM with GLV, and 2-blob batches
    (through the fixed-base tables, and one online MSM a blob) reproduce
    the golden commitments."""
    golden = json.loads(GOLDEN.read_text())
    blobs = [dense_blob(e["seed"]) for e in golden["blobs"]]
    want = [bytes.fromhex(e["commitment"]) for e in golden["blobs"]]
    online = KZG(settings, precompute=False)
    assert [eip4844.blob_to_kzg_commitment(b, online) for b in blobs] == want
    assert eip4844.blob_to_kzg_commitment_batch(blobs, KZG(settings)) == want
    assert eip4844.blob_to_kzg_commitment_batch(blobs, online) == want


@pytest.mark.slow
def test_full_commitments_on_cpu_match_golden_and_host(settings):
    kzg = KZG(settings)
    golden = json.loads(GOLDEN.read_text())
    for entry in golden["blobs"]:
        blob = dense_blob(entry["seed"])
        assert hashlib.sha256(blob).hexdigest() == entry["blob_sha256"]
        assert eip4844.blob_to_kzg_commitment(blob, kzg).hex() == entry["commitment"]
    assert eip4844.blob_to_kzg_commitment(bytes(eip4844.BYTES_PER_BLOB), kzg) == \
        bytes([0xC0]) + bytes(47)


@pytest.mark.slow
def test_golden_file_matches_reference_package():
    from constantine_tpu.models import eip4844 as jax_eip4844
    golden = json.loads(GOLDEN.read_text())
    for entry in golden["blobs"]:
        blob = dense_blob(entry["seed"])
        assert hashlib.sha256(blob).hexdigest() == entry["blob_sha256"]
        assert jax_eip4844.blob_to_kzg_commitment(blob).hex() == entry["commitment"]


def test_default_setup_path_is_the_reference_data_file():
    assert Path(DEFAULT_SETUP).is_file()
    assert Path(DEFAULT_SETUP).parent.parent.name == "constantine_tpu"
