"""EIP-4844 (Deneb) KZG: commitments, proofs and their verification.

Counterpart of ``constantine_tpu/models/eip4844.py``: ``blob_to_polynomial``,
``blob_to_kzg_commitment``, ``blob_to_kzg_commitment_batch``,
``hash_to_bls_field``, ``compute_challenge``, ``compute_kzg_proof``,
``compute_blob_kzg_proof``, ``verify_kzg_proof``, ``verify_blob_kzg_proof``
and ``verify_blob_kzg_proof_batch``, with the Fiat-Shamir transcripts of the
consensus spec byte for byte. Functions return None on invalid input, as
the reference does. Every entry point runs on `device` (default the card),
or on ``kzg.device`` when a context is given; the verifies have one route on
both devices (``models/verify_fused.py``).

Every caller derives the blob challenge through ``compute_challenge`` (the
reference re-derives it inline in its fused verifies).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..device import resolve_device
from ..named.curves import BLS12_381
from ..ops import limbs as lb
from ..utils.serialization import (g1_compress_canonical, parse_g1_host, parse_scalar_host,
                                   scalars_from_bytes)
from .kzg import KZG, get_kzg
from .trusted_setup import FIELD_ELEMENTS_PER_BLOB
from .verify_fused import get_verifier

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB
BYTES_PER_G1 = 48
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
_R = BLS12_381.r


def blob_to_polynomial(blob: bytes):
    """Blob -> (canonical Fr limbs (4096, 8) u32, valid). The blob is the
    evaluation form in brp order; every 32-byte chunk must be < r."""
    if blob is None or len(blob) != BYTES_PER_BLOB:
        return None, False
    limbs, valid = scalars_from_bytes(blob)
    return limbs, bool(valid.all())


def blob_to_kzg_commitment(blob: bytes, kzg: KZG = None, device="cuda"):
    """-> 48-byte commitment, or None on an invalid blob.

    Runs on `device` (default the card), or on `kzg.device` when a context
    is given.
    """
    dev = kzg.device if kzg is not None else resolve_device(device)
    poly, ok = blob_to_polynomial(blob)
    if not ok:
        return None
    kzg = kzg or get_kzg(dev)
    xc, big, inf = KZG.unpack_export(kzg.commit_export(lb.to_tensor(poly, dev)))
    return g1_compress_canonical(xc, big, inf)


def blob_to_kzg_commitment_batch(blobs, kzg: KZG = None, device="cuda"):
    """B blobs -> B 48-byte commitments in one pipeline and one copy back.

    Returns [] for no blobs and None if any blob is invalid. Runs on
    `device` (default the card), or on `kzg.device` when a context is given.
    """
    dev = kzg.device if kzg is not None else resolve_device(device)
    polys = []
    for blob in blobs:
        poly, ok = blob_to_polynomial(blob)
        if not ok:
            return None
        polys.append(poly)
    if not polys:
        return []
    kzg = kzg or get_kzg(dev)
    xc, big, inf = KZG.unpack_export(kzg.commit_batch_export(lb.to_tensor(np.stack(polys), dev)))
    out = g1_compress_canonical(xc, big, inf)
    return [out[48 * i:48 * (i + 1)] for i in range(len(polys))]


def _context(kzg, device):
    return kzg or get_kzg(resolve_device(device))


# -- Fiat-Shamir ----------------------------------------------------------------


def hash_to_bls_field(data: bytes) -> int:
    """sha256(data) read big-endian, mod r."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % _R


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    """The blob's evaluation point: hash_to_bls_field(domain || degree as 16
    big-endian bytes || blob || commitment)."""
    return hash_to_bls_field(FIAT_SHAMIR_PROTOCOL_DOMAIN
                             + FIELD_ELEMENTS_PER_BLOB.to_bytes(16, "big") + blob + commitment)


def compute_batch_challenge(blobs, commitments, proofs) -> int:
    """The batch's random r: domain || degree (8 bytes) || n (8 bytes) ||
    every blob, commitment and proof in turn."""
    data = (RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + FIELD_ELEMENTS_PER_BLOB.to_bytes(8, "big")
            + len(blobs).to_bytes(8, "big"))
    for blob, c, p in zip(blobs, commitments, proofs):
        data += blob + c + p
    return hash_to_bls_field(data)


def _scalar_limbs(v: int) -> np.ndarray:
    return lb.int_to_limbs(v, 8)


# -- proofs -------------------------------------------------------------------------


def _g1_bytes_valid(kzg, data: bytes) -> bool:
    """A commitment or proof encoding: flags and range on the host, then
    is-square and the subgroup in K13 (infinity needs no device check)."""
    if data is None or len(data) != BYTES_PER_G1:
        return False
    parsed = parse_g1_host(data)
    if not parsed[3].all():
        return False
    if parsed[2].all():
        return True
    _, ok = get_verifier(kzg).decompress(*parsed[:3])
    return bool(ok.all())


def _prove(kzg, poly, z_limbs):
    fr = kzg.fr
    dev = kzg.device
    packed = kzg.prove_export(fr.to_mont(lb.to_tensor(poly, dev)),
                              fr.to_mont(lb.to_tensor(z_limbs, dev)))
    arr = lb.to_numpy(packed)
    xc, big, inf = KZG.unpack_export(packed[:1])
    return g1_compress_canonical(xc, big, inf), lb.limbs_to_bytes_be(arr[1:, :fr.NL], 32)


def compute_kzg_proof(blob: bytes, z_bytes: bytes, kzg: KZG = None, device="cuda"):
    """-> (48-byte proof, 32-byte y = p(z)), or None on invalid input."""
    kzg = _context(kzg, device)
    poly, ok = blob_to_polynomial(blob)
    if not ok:
        return None
    z, ok = parse_scalar_host(z_bytes)
    if not ok:
        return None
    return _prove(kzg, poly, z)


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, kzg: KZG = None,
                           device="cuda"):
    """-> 48-byte proof at the blob's challenge, or None on invalid input."""
    kzg = _context(kzg, device)
    poly, ok = blob_to_polynomial(blob)
    if not ok or not _g1_bytes_valid(kzg, commitment_bytes):
        return None
    return _prove(kzg, poly, _scalar_limbs(compute_challenge(blob, commitment_bytes)))[0]


# -- verification ----------------------------------------------------------------


def verify_kzg_proof(commitment_bytes: bytes, z_bytes: bytes, y_bytes: bytes,
                     proof_bytes: bytes, kzg: KZG = None, device="cuda"):
    """e(C - [y]G1, G2) == e(proof, [tau]G2 - [z]G2): True or False, or None
    on malformed input."""
    kzg = _context(kzg, device)
    if (commitment_bytes is None or len(commitment_bytes) != BYTES_PER_G1
            or proof_bytes is None or len(proof_bytes) != BYTES_PER_G1):
        return None
    c, p = parse_g1_host(commitment_bytes), parse_g1_host(proof_bytes)
    z, ok1 = parse_scalar_host(z_bytes)
    y, ok2 = parse_scalar_host(y_bytes)
    if not (ok1 and ok2 and c[3].all() and p[3].all()):
        return None
    return get_verifier(kzg).verify(c, p, z, y)


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, proof_bytes: bytes,
                          kzg: KZG = None, device="cuda"):
    """The proof of the blob at its challenge: True or False, or None on
    malformed input."""
    kzg = _context(kzg, device)
    poly, ok = blob_to_polynomial(blob)
    if (not ok or commitment_bytes is None or len(commitment_bytes) != BYTES_PER_G1
            or proof_bytes is None or len(proof_bytes) != BYTES_PER_G1):
        return None
    c, p = parse_g1_host(commitment_bytes), parse_g1_host(proof_bytes)
    if not (c[3].all() and p[3].all()):
        return None
    z = _scalar_limbs(compute_challenge(blob, commitment_bytes))
    return get_verifier(kzg).verify_blob(poly, c, p, z)


def verify_blob_kzg_proof_batch(blobs, commitments, proofs, kzg: KZG = None, device="cuda"):
    """n blob proofs by one random linear combination: True or False, or
    None on malformed input; True for no blobs."""
    if not len(blobs) == len(commitments) == len(proofs):
        return None
    if len(blobs) == 0:
        return True
    kzg = _context(kzg, device)
    if any(p is None or len(p) != BYTES_PER_G1 for p in proofs):
        return None
    polys, zs = [], []
    for blob, c in zip(blobs, commitments):
        poly, ok = blob_to_polynomial(blob)
        if not ok or c is None or len(c) != BYTES_PER_G1:
            return None
        polys.append(poly)
        zs.append(_scalar_limbs(compute_challenge(blob, c)))
    cp, pp = parse_g1_host(b"".join(commitments)), parse_g1_host(b"".join(proofs))
    if not (cp[3].all() and pp[3].all()):
        return None
    r = compute_batch_challenge(blobs, commitments, proofs)
    r_powers = [pow(r, i, _R) for i in range(len(blobs))]
    return get_verifier(kzg).verify_batch(polys, zs, cp, pp, r_powers)
