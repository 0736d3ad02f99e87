"""EIP-4844 (Deneb) blob commitment.

Counterpart of ``blob_to_polynomial``, ``blob_to_kzg_commitment`` and
``blob_to_kzg_commitment_batch`` in ``constantine_tpu/models/eip4844.py``.
Functions return None on invalid input, as the reference does.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..ops import limbs as lb
from ..utils.serialization import g1_compress_canonical, scalars_from_bytes
from .kzg import KZG, get_kzg
from .trusted_setup import FIELD_ELEMENTS_PER_BLOB

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB


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
