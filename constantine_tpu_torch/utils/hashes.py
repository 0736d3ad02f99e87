"""Host hashing for BLS signatures, hash-to-curve and EIP-2333: SHA-256
(the standard library's ``hashlib``), HMAC-SHA-256 (RFC 2104) and HKDF
(RFC 5869). The slice of ``constantine_tpu/utils/hashes.py`` these callers
use; the messages are a few hundred bytes, so they stay on the host."""

from __future__ import annotations

import hashlib
import hmac


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac_sha256(salt, ikm)


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out, t = b"", b""
    i = 1
    while len(out) < length:
        t = hmac_sha256(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:length]
