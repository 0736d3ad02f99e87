"""EIP-2333 BLS12-381 key derivation (the HKDF-mod-r tree), on the host.

Counterpart of ``constantine_tpu/models/eip2333.py``: derive_master_sk,
derive_child_sk and derive_path over ``utils/hashes.py``. There is no batch
axis and nothing for the card: a key is a few thousand SHA-256 calls.
"""

from __future__ import annotations

from ..named.curves import BLS12_381
from ..utils.hashes import hkdf_expand, hkdf_extract, sha256

_R = BLS12_381.r


def _flip_bits(data: bytes) -> bytes:
    return bytes(b ^ 0xFF for b in data)


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes):
    okm = hkdf_expand(hkdf_extract(salt, ikm), b"", 255 * 32)
    return [okm[i * 32:(i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport0 = _ikm_to_lamport_sk(ikm, salt)
    lamport1 = _ikm_to_lamport_sk(_flip_bits(ikm), salt)
    return sha256(b"".join(sha256(x) for x in lamport0 + lamport1))


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    """EIP-2333 hkdf_mod_r: rehash the salt until the key is nonzero mod r."""
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = sha256(salt)
        prk = hkdf_extract(salt, ikm + b"\x00")
        okm = hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % _R
    return sk


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("seed must be >= 32 bytes")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path(seed: bytes, path) -> int:
    """Derive along an EIP-2334-style path (a list of indices)."""
    sk = derive_master_sk(seed)
    for idx in path:
        sk = derive_child_sk(sk, idx)
    return sk
