"""Ethereum BLS signatures over BLS12-381, batched:
BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_ (pubkeys in G1, signatures in
G2, the Ethereum DST).

Counterpart of ``constantine_tpu/models/bls_signatures.py``: the same entry
points, arguments and results (bytes, a numpy bool array, a bool or None),
plus ``device=`` (default the card; "cpu" runs every kernel's plain
version). The kernels on the path:

- K1 (``mont_prod``) for every Fp product of the Fp2/Fp12 glue: SSWU, the
  Fp2 root, the isogeny, the G2 ladders, psi, the codec;
- K3 ``ec_scalar_mul`` for the G1 ladders (``derive_pubkeys``, 255 bits;
  ``batch_verify``'s blinded pubkeys, 128 bits), K3 add for the pubkey sums;
- K9 for the inversions (Fp2 through its norm);
- K11 and K12 for the pairings, K13 for every pubkey's decompression.

``sign`` multiplies by the GLS-4 split on every device: the digit
decomposition, four ~67-bit ladders of ``G2Group.scalar_mul`` as one batch
and the adds that sum them, which read nothing back to the host and branch
on no data. Nothing here loads the KZG trusted setup.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..device import resolve_device
from ..named.precompute import get_curve
from ..ops import limbs as lb
from ..ops.glv import scalar_mul_gls4_g2
from ..ops.pairing import get_pairing
from ..utils.hashes import sha256
from ..utils.serialization import g1_compress_canonical, get_codec
from .hash_to_curve import get_h2c

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


class BLSSignatures:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.ctx = get_curve("BLS12_381")
        self.codec = get_codec()
        self.h2c = get_h2c()
        self.pr = get_pairing("BLS12_381")
        gx, gy = (t.to(self.device) for t in self.ctx.g1_gen)
        self._g1 = (gx, gy, self.ctx.fp.neg(gy))          # G1 and -G1, (1, NL)

    def _hash(self, msgs):
        """H(m) for every message, affine: ((x, y), inf)."""
        return self.ctx.g2.to_affine(self.h2c.hash_to_g2(list(msgs), DST, self.device))

    def _with_g1(self, px, py, hx, hy, sx, sy):
        """The pairs [P_i, -G1 (k times)] x [H_i, S_j], k = len(sx)."""
        gx, _, ngy = self._g1
        k = sx.shape[0]
        P = (torch.cat([px, gx.expand(k, -1)]), torch.cat([py, ngy.expand(k, -1)]))
        return P, (torch.cat([hx, sx]), torch.cat([hy, sy]))

    # -- keys ------------------------------------------------------------------

    def derive_pubkeys(self, secret_keys) -> bytes:
        """Python ints -> n*48 bytes of compressed G1 pubkeys [sk]G1 (one
        ec_scalar_mul launch over the batch)."""
        g1 = self.ctx.g1
        n = len(secret_keys)
        k = self.ctx.scalars_to_limbs(secret_keys, self.device)
        gx, gy, _ = self._g1
        P = g1.scalar_mul(k, g1.from_affine((gx.expand(n, -1), gy.expand(n, -1))),
                          scalar_bits=255)
        (xc, yc), inf = g1.to_affine(P, canonical=True)
        return g1_compress_canonical(lb.to_numpy(xc),
                                     self.codec._is_big(yc).cpu().numpy(), inf.cpu().numpy())

    # -- core sign / verify ------------------------------------------------------

    def sign(self, secret_keys, msgs):
        """sig_i = [sk_i] H(m_i): n*96 bytes of compressed G2 signatures, or
        None if any secret key is 0 or >= r (the reference's rejection)."""
        ctx = self.ctx
        if any(sk <= 0 or sk >= ctx.r for sk in secret_keys):
            return None
        (hx, hy), h_inf = self._hash(msgs)
        S = scalar_mul_gls4_g2(ctx, ctx.scalars_to_limbs(secret_keys, self.device), (hx, hy))
        g2 = ctx.g2
        S = g2.select(h_inf, g2.infinity(h_inf.shape, self.device), S)
        (x, y), inf = g2.to_affine(S)
        return self.codec.g2_compress((x, y), inf)

    def verify(self, pubkeys: bytes, msgs, signatures: bytes):
        """e(pk_i, H(m_i)) == e(G1, sig_i) for each triple: an (n,) bool
        array, False also for malformed or infinity inputs. 2n Miller loops
        (K11), n final exponentiations (K12)."""
        n = len(msgs)
        if n == 0 or len(pubkeys) != 48 * n or len(signatures) != 96 * n:
            return np.zeros(n, dtype=bool)
        (pkx, pky), pk_inf, pk_ok = self.codec.g1_decompress(pubkeys, self.device)
        (sx, sy), s_inf, s_ok = self.codec.g2_decompress(signatures, self.device)
        (hx, hy), _ = self._hash(msgs)
        pr, fp12 = self.pr, self.pr.fp12
        P, Q = self._with_g1(pkx, pky, hx, hy, sx, sy)
        fs = pr.miller_loop(P, Q)
        gt = pr.final_exp(fp12.mul(fs[:n], fs[n:]))
        ok = fp12.eq(gt, fp12.one((n,), gt.device)).cpu().numpy()
        return ok & pk_ok & s_ok & ~pk_inf & ~s_inf

    def aggregate_signatures(self, signatures: bytes):
        """The sum of n G2 signatures, 96 bytes; None if one is malformed."""
        if len(signatures) == 0 or len(signatures) % 96:
            return None
        (sx, sy), s_inf, s_ok = self.codec.g2_decompress(signatures, self.device)
        if not s_ok.all():
            return None
        g2 = self.ctx.g2
        S = g2.from_affine((sx, sy), inf_mask=torch.from_numpy(s_inf).to(self.device))
        agg = _tree_sum_points(g2, S)
        (x, y), inf = g2.to_affine(tuple(t[None] for t in agg))
        return self.codec.g2_compress((x, y), inf)

    def fast_aggregate_verify(self, pubkeys: bytes, msg: bytes, signature: bytes) -> bool:
        """n pubkeys, one message, one aggregate signature: the pubkeys'
        sum (K3 adds) verified as one pubkey."""
        if len(pubkeys) == 0:
            return False
        (px, py), p_inf, p_ok = self.codec.g1_decompress(pubkeys, self.device)
        if not p_ok.all() or p_inf.any():
            return False
        g1 = self.ctx.g1
        agg = _tree_sum_points(g1, g1.from_affine((px, py)))
        (ax, ay), a_inf = g1.to_affine(tuple(t[None] for t in agg))
        if bool(a_inf[0]):
            return False
        return bool(self.verify(self.codec.g1_compress((ax, ay)), [msg], signature)[0])

    def aggregate_verify(self, pubkeys: bytes, msgs, signature: bytes) -> bool:
        """n pubkeys, n messages, one aggregate signature:
        prod_i e(pk_i, H(m_i)) == e(G1, sig), one (n + 1)-pair check."""
        n = len(msgs)
        if n == 0 or len(pubkeys) != 48 * n or len(signature) != 96:
            return False
        (px, py), p_inf, p_ok = self.codec.g1_decompress(pubkeys, self.device)
        (sx, sy), s_inf, s_ok = self.codec.g2_decompress(signature, self.device)
        if not (p_ok.all() and s_ok.all()) or p_inf.any() or s_inf.any():
            return False
        (hx, hy), _ = self._hash(msgs)
        return self.pr.pairing_check(*self._with_g1(px, py, hx, hy, sx, sy))

    def batch_verify(self, pubkeys: bytes, msgs, signatures: bytes,
                     secure_blinding: bytes = None) -> bool:
        """n independent triples in one check with 128-bit blinding b_i:
        prod_i e([b_i]pk_i, H(m_i)) * e(-G1, sum_i [b_i]sig_i) == 1. The
        blinding comes from `secure_blinding`, or os.urandom when it is None."""
        ctx = self.ctx
        n = len(msgs)
        if n == 0 or len(pubkeys) != 48 * n or len(signatures) != 96 * n:
            return False
        (px, py), p_inf, p_ok = self.codec.g1_decompress(pubkeys, self.device)
        (sx, sy), s_inf, s_ok = self.codec.g2_decompress(signatures, self.device)
        if not (p_ok.all() and s_ok.all()) or p_inf.any() or s_inf.any():
            return False
        seed = secure_blinding or os.urandom(32)
        blinds = [(int.from_bytes(sha256(seed + i.to_bytes(8, "big") + b"blind"), "big")
                   % (1 << 128)) | 1 for i in range(n)]
        k = ctx.scalars_to_limbs(blinds, self.device)
        g1, g2 = ctx.g1, ctx.g2
        (bx, by), b_inf = g1.to_affine(g1.scalar_mul(k, g1.from_affine((px, py)),
                                                     scalar_bits=128))
        agg = _tree_sum_points(g2, g2.scalar_mul(k, g2.from_affine((sx, sy)), scalar_bits=128))
        (ax, ay), a_inf = g2.to_affine(tuple(t[None] for t in agg))
        (hx, hy), _ = self._hash(msgs)
        P, Q = self._with_g1(bx, by, hx, hy, ax, ay)
        return self.pr.pairing_check(P, Q, skip_mask=torch.cat([b_inf, a_inf]))


def _tree_sum_points(group, P):
    """Log-depth sum of an (n, ...) stack of Jacobian points."""
    n = P[0].shape[0]
    while n > 1:
        h = n // 2
        red = group.add(tuple(t[:h] for t in P), tuple(t[h:2 * h] for t in P))
        if n % 2:
            red = tuple(torch.cat([r, t[2 * h:]]) for r, t in zip(red, P))
        P = red
        n = h + n % 2
    return tuple(t[0] for t in P)


@functools.lru_cache(maxsize=None)
def _bls_on(device: torch.device) -> BLSSignatures:
    return BLSSignatures(device)


def get_bls(device="cuda") -> BLSSignatures:
    """The signature context on `device` (default the card; raises without one)."""
    return _bls_on(resolve_device(device))


def derive_pubkeys(secret_keys, device="cuda") -> bytes:
    return get_bls(device).derive_pubkeys(secret_keys)


def sign(secret_keys, msgs, device="cuda"):
    return get_bls(device).sign(secret_keys, msgs)


def verify(pubkeys: bytes, msgs, signatures: bytes, device="cuda"):
    return get_bls(device).verify(pubkeys, msgs, signatures)


def aggregate_signatures(signatures: bytes, device="cuda"):
    return get_bls(device).aggregate_signatures(signatures)


def fast_aggregate_verify(pubkeys: bytes, msg: bytes, signature: bytes, device="cuda") -> bool:
    return get_bls(device).fast_aggregate_verify(pubkeys, msg, signature)


def aggregate_verify(pubkeys: bytes, msgs, signature: bytes, device="cuda") -> bool:
    return get_bls(device).aggregate_verify(pubkeys, msgs, signature)


def batch_verify(pubkeys: bytes, msgs, signatures: bytes, secure_blinding: bytes = None,
                 device="cuda") -> bool:
    return get_bls(device).batch_verify(pubkeys, msgs, signatures, secure_blinding)
