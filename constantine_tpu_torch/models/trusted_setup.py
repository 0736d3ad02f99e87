"""Ethereum KZG trusted setup loading (EIP-4844, ckzg text format).

Counterpart of ``constantine_tpu/models/trusted_setup.py`` for what
EIP-4844 needs: the 4096 Lagrange G1 points, decompressed on the host with
python ints and permuted to bit-reversed (brp) order, and the verifier's
monomial G2 points [1]G2 and [tau]G2 (the first two of the file's 65 G2
points), decompressed on the host and checked with [r]Q == infinity. The
setup file is the one shipped with the JAX package, read by path.
"""

from __future__ import annotations

import os

from ..device import resolve_device
from ..named.precompute import get_curve
from ..ops.ntt import bit_reversal_perm
from ..utils.serialization import g1_decompress_host, g2_decompress_host

FIELD_ELEMENTS_PER_BLOB = 4096
LOG_BLOB = 12

DEFAULT_SETUP = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "constantine_tpu", "data",
    "trusted_setup_ethereum_kzg4844.dat"))


def read_lagrange_g1(path: str = DEFAULT_SETUP):
    """The setup's Lagrange G1 points in file (natural) order, as python-int
    affine pairs. Raises ValueError on a malformed file or point."""
    with open(path) as f:
        tokens = f.read().split()
    n_g1 = int(tokens[0])
    if n_g1 != FIELD_ELEMENTS_PER_BLOB:
        raise ValueError(f"unexpected setup size {n_g1}")
    points, inf, valid = g1_decompress_host(bytes.fromhex("".join(tokens[2:2 + n_g1])))
    if not valid.all() or inf.any():
        raise ValueError("invalid G1 Lagrange setup point")
    return points


def read_g2_monomial(path: str = DEFAULT_SETUP):
    """[1]G2 and [tau]G2, the setup's first two monomial G2 points, as
    python-int affine pairs of Fp2 values. Raises ValueError on a malformed
    file or point."""
    with open(path) as f:
        tokens = f.read().split()
    n_g1, n_g2 = int(tokens[0]), int(tokens[1])
    if n_g2 < 2:
        raise ValueError(f"the setup has {n_g2} G2 points")
    points, inf, valid = g2_decompress_host(bytes.fromhex("".join(tokens[2 + n_g1:4 + n_g1])))
    if not valid.all() or inf.any():
        raise ValueError("invalid G2 monomial setup point")
    return points


class KZGSettings:
    """The setup on `device`: Lagrange G1 points in brp order as Montgomery
    affine (x, y) tensors (4096, 12), and g2_monomial, [1]G2 and [tau]G2 as
    Montgomery affine (x, y) tensors (2, 2, 12)."""

    def __init__(self, path: str = DEFAULT_SETUP, device="cuda"):
        self.device = resolve_device(device)
        self.ctx = get_curve("BLS12_381")
        pts = read_lagrange_g1(path)
        brp = bit_reversal_perm(len(pts))
        fp = self.ctx.fp
        self.g1_lagrange_brp = (fp.encode([pts[i][0] for i in brp], self.device),
                                fp.encode([pts[i][1] for i in brp], self.device))
        g2 = read_g2_monomial(path)
        self.g2_monomial = tuple(
            fp.encode([c for q in g2 for c in q[k]], self.device).reshape(2, 2, fp.NL)
            for k in (0, 1))
