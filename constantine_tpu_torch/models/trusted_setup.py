"""Ethereum KZG trusted setup loading (EIP-4844/EIP-7594, ckzg text format).

Counterpart of ``constantine_tpu/models/trusted_setup.py``. The file holds
2 + 4096 + 65 + 4096 tokens: the two counts, the 4096 Lagrange G1 points
(natural order), the 65 monomial G2 points [tau^i]G2 and the 4096 monomial
G1 points [tau^i]G1. Everything is decompressed on the host with python
ints: the Lagrange points permuted to bit-reversed (brp) order, the
monomial G1 points (PeerDAS's FK20 and cell verification) on first use,
and the 65 G2 points with [r]Q == infinity checked for the three the
verifiers use ([1]G2, [tau]G2, [tau^64]G2). The setup file is the one
shipped with the JAX package, read by path.
"""

from __future__ import annotations

import functools
import os

import torch

from ..device import resolve_device
from ..named.precompute import get_curve
from ..ops.ntt import bit_reversal_perm
from ..utils.serialization import g1_decompress_host, g2_decompress_host

FIELD_ELEMENTS_PER_BLOB = 4096
LOG_BLOB = 12

DEFAULT_SETUP = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "constantine_tpu", "data",
    "trusted_setup_ethereum_kzg4844.dat"))


G2_CHECKED = (0, 1, 64)          # the G2 points a verifier pairs with


def _tokens(path: str):
    with open(path) as f:
        tokens = f.read().split()
    n_g1, n_g2 = int(tokens[0]), int(tokens[1])
    if n_g1 != FIELD_ELEMENTS_PER_BLOB:
        raise ValueError(f"unexpected setup size {n_g1}")
    if len(tokens) != 2 + 2 * n_g1 + n_g2:
        raise ValueError(f"setup holds {len(tokens)} tokens for {n_g1} G1 and {n_g2} G2 points")
    return tokens, n_g1, n_g2


def _read_g1(hex_tokens, what: str):
    points, inf, valid = g1_decompress_host(bytes.fromhex("".join(hex_tokens)))
    if not valid.all() or inf.any():
        raise ValueError(f"invalid G1 {what} setup point")
    return points


def read_lagrange_g1(path: str = DEFAULT_SETUP):
    """The setup's Lagrange G1 points in file (natural) order, as python-int
    affine pairs. Raises ValueError on a malformed file or point."""
    tokens, n_g1, _ = _tokens(path)
    return _read_g1(tokens[2:2 + n_g1], "Lagrange")


def read_monomial_g1(path: str = DEFAULT_SETUP):
    """[tau^i]G1 for i < 4096, the file's last section, as python-int affine
    pairs. Raises ValueError on a malformed file or point."""
    tokens, n_g1, n_g2 = _tokens(path)
    return _read_g1(tokens[2 + n_g1 + n_g2:], "monomial")


def read_g2_monomial(path: str = DEFAULT_SETUP):
    """The setup's 65 monomial G2 points [tau^i]G2 as python-int affine pairs
    of Fp2 values, on the twist, with the subgroup checked for the indices
    in G2_CHECKED. Raises ValueError on a malformed file or point."""
    tokens, n_g1, n_g2 = _tokens(path)
    if n_g2 <= max(G2_CHECKED):
        raise ValueError(f"the setup has {n_g2} G2 points")
    data = bytes.fromhex("".join(tokens[2 + n_g1:2 + n_g1 + n_g2]))
    points, inf, valid = g2_decompress_host(data, subgroup_check=False)
    _, _, in_g2 = g2_decompress_host(b"".join(data[96 * i:96 * (i + 1)] for i in G2_CHECKED))
    if not valid.all() or inf.any() or not in_g2.all():
        raise ValueError("invalid G2 monomial setup point")
    return points


class KZGSettings:
    """The setup on `device`, Montgomery affine (x, y) tensors:
    g1_lagrange_brp (4096, 12) in brp order; g2_monomial (65, 2, 12) each,
    [tau^i]G2; g1_monomial (4096, 12) each, [tau^i]G1, read on first use."""

    def __init__(self, path: str = DEFAULT_SETUP, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        self.ctx = get_curve("BLS12_381")
        pts = read_lagrange_g1(path)
        brp = bit_reversal_perm(len(pts))
        fp = self.ctx.fp
        self.g1_lagrange_brp = (fp.encode([pts[i][0] for i in brp], self.device),
                                fp.encode([pts[i][1] for i in brp], self.device))
        g2 = read_g2_monomial(path)
        self.g2_monomial = tuple(
            fp.encode([c for q in g2 for c in q[k]], self.device).reshape(len(g2), 2, fp.NL)
            for k in (0, 1))

    @functools.cached_property
    def g1_monomial(self):
        pts = read_monomial_g1(self.path)
        fp = self.ctx.fp
        return (fp.encode([q[0] for q in pts], self.device),
                fp.encode([q[1] for q in pts], self.device))


def get_settings(device="cuda") -> KZGSettings:
    """The process-wide setup on a device (the default file)."""
    return _settings_on(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _settings_on(device: torch.device) -> KZGSettings:
    return KZGSettings(device=device)
