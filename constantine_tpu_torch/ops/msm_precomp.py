"""Precomputed fixed-base MSM (one shifted affine copy per window).

Counterpart of ``constantine_tpu/ops/msm_precomp.py`` (``PrecomputedMSM``).
For fixed bases P_i, store [2^(c*j)] P_i for every window j, so sum_i k_i
P_i = sum_{i,j} d_ij [2^(c*j)] P_i is ONE bucket accumulation over W*N
points with a single effective window: no window combine. ``batch`` runs B
such MSMs in one pipeline, one digit row each.
"""

from __future__ import annotations

import torch

from .msm import _signed_digits, msm
from .msm_gpu import msm_gpu


def best_precomp_window(n: int, bits: int = 255) -> int:
    """Pick c to balance stream length N*ceil(bits/c) against 2^(c-1)
    buckets."""
    best, best_cost = 8, float("inf")
    for c in range(6, 17):
        W = -(-bits // c) + 1
        cost = n * W + (1 << (c - 1)) * 4
        if cost < best_cost:
            best, best_cost = c, cost
    return best


class PrecomputedMSM:
    """Fixed-base MSM context: build once per base set, reuse per call.

    group: ops.ec.ECGroup; points_aff: (x, y) (N, NL) affine Montgomery
    coordinates on the device the MSM will run on.
    """

    def __init__(self, group, points_aff, c: int = None, scalar_bits: int = 255):
        self.group = group
        self.F = group.F
        px, py = points_aff
        self.N = px.shape[0]
        self.bits = scalar_bits
        self.c = c or best_precomp_window(self.N, scalar_bits)
        # +1 window: the signed-digit recoding carries out of the top window
        self.W = -(-scalar_bits // self.c) + 1
        self._tables = self._precompute((px, py))

    def _precompute(self, pts):
        """[2^(c*j)] P_i for j in 0..W-1, affine, (W*N, NL) per coordinate.

        Layer j+1 is layer j doubled c times (one K3 double launch on the
        card), kept in Jacobian form; ONE batched inversion then brings all
        W-1 layers back to affine. The reference inverts once per layer
        instead; the affine tables are the same canonical values either way.
        """
        g = self.group
        cur = g.from_affine(pts)
        layers = []
        for _ in range(self.W - 1):
            cur = g.double_k(cur, self.c)
            layers.append(cur)
        (x, y), _inf = g.to_affine(tuple(torch.cat([lay[i] for lay in layers])
                                         for i in range(3)))
        return (torch.cat([pts[0], x]), torch.cat([pts[1], y]))

    def __call__(self, scalars):
        """MSM over the fixed bases. scalars: (N, NL_r) canonical limbs on
        the tables' device. Returns a Jacobian point (each coordinate (NL,))."""
        digits = _signed_digits(scalars, self.c, self.W)       # (W, N)
        flat = digits.reshape(1, -1)                           # 1 window, W*N
        return msm(self.group, self._tables, None, c=self.c, digits=flat)

    def batch(self, scalars):
        """B independent MSMs over the fixed bases in ONE pipeline.

        scalars: (B, N, NL_r) canonical limbs -> Jacobian points, each
        coordinate (B, NL). The B digit rows ride the pipeline's window axis
        with combine=False: the per-row sums are the results.
        """
        B, N, NLr = scalars.shape
        digits = _signed_digits(scalars.reshape(B * N, NLr), self.c, self.W)   # (W, B*N)
        rows = digits.reshape(self.W, B, N).transpose(0, 1).reshape(B, self.W * N)
        return msm_gpu(self.group, self._tables, None, c=self.c, digits=rows, combine=False)
